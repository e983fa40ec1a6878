"""Tiled scan inference of podtpu_torch against podtpu's (CPU).

``tile_origins``, ``greedy_nms`` and ``cross_tile_nms`` are the same numpy
code in both packages and are held equal: origins, keep indices and the
merged lists, on random boxes and on a dense scan of thousands.

``infer_tiled`` runs both packages on model directories of seeded weights
(the port's ``init_parameters``, flax's initialisers; a JAX
``init_variables`` would cost a compile a model) that the JAX package
wrote, at ``tests/conftest.py::tiny_config`` sizes (128 canvas, float32,
two labels): Faster R-CNN, Mask R-CNN with its mask
logits sharpened (times 50, bias 0, so that few mask values lie near the
0.5 threshold) and RetinaNet with its class scores lifted
(``tests/test_torch_retinanet.py::lift``).  The scan, 100 x 420 with
seeded particles on a grey background, is not a multiple of the stride
and is lower than a tile, so every tile has a zero-padded edge and the
centre filter drops detections there.  At the 128 canvas (overlap 0.25,
stride 96) it is 5 tiles, run at batch 3 (the last batch padded with a
zero tile); at ``tile_size=192`` 3 tiles at batch 2.  Each threshold lies
in the widest gap of the JAX run's tile scores, at least 2e-4 from every
score (asserted).

Compared as detection sets (the packages' scores differ by up to 1e-4,
so near-equal scores may swap places in the sorted list): the same
count, each JAX detection matched by one of the port's with the same
label, its box to 1e-3 px and its score to 1e-4, polygons vertex for
vertex to 1e-3 px; the port's list sorted by score.  The scan as uint8,
as uint16 (normalised by 65535) and as a 16-bit grey TIFF read from its
path (decoded to the uint8 scan, so its detections equal the uint8
run's exactly); a mask model's polygons; RetinaNet once;
``spatial_devices=2`` raises naming item 20; the CLI command's JSON
against JAX's.

One JAX eval-step compile per configuration, canvas and input type, through
``make_eval_step`` patched for the file.
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

import podtpu.cli as jax_cli
from podtpu.core.config import retinanet_config as jax_retinanet_config
from podtpu.infer import inference as jax_inference
from podtpu.infer import tiled as jax_tiled
from podtpu.train import checkpoints as jax_ckpt
from podtpu.train import step as jax_step
import podtpu_torch.cli as port_cli
from podtpu_torch.core.config import model_config_from_dict
from podtpu_torch.infer import tiled
from podtpu_torch.models.detector import init_parameters, make_detector
from podtpu_torch.models.weights import flax_from_state_dict
from tests.conftest import tiny_config
from tests.synthetic import draw_particle
from tests.test_torch_mask import torch_threads  # noqa: F401
from tests.test_torch_retinanet import lift

LABELS = ["particle", "bubble"]
SHARPEN = 50.0
SCAN_HW = (100, 420)

_EVAL_STEPS = {}
_MAKE_EVAL_STEP = jax_step.make_eval_step


def cached_eval_step(model):
    """``make_eval_step`` compiled once per configuration for the file."""
    if model.cfg not in _EVAL_STEPS:
        _EVAL_STEPS[model.cfg] = _MAKE_EVAL_STEP(model)
    return _EVAL_STEPS[model.cfg]


@pytest.fixture(autouse=True, scope="module")
def one_jax_eval_step():
    """JAX's ``infer_tiled`` builds its step through ``load_inference_model``
    and, for another canvas, through ``podtpu.train.step.make_eval_step``
    looked up at the call."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_inference, "make_eval_step", cached_eval_step)
    mp.setattr(jax_step, "make_eval_step", cached_eval_step)
    yield
    mp.undo()


# -- the host functions -------------------------------------------------------

@pytest.mark.parametrize("size, tile, stride", [
    (300, 128, 96), (100, 128, 96), (128, 128, 96), (4000, 1024, 768),
    (3000, 1024, 768), (4000, 2048, 1536), (129, 128, 1)])
def test_tile_origins(size, tile, stride):
    got = tiled.tile_origins(size, tile, stride)
    assert got == jax_tiled.tile_origins(size, tile, stride)
    assert got[0] == 0 and got[-1] == max(size - tile, 0)


def random_boxes(rng, n, extent=200.0):
    xy = rng.uniform(0, extent, (n, 2))
    wh = rng.uniform(5, 40, (n, 2))
    return np.concatenate([xy, xy + wh], 1)


def test_greedy_nms_equal():
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 300):
        boxes = random_boxes(rng, n)
        scores = rng.uniform(0, 1, n)
        scores[: n // 3] = 0.5  # ties keep their order
        for thr in (0.3, 0.5, 0.7):
            got = tiled.greedy_nms(boxes, scores, thr)
            want = jax_tiled.greedy_nms(boxes, scores, thr)
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, want)
    boxes = np.tile([[0.0, 0.0, 10.0, 10.0]], (5, 1))  # identical boxes
    np.testing.assert_array_equal(tiled.greedy_nms(boxes, np.ones(5), 0.5),
                                  [0])


def as_tuples(dets):
    return [(d.box, d.score, d.label) for d in dets]


def test_cross_tile_nms_dense_scan():
    """Thousands of detections with seam duplicates in three classes: the
    same merged list, in the same order."""
    rng = np.random.default_rng(0)
    n = 2500
    boxes = random_boxes(rng, n, extent=4000.0)
    scores = np.round(rng.uniform(0.3, 1.0, n), 3)  # many equal scores
    labels = rng.integers(1, 4, n)
    port, jax_dets = [], []
    for i in range(n):
        for mod, out in ((tiled, port), (jax_tiled, jax_dets)):
            out.append(mod.TiledDetection(tuple(boxes[i]), float(scores[i]),
                                          int(labels[i])))
            if i % 2 == 0:  # seen again by the neighbouring tile
                out.append(mod.TiledDetection(tuple(boxes[i] + 1.0), 0.5,
                                              int(labels[i])))
    got = tiled.cross_tile_nms(port, 0.5)
    want = jax_tiled.cross_tile_nms(jax_dets, 0.5)
    assert as_tuples(got) == as_tuples(want)
    assert n // 2 < len(got) < len(port)
    assert tiled.cross_tile_nms([]) == []


# -- infer_tiled --------------------------------------------------------------

def make_scan(seed=0):
    """A grey uint8 scan (R = G = B) with bright particles."""
    rng = np.random.default_rng(seed)
    h, w = SCAN_HW
    img = rng.integers(20, 60, (h, w, 3)).astype(np.uint8)
    for _ in range(12):
        bw, bh = (int(v) for v in rng.integers(12, 40, 2))
        x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        draw_particle(img, x, y, bw, bh, (235, 235, 235))
    return np.repeat(img[..., :1], 3, axis=2)


def save_dir(root, name, mcfg, variables):
    path = str(root / name)
    jax_ckpt.save_model(path, variables["params"], variables["frozen"], mcfg,
                        LABELS)
    jax_ckpt.save_labels(path, LABELS)
    return path


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_tiled")
    base = dataclasses.replace(tiny_config().model, num_classes=3)
    dirs = {}
    for name, mcfg in (
            ("faster", base),
            ("mask", dataclasses.replace(base, with_mask=True)),
            ("retinanet", jax_retinanet_config(base))):
        model = make_detector(model_config_from_dict(
            dataclasses.asdict(mcfg)))
        init_parameters(model, torch.Generator().manual_seed(0))
        params, frozen = flax_from_state_dict(model.state_dict())
        variables = {"params": params, "frozen": frozen}
        if name == "mask":
            logits = variables["params"]["mask_head"]["logits"]
            logits["kernel"] = logits["kernel"] * SHARPEN
            logits["bias"] = np.zeros_like(logits["bias"])
        if name == "retinanet":
            variables = lift(variables)
        dirs[name] = save_dir(root, name, mcfg, variables)
    scan = make_scan()
    Image.fromarray(scan).save(root / "scan.png")
    gray16 = scan[..., 0].astype(np.uint16) * 257
    Image.fromarray(gray16).save(root / "scan16.tif")
    with Image.open(root / "scan16.tif") as im:
        assert im.mode == "I;16"
    yield dict(root=root, dirs=dirs, scan=scan)
    shutil.rmtree(root, ignore_errors=True)


_SCORES = {}


def tile_scores(model_dir, **kw):
    """Every detection score of JAX's tiles on the scan (the merge's input
    at threshold 0; masks are not traced), once per model and keywords."""
    key = (model_dir, tuple(sorted(kw.items())))
    if key not in _SCORES:
        seen = []
        merge = jax_tiled.cross_tile_nms

        def recording(dets, thr):
            seen.extend(d.score for d in dets)
            return merge(dets, thr)

        mp = pytest.MonkeyPatch()
        mp.setattr(jax_tiled, "cross_tile_nms", recording)
        mp.setattr(jax_inference, "_mask_to_annotation", lambda *a: None)
        try:
            jax_tiled.infer_tiled(make_scan(), model_dir, threshold=0.0,
                                  **kw)
        finally:
            mp.undo()
        _SCORES[key] = np.sort(np.asarray(seen))
    return _SCORES[key]


def threshold_in_gap(scores, lo=0.25, hi=0.75):
    """The midpoint of the widest gap between consecutive scores in the
    middle of their range, asserted at least 2e-4 from every score."""
    s = scores[int(lo * len(scores)): int(hi * len(scores)) + 1]
    k = int(np.argmax(np.diff(s)))
    thr = float((s[k] + s[k + 1]) / 2)
    assert np.abs(scores - thr).min() >= 2e-4, (thr, scores)
    return thr


def assert_same_detections(got, want):
    assert len(got) == len(want) > 0
    assert [d.score for d in got] == sorted((d.score for d in got),
                                            reverse=True)
    used = set()
    for w in want:
        hits = [i for i, g in enumerate(got) if i not in used
                and g.label == w.label
                and np.abs(np.subtract(g.box, w.box)).max() <= 1e-3]
        assert len(hits) == 1, (w, hits)
        g = got[hits[0]]
        used.add(hits[0])
        assert abs(g.score - w.score) <= 1e-4
        assert (g.polygon is None) == (w.polygon is None)
        if w.polygon is not None:
            assert g.polygon.shape == w.polygon.shape
            np.testing.assert_allclose(g.polygon, w.polygon, rtol=0,
                                       atol=1e-3)


def run_both(image, model_dir, **kw):
    want = jax_tiled.infer_tiled(image, model_dir, **kw)
    got = tiled.infer_tiled(image, model_dir, device="cpu", **kw)
    assert_same_detections(got, want)
    return got


@pytest.mark.parametrize("tile_size, batch_size", [(None, 3), (192, 2)])
def test_infer_tiled_faster(setup, tile_size, batch_size, monkeypatch):
    model_dir, scan = setup["dirs"]["faster"], setup["scan"]
    kw = dict(batch_size=batch_size, tile_size=tile_size)
    canvas = tile_size or 128
    n_tiles = len(tiled.tile_origins(SCAN_HW[1], canvas,
                                     round(canvas * 0.75)))
    assert n_tiles == (5 if tile_size is None else 3)
    assert n_tiles % batch_size  # the last batch is padded
    threshold = threshold_in_gap(tile_scores(model_dir, **kw))
    batches = []
    build = tiled.build_inference_model

    def counted(*args):
        forward, model = build(*args)
        assert model.cfg.image_size == (canvas, canvas)
        return (lambda x: batches.append(x.shape) or forward(x)), model

    monkeypatch.setattr(tiled, "build_inference_model", counted)
    got = run_both(scan, model_dir, threshold=threshold, **kw)
    assert batches == [(batch_size, canvas, canvas, 3)] * -(
        -n_tiles // batch_size)
    # Every detection's centre lies inside the scan, none on the padding.
    boxes = np.asarray([d.box for d in got])
    assert ((boxes[:, 1] + boxes[:, 3]) / 2 < SCAN_HW[0]).all()


def test_infer_tiled_input_types(setup):
    """uint8, uint16 and a 16-bit TIFF path: each against JAX's; the TIFF
    decodes to the uint8 scan, and uint16 runs in float32."""
    model_dir, scan = setup["dirs"]["faster"], setup["scan"]
    threshold = threshold_in_gap(tile_scores(model_dir, batch_size=3))
    kw = dict(threshold=threshold, batch_size=3)
    u8 = run_both(scan, model_dir, **kw)
    u16 = run_both(scan.astype(np.uint16) * 257, model_dir, **kw)
    tif = run_both(str(setup["root"] / "scan16.tif"), model_dir, **kw)
    assert as_tuples(tif) == as_tuples(u8)
    assert_same_detections(u16, u8)


def test_infer_tiled_mask_polygons(setup):
    model_dir, scan = setup["dirs"]["mask"], setup["scan"]
    threshold = threshold_in_gap(tile_scores(model_dir, batch_size=3))
    got = run_both(scan, model_dir, threshold=threshold, batch_size=3)
    polys = [d.polygon for d in got if d.polygon is not None]
    assert len(polys) >= 3
    for d in got:
        if d.polygon is not None:  # scan coordinates, about the box
            x0, y0, x1, y1 = d.box
            assert (d.polygon[:, 0] >= x0 - 1).all() \
                and (d.polygon[:, 0] <= x1 + 1).all()
            assert (d.polygon[:, 1] >= y0 - 1).all() \
                and (d.polygon[:, 1] <= y1 + 1).all()


def test_infer_tiled_one_stage(setup):
    model_dir, scan = setup["dirs"]["retinanet"], setup["scan"]
    threshold = threshold_in_gap(tile_scores(model_dir, batch_size=3))
    # A file in the model directory names the directory.
    run_both(scan, os.path.join(model_dir, "model.msgpack"),
             threshold=threshold, batch_size=3)


def test_refusals(setup, monkeypatch):
    with pytest.raises(NotImplementedError, match="item 20"):
        tiled.infer_tiled(setup["scan"], setup["dirs"]["faster"],
                          spatial_devices=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tiled.infer_tiled(setup["scan"], setup["dirs"]["faster"])


def test_cli_json(setup, tmp_path, capsys):
    """``infer-object-detector-tiled`` on the scan's PNG: the port's rows
    (box, score, label name, a mask model's polygon) against JAX's, and
    the closing count on stdout."""
    root, scan_png = setup["root"], str(setup["root"] / "scan.png")
    for name in ("faster", "mask"):
        model_dir = setup["dirs"][name]
        threshold = threshold_in_gap(tile_scores(model_dir, batch_size=3))
        argv = ["infer-object-detector-tiled", "-i", scan_png,
                "--model-dir", str(root), "--model", name, "--threshold",
                str(threshold), "--batch-size", "3"]
        result = CliRunner().invoke(jax_cli.cli,
                                    argv + ["-o", str(tmp_path / "j.json")])
        assert result.exit_code == 0, result.output
        capsys.readouterr()
        assert port_cli.main(argv + ["-o", str(tmp_path / "p.json")],
                             device="cpu") == 0
        printed = capsys.readouterr().out
        want = json.loads((tmp_path / "j.json").read_text())
        got = json.loads((tmp_path / "p.json").read_text())
        assert {r["label"] for r in got} <= set(LABELS)
        assert (name == "mask") == any("polygon" in r for r in got)

        def back(rows):
            return [tiled.TiledDetection(
                tuple(r["box"]), r["score"], LABELS.index(r["label"]) + 1,
                None if "polygon" not in r else np.asarray(r["polygon"]))
                for r in rows]

        assert_same_detections(back(got), back(want))
        assert result.output.splitlines()[-1] == f"{len(want)} detections"
        assert printed.splitlines()[-1] == f"{len(got)} detections"
