"""Mask R-CNN's host side and driver in podtpu_torch against podtpu (CPU).

* ``infer/masks.py``: every function against the JAX package's, exactly,
  on seeded inputs;
* COCO ``segm`` stats on bitmaps and on region masks, to 1e-9;
* one ``train(with_mask=True)`` epoch of both packages at
  ``tests/conftest.py::tiny_config`` sizes on ten synthetic polygon JPEGs
  (8 train, 2 test images), fine-tuned from one model directory the port
  wrote, the port fed the JAX step keys' draws and run in a spawned
  process beside the JAX run: every step's batch and lr equal, the epoch's
  loss to 1e-4 relative, its parameters (the mask head's too) to 1e-5, its
  bbox and segm stats to 1e-3;
* the JAX run's model directory, its mask logits scaled by 50 (bias 0)
  so that few mask values lie near the 0.5 threshold, in
  ``evaluate_model`` (bbox and segm stats to 1e-3), ``infer`` at threshold
  0 (the same annotations: boxes to 1e-3 px, scores to 1e-4, polygons
  vertex for vertex to 1e-3 px, where a mask is traced on the same grid)
  and the port's ``DetectionServer`` (its polygon entries are
  ``infer``'s);
* ``train-object-detector --with-mask`` and ``infer-object-detector``
  through the fake CVAT server, the port alone: a mask model directory
  and polygon shapes uploaded.

One JAX eval step compile serves the file's JAX entry points.
"""
import copy
import dataclasses
import multiprocessing
import os
import shutil
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

import jax

from podtpu.data.annotation import PolygonAnnotation as JaxPolygon
from podtpu.data.annotation import RectangleAnnotation as JaxRect
from podtpu.infer import inference as jax_inference
from podtpu.infer import masks as jax_masks
from podtpu.train import checkpoints as jax_ckpt
from podtpu.train import coco_metrics as jax_coco
from podtpu.train import step as jax_step
from podtpu.train import train as jax_train
from podtpu_torch.core.config import config_from_dict
from podtpu_torch.data.annotation import (PolygonAnnotation,
                                          RectangleAnnotation)
from podtpu_torch.infer import inference, masks
from podtpu_torch.models.detector import init_parameters, make_detector
from podtpu_torch.models.weights import state_dict_from_flax
from podtpu_torch.shared import msgpack
from podtpu_torch.train import checkpoints, coco_metrics
from podtpu_torch.train import train as port_train
from tests.conftest import tiny_config
from tests.synthetic import make_project
from tests.test_torch_driver import draws_from_jax_keys, record
from tests.test_torch_mask import (TORCH_THREADS, port_project,
                                   torch_threads)  # noqa: F401

SEED = 0
KW = dict(labels=["particle"], batch_size=2, max_epochs=1, alrs_epochs=2,
          alrs_startup_factor=1, seed=SEED, num_workers=2, with_mask=True)
SHARPEN = 50.0


@pytest.fixture(autouse=True, scope="module")
def one_jax_eval_step():
    """One jitted JAX eval step per model configuration (each fresh
    ``jax.jit`` would compile it again)."""
    steps = {}

    def make_eval_step(model):
        if model.cfg not in steps:
            steps[model.cfg] = jax_step.make_eval_step(model)
        return steps[model.cfg]

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_inference, "make_eval_step", make_eval_step)
    mp.setattr(jax_train, "make_eval_step", make_eval_step)
    yield
    mp.undo()


# -- infer/masks.py -----------------------------------------------------------

def blobs(rng, h, w, n=3):
    """A float mask with ``n`` random blobs, one of them L-shaped."""
    yy, xx = np.mgrid[0:h, 0:w]
    m = np.zeros((h, w), np.float32)
    for _ in range(n):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(1.5, h / 3)
        m = np.maximum(m, np.clip(1.2 - np.hypot(yy - cy, xx - cx) / r, 0, 1))
    m[h // 2:, 1:3] = 1.0
    m[h - 3:h - 1, 1:w // 2] = 1.0
    return m


def test_paste_functions_exact():
    rng = np.random.default_rng(0)
    for _ in range(6):
        m = rng.uniform(0, 1, (28, 28)).astype(np.float32)
        x0, y0 = rng.uniform(-10, 60, 2)
        box = np.array([x0, y0, x0 + rng.uniform(0.3, 50),
                        y0 + rng.uniform(0.3, 50)], np.float32)
        for fn in ("paste_mask", "paste_region_mask"):
            got = getattr(masks, fn)(m, box, 64, 80)
            want = getattr(jax_masks, fn)(m, box, 64, 80)
            if fn == "paste_mask":
                np.testing.assert_array_equal(got, want)
            else:
                assert (got.x0, got.y0, got.area) == (want.x0, want.y0,
                                                      want.area)
                np.testing.assert_array_equal(got.bitmap, want.bitmap)
    ms = rng.uniform(0, 1, (4, 28, 28)).astype(np.float32)
    bs = np.array([[1, 2, 30, 40], [5, 5, 6, 6], [40, 40, 30, 50],
                   [-5, -5, 70, 90]], np.float32)
    np.testing.assert_array_equal(masks.paste_masks(ms, bs, 64, 80),
                                  jax_masks.paste_masks(ms, bs, 64, 80))
    assert masks.paste_masks(ms[:0], bs[:0], 8, 8).shape == (0, 8, 8)
    got = masks.paste_region_masks(ms, bs, 64, 80)
    want = jax_masks.paste_region_masks(ms, bs, 64, 80)
    assert [(r.x0, r.y0, r.area) for r in got] == \
        [(r.x0, r.y0, r.area) for r in want]
    # IoUs: region windows and dense bitmaps.
    np.testing.assert_array_equal(
        masks.region_mask_iou(got, got[::-1]),
        jax_masks.region_mask_iou(want, want[::-1]))
    assert got[0].intersection(got[3]) == want[0].intersection(want[3])
    dense = masks.paste_masks(ms, bs, 64, 80) > 0.5
    np.testing.assert_array_equal(masks.mask_iou(dense, dense[1:]),
                                  jax_masks.mask_iou(dense, dense[1:]))
    assert masks.mask_iou(dense[:0], dense).shape == (0, 4)


def test_rasterize_region_exact():
    shapes = [((10.5, 30.2, 40.0, 12.0), (5.0, 8.7, 30.1, 35.2)),
              ((-5.0, 20.0, 90.0), (-3.0, 70.0, 10.0)),
              ((1.0, 2.0), (1.0, 2.0))]
    for xs, ys in shapes:
        got = masks.rasterize_region(
            PolygonAnnotation(list(xs), list(ys), "a"), 60, 80)
        want = jax_masks.rasterize_region(JaxPolygon(list(xs), list(ys), "a"),
                                          60, 80)
        assert (got.x0, got.y0) == (want.x0, want.y0)
        np.testing.assert_array_equal(got.bitmap, want.bitmap)
    got = masks.rasterize_region(RectangleAnnotation(3.4, 5.5, 20, 10, "a"),
                                 60, 80)
    want = jax_masks.rasterize_region(JaxRect(3.4, 5.5, 20, 10, "a"), 60, 80)
    assert (got.x0, got.y0, got.area) == (want.x0, want.y0, want.area)


def test_polygon_tracing_exact():
    rng = np.random.default_rng(1)
    for h, w in ((20, 20), (33, 17), (64, 48)):
        m = blobs(rng, h, w)
        got = masks.mask_to_polygons(m)
        want = jax_masks.mask_to_polygons(m)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        grid = m > 0.5
        start = tuple(int(v) for v in np.argwhere(grid)[0])
        np.testing.assert_array_equal(masks._trace_boundary(grid, start),
                                      jax_masks._trace_boundary(grid, start))
        got_l, want_l = (np.zeros(grid.shape, np.int32) for _ in range(2))
        assert masks._flood(grid, got_l, start, 3) == \
            jax_masks._flood(grid, want_l, start, 3)
        np.testing.assert_array_equal(got_l, want_l)
    assert masks.mask_to_polygons(np.zeros((5, 5))) == []


# -- COCO segm ----------------------------------------------------------------

def segm_images(rng, n=6, h=48, w=64):
    """Per image: gt and detection boxes, labels, scores and masks on one
    grid (dense) and as region masks."""
    out = []
    for _ in range(n):
        g = int(rng.integers(1, 5))
        d = int(rng.integers(0, 7))
        xy = rng.uniform(0, 40, (g + d, 2))
        wh = rng.uniform(3, 30, (g + d, 2))
        boxes = np.concatenate([xy, xy + wh], 1)
        boxes[g:] = boxes[rng.integers(0, g, d)] + rng.normal(0, 3, (d, 4))
        dense = np.stack([masks.paste_mask(
            rng.uniform(0, 1, (8, 8)).astype(np.float32) + 0.3, b, h, w)
            > 0.5 for b in boxes]) if len(boxes) else np.zeros((0, h, w))
        labels = rng.integers(1, 3, g + d)
        out.append(dict(gt_boxes=boxes[:g], gt_labels=labels[:g],
                        dt_boxes=boxes[g:], dt_labels=labels[g:],
                        dt_scores=rng.uniform(0, 1, d),
                        gt_masks=dense[:g], dt_masks=dense[g:]))
    return out


@pytest.mark.parametrize("form", ["bitmaps", "region_masks"])
def test_coco_segm_stats(form):
    images = segm_images(np.random.default_rng(2))
    got_ev = coco_metrics.COCOEvaluator(num_classes=2, iou_type="segm")
    want_ev = jax_coco.COCOEvaluator(num_classes=2, iou_type="segm")
    for im in images:
        kw = dict(im, area_scale=2.5)
        if form == "region_masks":
            for k in ("gt_masks", "dt_masks"):
                kw[k] = [masks.RegionMask(0, 0, m) for m in im[k]]
        got_ev.update(**kw)
        if form == "region_masks":
            for k in ("gt_masks", "dt_masks"):
                kw[k] = [jax_masks.RegionMask(0, 0, m) for m in im[k]]
        want_ev.update(**kw)
    got, want = got_ev.summarize(), want_ev.summarize()
    assert max(got) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    # Keypoints are ported: the evaluator takes them, and asks for them.
    kp_ev = coco_metrics.COCOEvaluator(num_classes=2, iou_type="keypoints")
    with pytest.raises(ValueError, match="gt_keypoints"):
        kp_ev.update(**images[0])


# -- one train(with_mask=True) epoch ------------------------------------------

def port_run(root, project, cfg, pretrained):
    """The port's recorded one-epoch mask run, in a spawned process."""
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(TORCH_THREADS)
    rec = {k: [] for k in ("losses", "stats", "steps", "params")}
    mp = pytest.MonkeyPatch()
    try:
        record(mp, rec, port_train, checkpoints, jax_side=False)
        port_dir = port_train.train(project, output_dir=root, name="port",
                                    config=cfg, pretrained=pretrained,
                                    device="cpu",
                                    draws=draws_from_jax_keys(cfg), **KW)
    finally:
        mp.undo()
    # Resumed with its budget spent, the run trains no further epoch and
    # writes its model directory from checkpoint.pt.
    resumed = port_train.train(project, output_dir=root, name="port",
                               config=cfg, pretrained=pretrained,
                               resume=True, device="cpu",
                               **dict(KW, with_mask=False))
    return dict(port_dir=port_dir, port=rec,
                resumed=checkpoints.load_model(resumed)[:3])


def sharpened(model_dir, out_dir):
    """A copy of ``model_dir`` whose mask logits weigh ``SHARPEN`` times as
    much, without their bias: mask values then lie far from the 0.5
    threshold on both sides (the barely trained head's sit near it, below
    the threshold)."""
    os.makedirs(out_dir)
    for name in ("config.json", "labels.txt", "model.msgpack"):
        shutil.copy(os.path.join(model_dir, name), out_dir)
    path = os.path.join(out_dir, "model.msgpack")
    with open(path, "rb") as fp:
        tree = msgpack.unpackb(fp.read())
    logits = tree["params"]["mask_head"]["logits"]
    logits["kernel"] = np.asarray(logits["kernel"]) * SHARPEN
    logits["bias"] = np.zeros_like(np.asarray(logits["bias"]))
    with open(path, "wb") as fp:
        fp.write(msgpack.packb(tree))
    return out_dir


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_mask_driver")
    jcfg = tiny_config()
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    project = make_project(str(root / "images"), num_images=10,
                           polygons=True)
    pretrained = str(root / "pretrained")
    model = make_detector(dataclasses.replace(cfg.model, num_classes=2,
                                              with_mask=True))
    init_parameters(model, torch.Generator().manual_seed(7))
    checkpoints.save_model(pretrained, model, model.cfg, ["particle"])
    jax_rec = {k: [] for k in ("losses", "stats", "steps", "params")}
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(1, mp_context=ctx) as pool:
        port = pool.submit(port_run, str(root), port_project(project), cfg,
                           pretrained)
        mp = pytest.MonkeyPatch()
        try:
            record(mp, jax_rec, jax_train, jax_ckpt, jax_side=True)
            jax_dir = jax_train.train(project, output_dir=str(root),
                                      name="jax", config=jcfg,
                                      pretrained=pretrained, **KW)
        finally:
            mp.undo()
        out = port.result(timeout=600)
    yield dict(out, root=root, project=project, jax_dir=jax_dir, jax=jax_rec,
               sharp=sharpened(jax_dir, str(root / "sharp")))
    shutil.rmtree(root, ignore_errors=True)


def read_results(model_dir, name="results.txt"):
    with open(os.path.join(model_dir, name)) as fp:
        return [float(line.rsplit("=", 1)[1]) for line in fp]


class TestTrainEpoch:
    def test_steps_losses_parameters(self, runs):
        got, want = runs["port"], runs["jax"]
        assert len(got["steps"]) == len(want["steps"]) == 4
        for (gi, gw, glr), (wi, ww, wlr) in zip(got["steps"], want["steps"]):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gw, ww.astype(np.float32))
            assert glr == wlr
        assert [e for e, _ in got["losses"]] == [0]
        np.testing.assert_allclose(got["losses"][0][1], want["losses"][0][1],
                                   rtol=1e-4)
        gp, wp = got["params"][0], want["params"][0]
        assert set(gp) == set(wp) and sum("mask_" in k for k in wp) == 12
        for k in wp:
            np.testing.assert_allclose(gp[k], wp[k], rtol=0, atol=1e-5,
                                       err_msg=k)

    def test_resume_restores_the_mask_head(self, runs):
        """``checkpoint.pt`` holds the mask head and its config: a resumed
        call (without ``with_mask``) rebuilds the mask model and writes the
        epoch's parameters back, exactly."""
        params, frozen, mcfg = runs["resumed"]
        assert mcfg.with_mask and "mask_head" in params
        got = state_dict_from_flax(params, frozen)
        want = runs["port"]["params"][0]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def test_bbox_and_segm_results(self, runs):
        for name in ("results.txt", "results_segm.txt"):
            got = read_results(runs["port_dir"], name)
            want = read_results(runs["jax_dir"], name)
            assert len(got) == 12
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        # The port's mask model directory loads in the JAX package.
        params, frozen, jcfg, _ = jax_ckpt.load_model(runs["port_dir"])
        assert jcfg.with_mask and "mask_head" in params
        assert all(np.isfinite(v).all() for v in state_dict_from_flax(
            params, frozen).values())


def test_evaluate_model(runs):
    test = copy.deepcopy(runs["project"])
    out = runs["root"] / "eval"
    want = jax_train.evaluate_model(test, runs["sharp"], batch_size=2,
                                    num_workers=2, output_dir=str(out / "j"))
    got = port_train.evaluate_model(port_project(test), runs["sharp"],
                                    batch_size=2, num_workers=2,
                                    output_dir=str(out / "p"), device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    segm = read_results(out / "p", "results_segm.txt")
    np.testing.assert_allclose(segm,
                               read_results(out / "j", "results_segm.txt"),
                               rtol=0, atol=1e-3)
    assert len(segm) == 12 and any(v != -1 for v in segm)


def annotations(project):
    """{image id: [(kind, label, bounds, score, xs, ys), ...]}."""
    return {k: [(type(b).__name__, b.label, b.bounds, b.score,
                 getattr(b, "xs", None), getattr(b, "ys", None))
                for b in im.boxes] for k, im in project.image_dict.items()}


@pytest.fixture(scope="module")
def inferred(runs):
    jp = copy.deepcopy(runs["project"])
    for im in jp.image_dict.values():
        im.boxes = []
    port = port_project(jp)
    want = jax_inference.infer(jp, runs["sharp"], threshold=0.0,
                               batch_size=2, num_workers=2)
    got = inference.infer(port, runs["sharp"], threshold=0.0, batch_size=2,
                          num_workers=2, device="cpu")
    return got, want


def test_infer_polygons(inferred):
    got, want = (annotations(p) for p in inferred)
    assert set(got) == set(want)
    polygons = 0
    for k in want:
        assert [a[:2] for a in got[k]] == [a[:2] for a in want[k]], k
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(g[3], w[3], rtol=0, atol=1e-4)
            if w[0] == "PolygonAnnotation":
                polygons += 1
                assert len(g[4]) == len(w[4]), k
                np.testing.assert_allclose(g[4], w[4], rtol=0, atol=1e-3)
                np.testing.assert_allclose(g[5], w[5], rtol=0, atol=1e-3)
            else:
                np.testing.assert_allclose(g[2], w[2], rtol=0, atol=1e-3)
    # After one epoch the model keeps 5 detections over the 10 images, each
    # with a mask.
    assert polygons >= 3


def test_server_polygons(runs, inferred):
    """The server's entries for an image are ``infer``'s annotations: the
    same boxes and scores, and each polygon's outline."""
    from podtpu_torch.data import imageio
    from podtpu_torch.infer.server import DetectionServer

    got, _ = inferred
    server = DetectionServer(runs["sharp"], batch_size=2, device="cpu")
    try:
        checked = 0
        for meta in list(got.image_dict.values())[:3]:
            out = server.detect_array(imageio.read_rgb(meta.full_path), 0.0)
            dets = out["detections"]
            assert len(dets) == len(meta.boxes)
            for d, ann in zip(dets, meta.boxes):
                assert d["label"] == ann.label
                np.testing.assert_allclose(d["score"], ann.score, rtol=0,
                                           atol=1e-6)
                if hasattr(ann, "xs"):
                    np.testing.assert_allclose(
                        d["polygon"], np.stack([ann.xs, ann.ys], 1),
                        rtol=0, atol=1e-3)
                    checked += 1
                else:
                    assert "polygon" not in d
        assert checked > 0
    finally:
        server.close()


# -- the CLI -------------------------------------------------------------------

def test_cli_train_with_mask_and_polygon_upload(tmp_path, monkeypatch):
    from PIL import Image

    from podtpu_torch import cli as port_cli
    from podtpu_torch.core import config as port_config
    from tests.fake_cvat import FakeCvatServer, FakeCvatState

    tiny = config_from_dict(dataclasses.asdict(tiny_config()))
    monkeypatch.setattr(port_config, "Config", lambda: tiny)
    project = make_project(str(tmp_path / "src"), num_images=6,
                           polygons=True, seed=4)
    raw = tmp_path / "cvat" / "7" / "raw"
    raw.mkdir(parents=True)
    frames, shapes = [], []
    for i, meta in enumerate(project.image_dict.values()):
        name = f"frame_{i:02d}.png"
        Image.open(meta.full_path).save(raw / name)
        frames.append(name)
        for b in meta.boxes:
            shapes.append({"id": len(shapes) + 1, "type": "polygon",
                           "frame": i, "label_id": 10, "outside": False,
                           "points": [v for xy in zip(b.xs, b.ys)
                                      for v in xy]})
    labels = [{"id": 10, "name": "particle", "color": "#ff0000"}]
    state = FakeCvatState()
    state.add_task(5, "polygons", labels, frames, shapes=shapes)
    state.add_task(6, "unlabelled", labels, frames)
    out = tmp_path / "models"
    with FakeCvatServer(state) as srv:
        common = ["--server", srv.url, "--image-root", str(tmp_path / "cvat")]
        port_cli.main(["train-object-detector", "--tasks", "5", *common,
                       "--image-size", "128", "--max-epochs", "1",
                       "--alrs-epochs", "2", "--with-mask", "-o", str(out),
                       "-m", "mask_model"], device="cpu")
        model_dir = out / "mask_model"
        _, _, mcfg, names = checkpoints.load_model(str(model_dir))
        assert mcfg.with_mask and names == ["particle"]
        assert len(read_results(model_dir, "results_segm.txt")) == 12
        sharpened(str(model_dir), str(out / "sharp"))
        before = len(state.patches)
        port_cli.main(["infer-object-detector", "--tasks", "6", *common,
                       "--model-dir", str(out), "--model", "sharp",
                       "--threshold", "0.0"], device="cpu")
    shutil.rmtree(out)  # two model directories and a checkpoint: 0.7 GB
    uploads = [p for p in state.patches[before:]
               if "annotations?action=create" in p["path"]]
    assert len(uploads) == 1
    sent = uploads[0]["body"]["shapes"]
    kinds = {s["type"] for s in sent}
    assert "polygon" in kinds and kinds <= {"polygon", "rectangle"}
    for s in sent:
        assert s["label_id"] == 10
        if s["type"] == "polygon":
            assert len(s["points"]) >= 6 and len(s["points"]) % 2 == 0
