"""The port's batch inference, cropping, saved-model evaluation and
pretrained loading against the JAX package's (CPU).

One model directory, saved from the JAX package's ``init_variables`` at
``tests/conftest.py::tiny_config`` sizes (float32, two labels; no
training), serves both packages.  Its random-weight detections score 0.37
to 0.53, so threshold 0.45 keeps some boxes and drops others.  Tolerances:
the same images, labels and box counts; boxes to 1e-3 px and scores to
1e-4 (float32 convolutions sum in another order); crops equal byte for
byte; the 12 COCO stats of ``evaluate_model`` to 1e-3; pretrained tensors
equal.  Both packages decode through their native C++ decoders (the same
canvases, ``tests/test_torch_native.py``); ``infer_directory`` is also held
on their Pillow fallbacks, with both ``decode_resize_batch`` patched to
None.
"""
import copy
import dataclasses
import filecmp
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from podtpu.core import native
from podtpu.infer import crop as jax_crop
from podtpu.infer import inference as jax_inference
from podtpu.models import weights as jax_weights
from podtpu.models.detector import init_variables
from podtpu.models.detector import make_detector as jax_make_detector
from podtpu.train import checkpoints as jax_ckpt
from podtpu.train import step as jax_step
from podtpu.train import train as jax_train
from podtpu_torch.core import native as port_native
from podtpu_torch.core.config import ModelConfig
from podtpu_torch.infer import crop, inference
from podtpu_torch.models.detector import init_parameters, make_detector
from podtpu_torch.models.weights import (flax_from_state_dict,
                                         load_pretrained, state_dict_from_flax)
from podtpu_torch.train import train as port_train
from tests.conftest import tiny_config
from tests.synthetic import make_project
from tests.test_torch_data import port_project
from tests.test_torch_mask import torch_threads  # noqa: F401

LABELS = ["particle", "bubble"]
THRESHOLD = 0.45


@pytest.fixture(autouse=True, scope="module")
def one_jax_eval_step():
    """One jitted JAX eval step per model configuration: every JAX entry
    point here loads the same directory and builds the same step, and each
    fresh ``jax.jit`` would compile it again."""
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


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_infer")
    mcfg = dataclasses.replace(tiny_config().model, num_classes=3)
    variables = init_variables(jax_make_detector(mcfg),
                               jax.random.PRNGKey(0))
    model_dir = str(root / "model")
    jax_ckpt.save_model(model_dir, variables["params"], variables["frozen"],
                        mcfg, LABELS)
    jax_ckpt.save_labels(model_dir, LABELS)
    images = root / "images"
    project = make_project(str(images / "a"), num_images=5, labels=LABELS,
                           seed=1)
    nested = make_project(str(images / "b" / "c"), num_images=2,
                          labels=LABELS, seed=2)
    for im in nested.image_dict.values():
        im.frame_id += 100
        project.add_image(im)
    (images / "notes.txt").write_text("not an image")
    project.task_names = {1: "task one"}
    yield dict(root=root, model_dir=model_dir, images=images,
               project=project)
    shutil.rmtree(root, ignore_errors=True)


def annotations(project):
    """{image id: [(label, (x, y, w, h), score), ...]}."""
    return {k: [(b.label, b.bounds, b.score) for b in im.boxes]
            for k, im in project.image_dict.items()}


def assert_same_annotations(got, want):
    got, want = annotations(got), annotations(want)
    assert set(got) == set(want)
    kept = 0
    for k in want:
        assert [a[0] for a in got[k]] == [a[0] for a in want[k]], k
        for (_, gb, gs), (_, wb, ws) in zip(got[k], want[k]):
            np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-3)
            np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-4)
        kept += len(want[k])
    return kept


def test_infer(setup):
    jp = copy.deepcopy(setup["project"])
    labelled = list(jp.image_dict)[:2]
    for k in list(jp.image_dict)[2:]:
        jp.image_dict[k].boxes = []
    port, port_nv = port_project(jp), port_project(jp)
    model_file = os.path.join(setup["model_dir"], "model.msgpack")
    want = jax_inference.infer(jp, model_file, threshold=THRESHOLD,
                               batch_size=2, num_workers=2)
    got = inference.infer(port, model_file, threshold=THRESHOLD,
                          batch_size=2, num_workers=2, device="cpu")
    kept = assert_same_annotations(got, want)
    total = sum(len(im.boxes) for im in want.image_dict.values())
    assert 0 < kept == total < 16 * 5
    assert not set(labelled) & set(got.image_dict)
    # Both add the model labels to the caller's project.
    assert port.label_names == jp.label_names
    assert got.task_names == want.task_names
    # nv=True: the same detections under "_NV" labels, which the caller's
    # project gains as well.
    got_nv = inference.infer(port_nv, model_file, threshold=THRESHOLD,
                             batch_size=2, nv=True, num_workers=2,
                             device="cpu")
    for im in want.image_dict.values():
        for b in im.boxes:
            b.label += "_NV"
    assert assert_same_annotations(got_nv, want) == kept
    assert port_nv.label_names == jp.label_names + [n + "_NV" for n in LABELS]


def check_infer_directory(setup):
    want = jax_inference.infer_directory(str(setup["images"]),
                                         setup["model_dir"],
                                         threshold=THRESHOLD, batch_size=2,
                                         num_workers=2)
    got = inference.infer_directory(str(setup["images"]), setup["model_dir"],
                                    threshold=THRESHOLD, batch_size=2,
                                    num_workers=2, device="cpu")
    assert len(got.image_dict) == 7
    assert assert_same_annotations(got, want) > 0


def test_infer_directory(setup):
    assert native.available() and port_native.available()
    check_infer_directory(setup)
    with pytest.raises(ValueError, match="does not exist"):
        inference.infer_directory(str(setup["root"] / "nowhere"),
                                  setup["model_dir"], device="cpu")


def test_infer_directory_pillow_decode(setup, monkeypatch):
    for mod in (native, port_native):
        monkeypatch.setattr(mod, "decode_resize_batch", lambda *a, **k: None)
    check_infer_directory(setup)


def test_entry_points_need_a_device_without_gpu(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference.infer(port_project(setup["project"]), setup["model_dir"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference.infer_directory(str(setup["images"]), setup["model_dir"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.evaluate_model(port_project(setup["project"]),
                                  setup["model_dir"])


@pytest.mark.parametrize("layout", ["task_names", "relative_to", "plain"])
def test_crop_objects(setup, tmp_path, layout):
    jp = copy.deepcopy(setup["project"])
    kw = {}
    if layout == "relative_to":
        kw["relative_to"] = str(setup["images"])
    elif layout == "plain":
        jp.task_names = {}
    im = next(iter(jp.image_dict.values()))
    im.boxes.append(type(im.boxes[0])(-10, -10, 30, 30, "particle"))
    im.boxes.append(type(im.boxes[0])(500, 500, 30, 30, "particle"))
    n_want = jax_crop.crop_objects(jp, str(tmp_path / "jax"), **kw)
    n_got = crop.crop_objects(port_project(jp), str(tmp_path / "port"), **kw)
    assert n_got == n_want > 0
    files = sorted(str(p.relative_to(tmp_path / "jax"))
                   for p in (tmp_path / "jax").rglob("*.jpg"))
    assert files == sorted(str(p.relative_to(tmp_path / "port"))
                           for p in (tmp_path / "port").rglob("*.jpg"))
    assert len(files) == n_want
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax",
                                           tmp_path / "port", files,
                                           shallow=False)
    assert not mismatch and not errors


def test_evaluate_model(setup, tmp_path):
    want = jax_train.evaluate_model(setup["project"], setup["model_dir"],
                                    batch_size=2, num_workers=2,
                                    output_dir=str(tmp_path / "jax"))
    got = port_train.evaluate_model(port_project(setup["project"]),
                                    setup["model_dir"], batch_size=2,
                                    num_workers=2,
                                    output_dir=str(tmp_path / "port"),
                                    device="cpu")
    assert len(got) == 12
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    for name in ("labels.txt", "results.txt", "results_per_class.txt"):
        assert (tmp_path / "port" / name).exists(), name
    assert (tmp_path / "port" / "labels.txt").read_text() == \
        (tmp_path / "jax" / "labels.txt").read_text()


def test_load_pretrained_from_model_directory(setup, capsys):
    """Three labels against the directory's two: the class-sized heads keep
    their initial values, everything else is the directory's, and the
    printout counts what the JAX package counts."""
    mcfg = dataclasses.replace(tiny_config().model, num_classes=4)
    port = make_detector(ModelConfig(**dataclasses.asdict(mcfg)))
    init_parameters(port, torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    # The same initial values as flax trees for the JAX loader.
    params, frozen = flax_from_state_dict(before)
    jax_weights.load_pretrained({"params": params, "frozen": frozen},
                                setup["model_dir"])
    want_out = capsys.readouterr().out
    load_pretrained(port, setup["model_dir"])
    got_out = capsys.readouterr().out
    assert got_out.splitlines()[-1].split(" from ")[0] == \
        want_out.splitlines()[-1].split(" from ")[0]
    assert "16 skipped" not in got_out and " 4 skipped" in got_out
    params, frozen, _, _ = jax_ckpt.load_model(setup["model_dir"])
    saved = state_dict_from_flax(params, frozen)
    heads = {f"roi_heads.box_predictor.{n}.{t}" for n in ("cls_score",
                                                         "bbox_pred")
             for t in ("weight", "bias")}
    for k, v in port.state_dict().items():
        expect = before[k] if k in heads else torch.tensor(saved[k])
        assert torch.equal(v, expect), k


def test_load_pretrained_from_state_dict(tmp_path, capsys):
    cfg = ModelConfig(**dataclasses.asdict(dataclasses.replace(
        tiny_config().model, num_classes=3)))
    src = make_detector(cfg)
    init_parameters(src, torch.Generator().manual_seed(2))
    sd = src.state_dict()
    torch.save(sd, tmp_path / "plain.pth")
    wide = dict(sd)
    wide["roi_heads.box_predictor.cls_score.weight"] = torch.zeros(5, 1024)
    torch.save({"state_dict": wide}, tmp_path / "wrapped.pt")
    for name, skipped in (("plain.pth", 0), ("wrapped.pt", 1)):
        dst = make_detector(cfg)
        init_parameters(dst, torch.Generator().manual_seed(3))
        before = dst.state_dict()["roi_heads.box_predictor.cls_score.weight"
                                  ].clone()
        load_pretrained(dst, str(tmp_path / name))
        out = capsys.readouterr().out
        assert f"{len(sd) - skipped} tensors loaded, {skipped} skipped" in out
        for k, v in dst.state_dict().items():
            if skipped and k == "roi_heads.box_predictor.cls_score.weight":
                assert torch.equal(v, before)
            else:
                assert torch.equal(v, sd[k]), k
