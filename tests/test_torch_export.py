"""The port's export (``podtpu_torch/infer/export.py``) against the JAX
package's (``podtpu/infer/export.py``), on the CPU.

One Faster R-CNN model directory at ``tests/conftest.py::tiny_config``
sizes (float32, three classes, the port's seeded initialisation written by
JAX's ``save_model``) is exported for the CPU at batch 2 by both packages:
JAX's ``export_model`` once, the port's through its CLI
(``export-model --platforms cpu``).  Both artifacts replay the same
canvases: boxes to 1e-3 px, scores to 1e-4 (float32 convolutions sum in
another order), labels and validity equal, some detections valid.  Their
``export.json`` files are equal.  Then the bare artifact, the uint8 and
platform refusals, a subprocess that replays the artifact without the
port's model code, the exported server against the live one, and
``torch.library.opcheck`` of each registered operator's CPU
implementation.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from podtpu.infer import export as jax_export
from podtpu.train import checkpoints as jax_ckpt
from podtpu_torch import cli as port_cli
from podtpu_torch.infer import export
from podtpu_torch.infer.server import DetectionServer
from podtpu_torch.ops import _build
from tests.conftest import tiny_config
from tests.test_torch_mask import TORCH_THREADS, port_init_variables
from tests.test_torch_mask import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
LABELS = ["particle", "bubble"]
BATCH = 2


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_export")
    mcfg = dataclasses.replace(tiny_config().model, num_classes=3)
    variables = port_init_variables(mcfg, 0)
    model_dir = str(root / "model")
    jax_ckpt.save_model(model_dir, variables["params"], variables["frozen"],
                        mcfg, LABELS)
    jax_ckpt.save_labels(model_dir, LABELS)
    for side in ("jax", "port"):
        os.makedirs(root / side)
    jax_path = jax_export.export_model(
        model_dir, batch_size=BATCH, platforms=("cpu",),
        out_path=str(root / "jax" / jax_export.EXPORT_NAME))
    port_path = str(root / "port" / export.EXPORT_NAME)
    port_cli.main(["export-model", "--model-dir", str(root), "--model",
                   "model", "--batch-size", str(BATCH), "--platforms", "cpu",
                   "-o", port_path], device="cpu")
    images = np.random.default_rng(3).integers(
        0, 256, (BATCH,) + mcfg.image_size + (3,), dtype=np.uint8)
    yield dict(root=root, model_dir=model_dir, jax=jax_path,
               port=port_path, images=images)
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def port_model(artifacts):
    return export.ExportedModel(artifacts["port"], "cpu")


def test_port_artifact_agrees_with_jax(artifacts, port_model):
    want = jax_export.ExportedModel(artifacts["jax"])(artifacts["images"])
    got = port_model(artifacts["images"])
    assert sorted(got) == sorted(want) == ["boxes", "labels", "scores",
                                           "valid"]
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-4)
    assert got["valid"].any(axis=1).all()


def test_meta_equals_jax(artifacts, port_model):
    with open(os.path.join(os.path.dirname(artifacts["jax"]),
                           export.META_NAME)) as fp:
        want = json.load(fp)
    with open(os.path.join(os.path.dirname(artifacts["port"]),
                           export.META_NAME)) as fp:
        got = json.load(fp)
    assert got == want
    assert got["platforms"] == ["cpu"] and got["batch_size"] == BATCH
    assert port_model.labels == LABELS
    assert port_model.batch_size == BATCH
    assert port_model.image_size == tuple(got["image_size"])


def test_bare_artifact_and_meta_check(artifacts, port_model, tmp_path):
    bare = tmp_path / "bare" / "model.pt2"
    bare.parent.mkdir()
    shutil.copy(artifacts["port"], bare)
    loaded = export.ExportedModel(str(bare), "cpu")
    assert loaded.labels is None
    assert loaded.batch_size == BATCH
    assert loaded.image_size == port_model.image_size
    meta = bare.parent / export.META_NAME
    meta.write_text(json.dumps({"labels": LABELS, "image_size": [64, 64],
                                "batch_size": BATCH}))
    with pytest.raises(ValueError, match=str(meta)):
        export.ExportedModel(str(bare), "cpu")


def test_rejects_float_input(port_model):
    h, w = port_model.image_size
    with pytest.raises(TypeError, match="uint8"):
        port_model(np.zeros((BATCH, h, w, 3), np.float32))


@pytest.mark.parametrize("platforms, match", [
    (("cpu", "cuda"), "one platform per artifact"),
    (("tpu",), "not one of"),
])
def test_platform_refusals(artifacts, platforms, match):
    with pytest.raises(ValueError, match=match):
        export.export_model(artifacts["model_dir"], platforms=platforms)


def test_replays_without_model_code(artifacts, port_model, tmp_path):
    """A fresh interpreter loads and calls the artifact; the port's model,
    training and data modules stay unimported, and the outputs are the
    test process's bits."""
    np.save(tmp_path / "images.npy", artifacts["images"])
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import numpy as np, torch\n"
        f"torch.set_num_threads({TORCH_THREADS})\n"
        "from podtpu_torch.infer.export import ExportedModel\n"
        f"model = ExportedModel({artifacts['port']!r}, 'cpu')\n"
        f"out = model(np.load({str(tmp_path / 'images.npy')!r}))\n"
        f"np.savez({str(tmp_path / 'out.npz')!r}, **out)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.startswith("
        "('podtpu_torch.models', 'podtpu_torch.train', 'podtpu_torch.data',"
        " 'podtpu.', 'jax')))))\n")
    run = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert json.loads(run.stdout.strip().splitlines()[-1]) == []
    got = np.load(tmp_path / "out.npz")
    want = port_model(artifacts["images"])
    assert sorted(got.files) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_exported_server_serves_the_live_detections(artifacts):
    live = DetectionServer(artifacts["model_dir"], batch_size=BATCH,
                           device="cpu")
    served = DetectionServer(artifacts["model_dir"], batch_size=4,
                             device="cpu", exported=artifacts["port"])
    try:
        assert served.batch_size == BATCH        # the artifact's
        assert served.labels == live.labels == LABELS
        assert served.image_size == live.image_size
        n = 0
        for img in artifacts["images"]:
            want = live.detect_array(img, threshold=0.0)
            got = served.detect_array(img, threshold=0.0)
            assert got == want
            n += len(want["detections"])
        assert n > 0
    finally:
        live.close()
        served.close()


def _nms_args():
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 60, (3, 40, 2))
    wh = rng.uniform(4, 30, (3, 40, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                             .astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(3, 40)) > 0.2)
    order = torch.stack([torch.randperm(40, generator=torch.Generator()
                                        .manual_seed(i)) for i in range(3)])
    return boxes, valid, order


def _roi_args():
    rng = np.random.default_rng(6)
    feats = [torch.from_numpy(rng.normal(size=(2, 32 // s, 32 // s, 8))
                              .astype(np.float32)) for s in (4, 8)]
    xy = rng.uniform(-4, 28, (2, 6, 2))
    wh = rng.uniform(1, 20, (2, 6, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                             .astype(np.float32))
    return feats, boxes


@pytest.mark.parametrize("op", ["nms_keep", "nms_keep_order",
                                "roi_align_fwd", "roi_align_fwd_first",
                                "roi_align_bwd"])
def test_opcheck(op):
    """Schema, fake implementation (shapes, dtypes, strides), autograd
    registration and tracing of each operator on its CPU
    implementation."""
    if op.startswith("nms"):
        boxes, valid, order = _nms_args()
        args = (boxes, valid, 0.5, order if op == "nms_keep_order" else None)
        torch.library.opcheck(torch.ops.podtpu.nms_keep.default, args)
        return
    feats, boxes = _roi_args()
    first = op == "roi_align_fwd_first"
    tail = ([4, 8], 7, 2, 224.0, 4, 2, first)
    if op != "roi_align_bwd":
        feats = [f.requires_grad_() for f in feats]
        torch.library.opcheck(torch.ops.podtpu.roi_align_fwd.default,
                              (feats, boxes) + tail)
        return
    grad = torch.randn(2, 6, 7, 7, 8,
                       generator=torch.Generator().manual_seed(7))
    torch.library.opcheck(torch.ops.podtpu.roi_align_bwd.default,
                          (grad, feats, boxes) + tail)


def test_eval_forward_reaches_the_operators(artifacts, port_model):
    """The exported graph names K1 twice (the RPN and the postprocess) and
    K2 once; on the CPU they run their plain versions and count no
    launch."""
    targets = [str(n.target) for n in port_model.module.graph.nodes
               if str(n.target).startswith("podtpu.")]
    assert sorted(targets) == ["podtpu.nms_keep.default",
                               "podtpu.nms_keep.default",
                               "podtpu.roi_align_fwd.default"]
    _build.reset_launches()
    port_model(artifacts["images"])
    assert not _build.launches
