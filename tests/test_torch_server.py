"""The podtpu_torch server against the JAX server, and import hygiene (CPU).

Both servers load one model directory; the same PNG requests over HTTP give
the same detections (labels exactly, boxes to 1e-3 px, scores to 1e-4).
"""
import io
import json
import subprocess
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from podtpu_torch.core.config import ModelConfig
from podtpu_torch.data.dataset import fit_resize
from podtpu_torch.infer import inference
from podtpu_torch.infer.server import DetectionServer, make_handler
from podtpu_torch.models.detector import init_parameters, make_detector
from podtpu_torch.ops import _build
from podtpu_torch.train.checkpoints import save_labels, save_model

REPO = Path(__file__).resolve().parent.parent
LABELS = ["radiolarian", "diatom"]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    cfg = ModelConfig(image_size=(128, 128), rpn_pre_nms_topk_test=128,
                      rpn_post_nms_topk_test=64, detections_per_image=16,
                      compute_dtype="float32", num_classes=3)
    model = make_detector(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    out = tmp_path_factory.mktemp("torch_model")
    save_model(str(out), model, cfg, LABELS)
    save_labels(str(out), LABELS)
    return str(out)


def start(runner):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(runner))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def png(seed, h, w):
    rng = np.random.default_rng(seed)
    img = rng.integers(10, 60, (h, w, 3)).astype(np.uint8)
    img[h // 4: h // 2, w // 3: w // 2] = (230, 220, 240)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def post(port, data):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/detect?threshold=0.05", data=data,
        method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


class TestServerParity:
    def test_same_detections_over_http(self, model_dir):
        from podtpu.infer.server import DetectionServer as JaxServer

        ours = DetectionServer(model_dir, batch_size=2, batch_timeout_ms=5,
                               device="cpu")
        ref = JaxServer(model_dir, batch_size=2, batch_timeout_ms=5)
        servers = [start(ours), start(ref)]
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{servers[0].server_address[1]}"
                    "/healthz", timeout=30) as resp:
                assert json.loads(resp.read())["labels"] == LABELS
            for seed, (h, w) in enumerate([(128, 128), (160, 96)]):
                data = png(seed, h, w)
                got, want = (post(s.server_address[1], data)
                             for s in servers)
                assert (got["width"], got["height"]) == (w, h)
                assert len(want["detections"]) > 3
                scores = np.sort([d["score"] for d in want["detections"]])
                assert np.diff(scores).min() > 1e-5  # no fragile near ties
                assert len(got["detections"]) == len(want["detections"])
                for a, b in zip(got["detections"], want["detections"]):
                    assert a["label"] == b["label"]
                    assert a["score"] == pytest.approx(b["score"], abs=1e-4)
                    np.testing.assert_allclose(a["box"], b["box"], atol=1e-3)
                    # Boxes are clipped to the canvas, mapped back by the
                    # fit scale (as in the JAX server).
                    edge = 128 / min(128 / h, 128 / w) + 1e-3
                    assert 0 <= a["box"][0] <= a["box"][2] <= edge
                    assert 0 <= a["box"][1] <= a["box"][3] <= edge
        finally:
            for s in servers:
                s.shutdown()
            ours.close()
            ref.close()

    def test_canvas_array_needs_no_image_library(self, model_dir,
                                                 monkeypatch):
        runner = DetectionServer(model_dir, batch_size=2, batch_timeout_ms=5,
                                 device="cpu")
        try:
            img = np.random.default_rng(3).integers(
                0, 256, (128, 128, 3)).astype(np.uint8)
            assert fit_resize(img, (128, 128))[0] is img
            monkeypatch.setitem(sys.modules, "cv2", None)
            monkeypatch.setitem(sys.modules, "PIL", None)
            _build.reset_launches()
            out = runner.detect_array(img, threshold=0.05)
            assert out["width"] == 128 and out["detections"]
            assert runner.batches_served == 1
            assert not _build.launches  # the CPU runs the plain versions
        finally:
            runner.close()
        with pytest.raises(RuntimeError, match="shut down"):
            runner.detect_array(img)

    def test_bad_payload_is_400(self, model_dir):
        runner = DetectionServer(model_dir, batch_size=1, device="cpu")
        httpd = start(runner)
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                post(httpd.server_address[1], b"not an image")
            assert err.value.code == 400
        finally:
            httpd.shutdown()
            runner.close()


class TestDeviceAndImports:
    def test_no_gpu_and_no_device_raises(self, model_dir, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            inference.load_inference_model(model_dir)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DetectionServer(model_dir)

    def test_explicit_cpu_loads(self, model_dir):
        forward, model, cfg, labels = inference.load_inference_model(
            model_dir, device="cpu")
        assert labels == LABELS and cfg.num_classes == 3
        assert next(model.parameters()).device.type == "cpu"
        det, masks, kps = inference.split_eval_output(forward(
            np.zeros((1, 128, 128, 3), np.uint8)))
        assert det.boxes.shape == (1, 16, 4) and masks is None and kps is None

    def test_port_imports_no_jax_and_no_podtpu(self):
        code = (
            "import importlib, pkgutil, sys\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "import podtpu_torch\n"
            "for m in pkgutil.walk_packages(podtpu_torch.__path__,"
            " 'podtpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'flax', 'optax', 'podtpu', 'msgpack',"
            " 'triton'))\n"
            "print(len([m for m in sys.modules"
            " if m.startswith('podtpu_torch.')]), bad)\n")
        out = subprocess.run([sys.executable, "-I", "-c", code],
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        count, bad = out.stdout.split(" ", 1)
        assert int(count) >= 20 and bad.strip() == "[]"

    @pytest.mark.parametrize("alone", [False, True])
    def test_chip_smoke_fails_without_card_or_package(self, alone, tmp_path):
        if not alone and torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the smoke would run")
        cwd = REPO
        if alone:  # chip_smoke.py and nothing else of the repository
            (tmp_path / "chip_smoke.py").write_text(
                (REPO / "chip_smoke.py").read_text())
            cwd = tmp_path
        out = subprocess.run([sys.executable, "-I", "chip_smoke.py"],
                             cwd=cwd, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
