"""Micro-batching HTTP inference server.

Counterpart of ``podtpu/infer/server.py`` (live model; the exported-artifact
mode is not ported).  Requests are decoded and fitted to the model's canvas
on the callers' threads, coalesced into fixed-size batches by one worker
thread, and run through the model on its device.

    POST /detect    body: image bytes; query: ?threshold=0.5
    ->  {"detections": [{"box": [x1,y1,x2,y2], "score": s, "label": name}],
         "width": W, "height": H}
    GET  /healthz   -> {"status": "ok", "model": ..., "labels": [...]}

``DetectionServer.detect_array`` serves an RGB uint8 array directly; for an
array already at the canvas size it needs no image library.
"""
from __future__ import annotations

import collections
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from podtpu_torch.data.dataset import fit_resize
from podtpu_torch.data.imageio import pil_to_rgb
from podtpu_torch.infer.inference import (load_inference_model,
                                          split_eval_output)


class _Request:
    __slots__ = ("canvas", "scale", "size", "threshold", "event", "result",
                 "error")

    def __init__(self, canvas, scale, size, threshold):
        self.canvas = canvas
        self.scale = scale
        self.size = size
        self.threshold = threshold
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None


class DetectionServer:
    """Model runner + micro-batcher; the HTTP layer sits on top.

    ``batch_seconds`` keeps the wall time of the most recent batches (host
    copy, forward and the copy back), ``batches_served`` their count.
    """

    def __init__(self, model_dir: str, batch_size: int = 4,
                 batch_timeout_ms: float = 8.0, device=None):
        self.model_dir = model_dir
        forward, self.model, cfg, self.labels = load_inference_model(
            model_dir, device)
        self.image_size = cfg.image_size

        def run(images):
            det, _, _ = split_eval_output(forward(images))
            return {"boxes": det.boxes.cpu().numpy(),
                    "scores": det.scores.cpu().numpy(),
                    "labels": det.labels.cpu().numpy(),
                    "valid": det.valid.cpu().numpy()}

        self._forward = run
        self.batch_size = batch_size
        self.batch_timeout = batch_timeout_ms / 1e3
        self.batches_served = 0
        self.batch_seconds = collections.deque(maxlen=4096)
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side ---------------------------------------------------------
    def detect(self, image_bytes: bytes, threshold: float = 0.5) -> dict:
        """Decode image bytes (Pillow) and serve them."""
        from PIL import Image

        with Image.open(io.BytesIO(image_bytes)) as im:
            arr = pil_to_rgb(im)
        return self.detect_array(arr, threshold)

    def detect_array(self, rgb: np.ndarray, threshold: float = 0.5) -> dict:
        """Serve one ``[H, W, 3]`` uint8 RGB image; boxes come back in its
        pixel coordinates."""
        h, w = rgb.shape[:2]
        resized, scale = fit_resize(rgb, self.image_size)
        ch, cw = self.image_size
        canvas = np.zeros((ch, cw, 3), np.uint8)
        canvas[: resized.shape[0], : resized.shape[1]] = resized
        req = _Request(canvas, scale, (h, w), threshold)
        if self._stop.is_set():
            raise RuntimeError("server is shut down")
        self._q.put(req)
        # Poll with a stop check: a request that races close() (enqueued
        # after the drain) must not wait forever.
        while not req.event.wait(timeout=1.0):
            if self._stop.is_set() and not req.event.wait(timeout=5.0):
                raise RuntimeError("server is shut down")
        if req.error:
            raise RuntimeError(req.error)
        return req.result

    def close(self):
        self._stop.set()
        self._q.put(None)  # wake the worker
        self._worker.join(timeout=30.0)
        # Fail any request that raced the shutdown.
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.error = "server is shut down"
                req.event.set()

    # -- batching worker -----------------------------------------------------
    def _run(self):
        while not self._stop.is_set():
            first = self._q.get()
            if first is None:
                continue
            batch = [first]
            # Coalesce whatever arrives within ONE shared window, up to
            # batch_size.
            t_end = time.monotonic() + self.batch_timeout
            while len(batch) < self.batch_size:
                remaining = t_end - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
            try:
                self._process(batch)
            except Exception as exc:  # surface to all waiters
                for req in batch:
                    req.error = f"{type(exc).__name__}: {exc}"
                    req.event.set()

    def _process(self, batch: List[_Request]):
        t0 = time.perf_counter()
        ch, cw = self.image_size
        images = np.zeros((self.batch_size, ch, cw, 3), np.uint8)
        for i, req in enumerate(batch):
            images[i] = req.canvas
        out = self._forward(images)
        self.batch_seconds.append(time.perf_counter() - t0)
        self.batches_served += 1
        boxes, scores = out["boxes"], out["scores"]
        labels, valid = out["labels"], out["valid"]
        for i, req in enumerate(batch):
            keep = np.flatnonzero(valid[i] & (scores[i] > req.threshold))
            dets = [{"box": [float(v) for v in boxes[i, j] / req.scale],
                     "score": float(scores[i, j]),
                     "label": self.labels[int(labels[i, j]) - 1]}
                    for j in keep]
            req.result = {"detections": dets, "width": req.size[1],
                          "height": req.size[0]}
            req.event.set()


def make_handler(server: DetectionServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._send(200, {"status": "ok",
                                 "model": server.model_dir,
                                 "labels": server.labels})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path != "/detect":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                data = self.rfile.read(length)
                qs = parse_qs(parsed.query)
                thr = float(qs.get("threshold", ["0.5"])[0])
                self._send(200, server.detect(data, threshold=thr))
            except Exception as exc:
                self._send(400, {"error": f"{type(exc).__name__}: {exc}"})

    return Handler


def serve(model_dir: str, host: str = "0.0.0.0", port: int = 8500,
          batch_size: int = 4, device=None) -> None:
    """Blocking entry point: serve ``model_dir`` over HTTP."""
    runner = DetectionServer(model_dir, batch_size=batch_size, device=device)
    httpd = ThreadingHTTPServer((host, port), make_handler(runner))
    print(f"podtpu_torch serving {model_dir} on {host}:{port} "
          f"(batch {batch_size}, labels {runner.labels})")
    try:
        httpd.serve_forever()
    finally:
        runner.close()
