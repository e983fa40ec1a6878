#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, serve.

Run from the repository root on a machine with a CUDA GPU and ``nvcc``:

    python3 chip_smoke.py

Phases, one JSON line each:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile ``podtpu_torch/csrc/*.cu`` for ``sm_90a`` into ``build/``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving shapes (keep masks equal for NMS; RoIAlign within atol 2e-2,
   rtol 1e-2 of a float32 plain run on the same bf16 inputs), with CUDA-event
   times and the least time the card could take for the same work;
4. reference: a small float32 model on the card against the same weights on
   the CPU (plain versions), detection by detection;
5. slice: Faster R-CNN ResNet-50-FPN at the ``ModelConfig`` defaults
   (1024x1024 canvas, bf16, 1000 proposals, 300 detections, 4 classes) with
   seeded random weights, saved as a model directory and served by
   ``DetectionServer(batch_size=4)`` behind HTTP; 8 client threads send
   canvas-sized images; both kernels must have launched during the run.
   A ``breakdown`` line follows: each stage of the eval forward timed with
   CUDA events, and the device's busy share and busiest kernels over a
   ``torch.profiler`` window.

Then the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Any failure exits non-zero before that line.  Without a CUDA device,
or without the ``podtpu_torch`` package beside it, the script fails.
"""
from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): memory rate and the float32
# rate outside the tensor cores (both kernels do float32 arithmetic).
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
NMS_OPS_PER_IOU = 13       # 4 min/max, 2 sub, 2 clamp, mul, add, sub, div, cmp
ROI_OPS_PER_SAMPLE = 12    # per channel: 4 weights, 4 mul-add pairs
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# -- phase 3: kernels against their plain versions ---------------------------

def clustered_boxes(rng, s, n, canvas=1024.0, clusters=40):
    """Score-sorted RPN-like boxes: jittered copies around a few objects."""
    centres = rng.uniform(0, canvas, (s, clusters, 2))
    sizes = rng.uniform(16, 300, (s, clusters, 2))
    pick = rng.integers(0, clusters, (s, n))
    c = np.take_along_axis(centres, pick[..., None], 1)
    wh = np.take_along_axis(sizes, pick[..., None], 1)
    c = c + rng.normal(0, 0.15, (s, n, 2)) * wh
    wh = wh * rng.uniform(0.7, 1.3, (s, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    return np.clip(boxes, 0, canvas).astype(np.float32)


def nms_cases(rng):
    """(name, boxes [S, N, 4], valid [S, N], threshold) in sorted order."""
    cases = []
    b = clustered_boxes(rng, 20, 1000)
    v = rng.uniform(size=(20, 1000)) > 0.03
    v[4::5, 768:] = False            # P6 holds 768 real boxes of 1000
    cases.append(("rpn_s20_n1000", b, v, 0.7))
    b = clustered_boxes(rng, 12, 1000)
    v = rng.uniform(size=(12, 1000)) > 0.3
    cases.append(("postprocess_s12_n1000", b, v, 0.5))
    x = 4.0 * np.arange(512, dtype=np.float32)
    b = np.stack([x, np.zeros(512, np.float32), x + 10,
                  np.full(512, 10, np.float32)], 1)[None]
    cases.append(("adversarial_chain_n512", b, np.ones((1, 512), bool), 0.3))
    b = np.tile(np.array([[[10, 10, 50, 50]]], np.float32), (1, 64, 1))
    cases.append(("identical_n64", b, np.ones((1, 64), bool), 0.5))
    cx = rng.uniform(40, 60, 2048)
    cy = rng.uniform(40, 60, 2048)
    w = rng.uniform(20, 40, 2048)
    b = np.stack([cx - w / 2, cy - w / 2, cx + w / 2, cy + w / 2],
                 1).astype(np.float32)[None]
    cases.append(("cross_tile_cluster_n2048", b, np.ones((1, 2048), bool),
                  0.5))
    xy = rng.uniform(0, 1024, (8192, 2))
    wh = rng.uniform(1, 256, (8192, 2))
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)[None]
    cases.append(("random_n8192", b, np.ones((1, 8192), bool), 0.5))
    return cases


def nms_needed_ops(keep, valid) -> int:
    """IoUs greedy NMS must evaluate on this data: each kept box against
    every later valid box of its segment."""
    later_valid = valid.flip(-1).cumsum(-1).flip(-1) - valid.long()
    return int((later_valid * keep).sum()) * NMS_OPS_PER_IOU


def check_nms(torch, nms, dev):
    rng = np.random.default_rng(SEED)
    serving = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    worst = 0
    for name, b, v, t in nms_cases(rng):
        boxes = torch.from_numpy(b).to(dev)
        valid = torch.from_numpy(v).to(dev)
        got = nms.nms_keep_batched(boxes, valid, t)
        want = nms.nms_keep_plain(boxes, valid, t)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        worst = max(worst, mismatches)
        if name.startswith("adversarial"):
            assert bool(got[0, 0]) and not bool(got[0, 1]) and bool(got[0, 2])
        if name.startswith("identical"):
            assert bool(got[0, 0]) and not bool(got[0, 1:].any())
        rec = {"phase": "kernels", "kernel": "nms", "case": name,
               "shape": list(b.shape), "threshold": t,
               "kept": int(got.sum()), "mismatches": mismatches}
        if name.startswith(("rpn", "postprocess")):
            ms = time_ms(lambda: nms.nms_keep_batched(boxes, valid, t))
            plain_ms = time_ms(lambda: nms.nms_keep_plain(boxes, valid, t),
                               reps=20)
            nbytes = b.shape[0] * b.shape[1] * (16 + 1 + 1)
            ops = nms_needed_ops(want, valid)
            bound = max(nbytes / MEM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
            rec.update(kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       bytes=nbytes, ops=ops,
                       bound_by="operations" if ops / F32_OPS_PER_S
                       > nbytes / MEM_BYTES_PER_S else "bytes")
            serving["ms"] += ms
            serving["plain_ms"] += plain_ms
            serving["bound_ms"] += bound
            serving["bound_by"] = rec["bound_by"]
        emit(rec)
        if mismatches:
            raise AssertionError(f"nms {name}: {mismatches} keep flags differ "
                                 "from the plain version")
    serving["max_abs_err"] = float(worst)
    return serving


def roi_boxes(rng, b, k, canvas=1024.0):
    """RoIs of every kind the serving path meets: ordinary boxes, degenerate,
    partly outside, near-canvas, elongated (level bump), all-zero slots."""
    size = rng.uniform(4, 600, (b, k))
    ar = np.exp(rng.uniform(-1.0, 1.0, (b, k)))
    w, h = size * np.sqrt(ar), size / np.sqrt(ar)
    x = rng.uniform(-20, canvas - 10, (b, k))
    y = rng.uniform(-20, canvas - 10, (b, k))
    boxes = np.stack([x, y, x + w, y + h], -1)
    boxes[:, 0:20] = np.tile(boxes[:, 0:20, :2], 2)                  # zero-size
    boxes[:, 20:30] = [0, 0, canvas - 1, canvas - 1]                 # canvas
    boxes[:, 30:40] = [[-50, 100, 80, 140]]                          # outside
    boxes[:, 40:50] = [[10, 500, 1010, 530]]                         # elongated
    boxes[:, 50:60] = [[1000, 1000, 1030, 1030]]                     # edge
    boxes[:, -40:] = 0.0                                             # invalid
    return boxes.astype(np.float32)


def roi_bound(torch, roi_align, levels, boxes, strides, out=7, ratio=2):
    """Bytes and operations RoIAlign must spend on this data: every feature
    cell some inside sample touches, read once; boxes read once; the output
    written once; 12 operations per inside sample and channel."""
    b, k = boxes.shape[:2]
    c = levels[0].shape[-1]
    lvl = roi_align.assign_levels(boxes, len(strides),
                                  base_stride=float(strides[0])).long()
    dev = boxes.device
    heights = torch.tensor([f.shape[1] for f in levels], device=dev)
    widths = torch.tensor([f.shape[2] for f in levels], device=dev)
    offsets = torch.cumsum(heights * widths, 0) - heights * widths
    scale = 1.0 / torch.tensor(strides, dtype=torch.float32, device=dev)
    n = out * ratio
    g = torch.arange(n, dtype=torch.float32, device=dev)
    g = torch.div(g, ratio, rounding_mode="floor") + (g % ratio + 0.5) / ratio
    s = scale[lvl]
    x1, y1 = boxes[..., 0] * s, boxes[..., 1] * s
    rw = (boxes[..., 2] * s - x1).clamp(min=1.0)
    rh = (boxes[..., 3] * s - y1).clamp(min=1.0)
    ys = y1[..., None] + g * (rh / out)[..., None]
    xs = x1[..., None] + g * (rw / out)[..., None]
    hgt, wid = heights[lvl][..., None], widths[lvl][..., None]
    ylo, yhi, _, _, yin = roi_align._interp_axis(ys, hgt)
    xlo, xhi, _, _, xin = roi_align._interp_axis(xs, wid)
    inside = yin[..., :, None] & xin[..., None, :]            # [B, K, n, n]
    base = (torch.arange(b, device=dev)[:, None] * int((heights * widths)
            .sum()) + offsets[lvl])[..., None, None]
    cells = []
    for yi in (ylo, yhi):
        for xi in (xlo, xhi):
            idx = base + yi[..., :, None] * wid[..., None] + xi[..., None, :]
            cells.append(idx[inside])
    touched = int(torch.unique(torch.cat(cells)).numel())
    nbytes = (touched * c * levels[0].element_size() + boxes.numel() * 4
              + b * k * out * out * c * levels[0].element_size())
    ops = int(inside.sum()) * c * ROI_OPS_PER_SAMPLE
    return nbytes, ops, touched


def check_roi_align(torch, roi_align, dev):
    rng = np.random.default_rng(SEED + 1)
    b, k, c, canvas = 4, 1000, 256, 1024
    strides = (4, 8, 16, 32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    levels = []
    for st in strides:
        nchw = torch.randn((b, c, canvas // st, canvas // st), device=dev,
                           generator=gen).to(torch.bfloat16)
        nchw = nchw.contiguous(memory_format=torch.channels_last)
        levels.append(nchw.permute(0, 2, 3, 1))  # contiguous NHWC view
    boxes = torch.from_numpy(roi_boxes(rng, b, k, canvas)).to(dev)
    got = roi_align.batched_roi_align(levels, boxes, strides)
    levels32 = [f.float() for f in levels]
    want = roi_align.batched_roi_align_plain(levels32, boxes, strides)
    torch.cuda.synchronize()
    err = float((got.float() - want).abs().max())
    ok = bool(torch.allclose(got.float(), want, atol=2e-2, rtol=1e-2))
    ms = time_ms(lambda: roi_align.batched_roi_align(levels, boxes, strides))
    plain_ms = time_ms(lambda: roi_align.batched_roi_align_plain(
        levels32, boxes, strides), reps=20)
    nbytes, ops, touched = roi_bound(torch, roi_align, levels, boxes, strides)
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / F32_OPS_PER_S
    rec = {"phase": "kernels", "kernel": "roi_align_fwd",
           "case": "serving_b4_k1000_c256_bf16", "shape": list(got.shape),
           "max_abs_err": err, "within_tolerance": ok, "kernel_ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bytes": nbytes, "ops": ops, "touched_cells": touched,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    emit(rec)
    if not ok:
        raise AssertionError(f"roi_align: max abs error {err} exceeds atol "
                             "2e-2 / rtol 1e-2")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "max_abs_err": err}


# -- phase 4: small float32 model on the card vs the CPU ---------------------

def check_reference(torch, dev):
    from podtpu_torch.core.config import ModelConfig
    from podtpu_torch.models.detector import init_parameters, make_detector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(image_size=(128, 128), rpn_pre_nms_topk_test=128,
                      rpn_post_nms_topk_test=64, detections_per_image=16,
                      compute_dtype="float32", num_classes=4)
    for seed in range(SEED, SEED + 5):
        cpu = make_detector(cfg)
        init_parameters(cpu, torch.Generator().manual_seed(seed))
        cpu = cpu.to(memory_format=torch.channels_last).eval()
        gpu = copy.deepcopy(cpu).to(dev)
        img = np.random.default_rng(seed).integers(
            0, 256, (2, 128, 128, 3)).astype(np.uint8)
        with torch.inference_mode():
            want = cpu(torch.from_numpy(img))
            got = gpu(torch.from_numpy(img).to(dev))
        s = want.scores[want.valid].sort().values
        if s.numel() > 1 and float(s.diff().min()) < 1e-5:
            continue  # a near tie would make slot order fragile: next seed
        same_valid = torch.equal(got.valid.cpu(), want.valid)
        same_labels = torch.equal(got.labels.cpu(), want.labels)
        box_err = float((got.boxes.cpu() - want.boxes).abs().max())
        score_err = float((got.scores.cpu() - want.scores).abs().max())
        rec = {"phase": "reference", "seed": seed,
               "detections": int(want.valid.sum()), "same_valid": same_valid,
               "same_labels": same_labels, "box_max_abs_err": box_err,
               "score_max_abs_err": score_err}
        emit(rec)
        if not (same_valid and same_labels and box_err <= 1e-3
                and score_err <= 1e-4):
            raise AssertionError("GPU detections disagree with the CPU "
                                 "reference")
        torch.backends.cudnn.allow_tf32 = True
        return
    raise AssertionError("no seed without near-tied scores")


# -- phase 5: the serving slice ----------------------------------------------

def stage_breakdown(torch, model, images):
    """Milliseconds of each stage of one eval forward on the card (CUDA
    events, median), each stage fed the previous stage's outputs, and the
    whole forward."""
    from podtpu_torch.models import roi_heads as rh
    from podtpu_torch.models import rpn as rpn_lib

    cfg = model.cfg
    x = torch.from_numpy(np.stack(images)).cuda()
    with torch.inference_mode():
        pyramid = model.features(x)
        logits, deltas = model.rpn.head(pyramid)
        props = rpn_lib.select_proposals(logits, deltas, model.rpn.anchors(),
                                         cfg)
        pooled = rh.pool_rois_batched(pyramid, props.boxes, cfg)
        b, p = pooled.shape[:2]
        flat = pooled.reshape(b * p, *pooled.shape[2:])
        cls, reg = model.roi_heads(flat)
        stages = {
            "backbone_fpn": lambda: model.features(x),
            "rpn_head": lambda: model.rpn.head(pyramid),
            "select_proposals": lambda: rpn_lib.select_proposals(
                logits, deltas, model.rpn.anchors(), cfg),
            "roi_align": lambda: rh.pool_rois_batched(pyramid, props.boxes,
                                                      cfg),
            "box_head": lambda: model.roi_heads(flat),
            "postprocess": lambda: rh.postprocess_detections(
                cls.reshape(b, p, -1), reg.reshape(b, p, -1), props.boxes,
                props.valid, cfg),
            "forward": lambda: model(x),
        }
        return {name: time_ms(fn, reps=10) for name, fn in stages.items()}


def device_profile(torch, model, images, reps=3):
    """Device busy share over ``reps`` eval forwards (the union of the
    device activities that ``torch.profiler`` records, over the host wall
    time of the window), the device time of the busiest kernels, and the
    self device time of the busiest operators with their calls per
    forward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.from_numpy(np.stack(images)).cuda()
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                model(x)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    by_name = {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    ops = sorted(((e.key, e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0), key=lambda t: -t[1])[:12]
    return {"forwards": reps, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us if spans else None,
            "device_activities": len(spans),
            "top_kernels_ms_per_forward": [
                [name[:160], ms / 1e3 / reps] for name, ms in top],
            "top_ops_self_device_ms_per_forward": [
                [key, us / 1e3 / reps, count // reps]
                for key, us, count in ops]}


def serve_slice(torch, card, dev, cfg):
    from podtpu_torch.infer.server import DetectionServer, make_handler
    from podtpu_torch.models.detector import init_parameters, make_detector
    from podtpu_torch.ops import _build
    from podtpu_torch.train.checkpoints import save_labels, save_model

    labels = ["radiolarian", "foraminifera", "diatom"]
    rng = np.random.default_rng(SEED)
    h, w = cfg.image_size
    threads, per_thread = 8, 8
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for _ in range(threads * per_thread)]
    with tempfile.TemporaryDirectory() as model_dir:
        model = make_detector(cfg)
        init_parameters(model, torch.Generator().manual_seed(SEED))
        save_model(model_dir, model, cfg, labels)
        save_labels(model_dir, labels)
        del model
        t0 = time.perf_counter()
        server = DetectionServer(model_dir, batch_size=4, device=dev)
        load_s = time.perf_counter() - t0
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
        http_thread = threading.Thread(target=httpd.serve_forever,
                                       daemon=True)
        http_thread.start()
        try:
            port = httpd.server_address[1]
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                        timeout=60) as resp:
                health = json.loads(resp.read())
            assert health["status"] == "ok" and health["labels"] == labels

            def run_clients(batch, n_threads):
                results = [None] * len(batch)
                errors = []

                def client(t):
                    try:
                        for i in range(t, len(batch), n_threads):
                            results[i] = server.detect_array(batch[i], 0.05)
                    except Exception as exc:  # reported below
                        errors.append(repr(exc))

                ts = [threading.Thread(target=client, args=(t,))
                      for t in range(n_threads)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(timeout=600)
                assert not any(t.is_alive() for t in ts), "client hung"
                assert not errors, errors
                return results

            t0 = time.perf_counter()
            run_clients(images[:4], 4)        # warm-up batch
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            served0 = server.batches_served
            server.batch_seconds.clear()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            t0 = time.perf_counter()
            results = run_clients(images, threads)
            wall = time.perf_counter() - t0
            launches = dict(_build.launches)
            batches = server.batches_served - served0
            lat = sorted(server.batch_seconds)
            stages = stage_breakdown(torch, server.model, images[:4])
            prof = device_profile(torch, server.model, images[:4])
        finally:
            httpd.shutdown()
            http_thread.join(timeout=30)
            server.close()
    n_det = 0
    for r in results:
        assert isinstance(r, dict) and isinstance(r["detections"], list)
        assert r["width"] == w and r["height"] == h
        for d in r["detections"]:
            x1, y1, x2, y2 = d["box"]
            assert all(np.isfinite(v) for v in d["box"]), d
            assert 0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h, d
            assert np.isfinite(d["score"]) and d["label"] in labels, d
        n_det += len(r["detections"])
    for name in ("nms", "roi_align_fwd"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched while "
                                 "serving")
    rec = {"phase": "slice", "model": "faster_rcnn_resnet50_fpn",
           "image_size": list(cfg.image_size),
           "compute_dtype": cfg.compute_dtype, "batch_size": 4,
           "requests": len(images), "client_threads": threads,
           "batches_served": batches, "detections": n_det,
           "load_s": load_s, "warmup_s": warm_s, "wall_s": wall,
           "images_per_s": len(images) / wall,
           "batch_latency_p50_ms": statistics.median(lat) * 1e3,
           "batch_latency_max_ms": lat[-1] * 1e3,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches,
           "launches_per_batch": {k: v / batches
                                  for k, v in launches.items()},
           "card": card}
    emit(rec)
    emit({"phase": "breakdown", "batch_size": 4, "stages_ms": stages,
          "profile": prof, "card": card})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from podtpu_torch.ops import _build, nms, roi_align

    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.library()
    log = (_build.BUILD_DIR / "nvcc.log").read_text()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    from podtpu_torch.core.config import ModelConfig

    nms_rec = check_nms(torch, nms, "cuda")
    roi_rec = check_roi_align(torch, roi_align, "cuda")
    check_reference(torch, "cuda")
    launches = serve_slice(torch, card, "cuda", ModelConfig(num_classes=4))

    kernels = [
        dict(name="nms", route="cuda", source="podtpu_torch/csrc/nms.cu",
             replaces="podtpu/ops/pallas/nms_kernel.py:46",
             launches=launches["nms"], max_abs_err=nms_rec["max_abs_err"],
             ms=nms_rec["ms"], plain_ms=nms_rec["plain_ms"],
             bound_ms=nms_rec["bound_ms"], bound_by=nms_rec["bound_by"],
             library_ms=None),
        dict(name="roi_align_fwd", route="cuda",
             source="podtpu_torch/csrc/roi_align.cu",
             replaces="podtpu/ops/pallas/roi_align_kernel.py:157",
             launches=launches["roi_align_fwd"],
             max_abs_err=roi_rec["max_abs_err"], ms=roi_rec["ms"],
             plain_ms=roi_rec["plain_ms"], bound_ms=roi_rec["bound_ms"],
             bound_by=roi_rec["bound_by"], library_ms=None),
    ]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
