#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, serve,
train.

Run from the repository root on a machine with a CUDA GPU and ``nvcc``:

    python3 chip_smoke.py

Phases, one JSON line each:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile ``podtpu_torch/csrc/*.cu`` for ``sm_90a`` into ``build/``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving and the training shapes (keep masks equal for NMS, each case
   twice for equal bits, one unsorted case through the kernel's ``order``
   path against the sorted path, kept boxes per segment; RoIAlign
   forward within atol 2e-2, rtol 1e-2 of a float32 plain run on the same
   bf16 inputs; RoIAlign backward within atol 2e-2, rtol 1e-2 in bf16 and
   atol 1e-4, rtol 1e-4 in float32 of the float32 plain backward; both
   RoIAlign kernels in both output layouts, the backward also on RoIs
   placed against its 8x8 tiles and twice for equal bits), with CUDA-event
   times and the least time the card could take for the same work;
4. reference: a small float32 model on the card against the same weights on
   the CPU (plain versions), detection by detection;
5. slice: Faster R-CNN ResNet-50-FPN at the ``ModelConfig`` defaults
   (1024x1024 canvas, bf16, 1000 proposals, 300 detections, 4 classes) with
   seeded random weights, saved as a model directory and served by
   ``DetectionServer(batch_size=4)`` behind HTTP; 8 client threads send
   canvas-sized images; both forward kernels must have launched during the
   run.  A ``breakdown`` line follows: each stage of the eval forward timed
   with CUDA events, and the device's busy share and busiest kernels over a
   ``torch.profiler`` window;
6. train_reference: one training step of a small float32 model on the CPU
   and on the card, there once with K3 and once with its plain version,
   same weights and draws, six seeds, TF32 off: losses, gradients and
   updated parameters must agree, and the ReLU inputs whose sign differs
   between runs are counted;
7. train: the same detector trained at the ``TrainConfig`` defaults (batch
   2, SGD, miso augmentation) on seeded synthetic batches, 3 warm-up and 20
   timed steps; every loss finite and NMS, RoIAlign forward and RoIAlign
   backward launched on every step; the trained model saved and served one
   batch through ``load_inference_model``.  A ``train_breakdown`` line
   follows: CUDA-event times of augmentation, forward and losses, backward
   and optimiser, recorded through the step's ``mark`` hook, and a
   ``torch.profiler`` window of 3 steps.

Then K1 on the inputs the main paths gave it (one serving batch's RPN and
postprocess calls, one training step's call, captured after the timed
runs): as the path calls it and in score order, against the plain version,
twice, with times.  Then the ``{"kernels": [...]}`` line and, last, the
``{"ok": true, ...}``
line.  Any failure exits non-zero before that line.  Without a CUDA device,
or without the ``podtpu_torch`` package beside it, the script fails.
"""
from __future__ import annotations

import contextlib
import copy
import json
import re
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
ROI_BWD_OPS_PER_SAMPLE = 10  # per channel: 2 row weights, 4 corner weights,
                             # 4 adds
K3_TILE = 8                  # K3's tile side in cells (csrc/roi_align.cu),
K3_SPLIT_TARGET = 128        # the tiles under which a level's tiles are
K3_MAX_SPLIT = 8             # split over blocks, and the most blocks a tile
SEED = 0
TRAIN_B, TRAIN_K = 2, 512  # images per step, sampled RoIs per image


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
    b = clustered_boxes(rng, 10, 2000)
    v = rng.uniform(size=(10, 2000)) > 0.03
    v[4::5, 768:] = False            # P6 holds 768 real boxes of 2000
    cases.append(("train_rpn_s10_n2000", b, v, 0.7))
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


def nms_needed_ops(keep, valid, order=None) -> int:
    """IoUs greedy NMS must evaluate on this data: each kept box against
    every later valid box of its segment, in score order."""
    if order is not None:
        keep, valid = keep.gather(1, order), valid.gather(1, order)
    later_valid = valid.flip(-1).cumsum(-1).flip(-1) - valid.long()
    return int((later_valid * keep).sum()) * NMS_OPS_PER_IOU


def plain_keep(torch, nms, boxes, valid, t, order=None):
    """The plain version's keep mask, through ``order`` as the kernel reads
    and writes it: gather, plain NMS in score order, scatter back."""
    if order is None:
        return nms.nms_keep_plain(boxes, valid, t)
    sb = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    kept = nms.nms_keep_plain(sb, torch.gather(valid, 1, order), t)
    return torch.zeros_like(kept).scatter_(1, order, kept)


def nms_record(torch, nms, name, boxes, valid, t, order=None, timed=False):
    """K1 on one case against its plain version, twice for equal bits; the
    kept boxes of each segment; with ``timed``, CUDA-event times of the
    wrapper and the plain version and the bound."""
    got = nms.nms_keep_batched(boxes, valid, t, order)
    again = nms.nms_keep_batched(boxes, valid, t, order)
    want = plain_keep(torch, nms, boxes, valid, t, order)
    torch.cuda.synchronize()
    rec = {"phase": "kernels", "kernel": "nms", "case": name,
           "shape": list(boxes.shape), "threshold": t,
           "order": order is not None, "kept": int(got.sum()),
           "kept_per_segment": got.sum(-1).tolist(),
           "valid": int(valid.sum()),
           "mismatches": int((got != want).sum()),
           "equal_bits_twice": bool(torch.equal(got, again))}
    if timed:
        ms = time_ms(lambda: nms.nms_keep_batched(boxes, valid, t, order))
        plain_ms = time_ms(lambda: plain_keep(torch, nms, boxes, valid, t,
                                              order), reps=20)
        nbytes = boxes.shape[0] * boxes.shape[1] * (
            16 + 1 + 1 + (8 if order is not None else 0))
        ops = nms_needed_ops(got, valid, order)
        t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / F32_OPS_PER_S
        rec.update(kernel_ms=ms, plain_ms=plain_ms,
                   bound_ms=max(t_bytes, t_ops) * 1e3, bytes=nbytes, ops=ops,
                   bound_by="operations" if t_ops > t_bytes else "bytes")
    emit(rec)
    if rec["mismatches"] or not rec["equal_bits_twice"]:
        raise AssertionError(f"nms {name}: {rec['mismatches']} keep flags "
                             "differ from the plain version, or two runs "
                             "differ")
    return got, rec


def check_nms(torch, nms, dev):
    """Keep masks against the plain version on every case, each twice for
    equal bits, and once through the ``order`` path on unsorted input; the
    serving cases' times summed per batch (the kernels line reports
    those)."""
    rng = np.random.default_rng(SEED)
    serving = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for name, b, v, t in nms_cases(rng):
        boxes = torch.from_numpy(b).to(dev)
        valid = torch.from_numpy(v).to(dev)
        timed = name.startswith(("rpn", "postprocess", "train"))
        got, rec = nms_record(torch, nms, name, boxes, valid, t, timed=timed)
        if name.startswith("adversarial"):
            assert bool(got[0, 0]) and not bool(got[0, 1]) and bool(got[0, 2])
        if name.startswith("identical"):
            assert bool(got[0, 0]) and not bool(got[0, 1:].any())
        if timed and not name.startswith("train"):
            serving["ms"] += rec["kernel_ms"]
            serving["plain_ms"] += rec["plain_ms"]
            serving["bound_ms"] += rec["bound_ms"]
            serving["bound_by"] = rec["bound_by"]
    # Unsorted input through the order path: the same boxes shuffled, with
    # scores that put them back in their first order.
    b, v, t = nms_cases(np.random.default_rng(SEED))[0][1:]
    perm = np.stack([rng.permutation(b.shape[1]) for _ in range(b.shape[0])])
    boxes = torch.from_numpy(np.take_along_axis(b, perm[..., None], 1)).to(dev)
    valid = torch.from_numpy(np.take_along_axis(v, perm, 1)).to(dev)
    scores = -torch.from_numpy(perm).to(dev).float()
    order = nms.sort_by_score(scores, valid)
    got, _ = nms_record(torch, nms, "rpn_s20_n1000_unsorted", boxes, valid,
                        t, order=order, timed=True)
    sorted_path = nms.nms_keep_batched(torch.from_numpy(b).to(dev),
                                       torch.from_numpy(v).to(dev), t)
    segments = nms.nms_keep_segments(boxes, scores, t, valid)
    back = torch.gather(sorted_path, 1, torch.from_numpy(perm).to(dev))
    if not (torch.equal(got, back) and torch.equal(segments, got)):
        raise AssertionError("nms: the order path differs from the sorted "
                             "path")
    serving["max_abs_err"] = 0.0
    return serving


def capture_nms(nms, run):
    """The inputs of every K1 call that ``run()`` makes, as the main path
    hands them to ``nms_keep_batched`` (boxes, validity, threshold and
    order), cloned."""
    calls = []
    launch = nms.nms_keep_batched

    def recording(boxes, valid, t, order=None):
        calls.append((boxes.clone(), valid.clone(), t,
                      None if order is None else order.clone()))
        return launch(boxes, valid, t, order)

    nms.nms_keep_batched = recording
    try:
        run()
    finally:
        nms.nms_keep_batched = launch
    return calls


def check_nms_main_path(torch, nms, captured):
    """K1 on the inputs the main paths gave it (one serving batch's RPN and
    postprocess calls, one training step's call): as the path calls it, and
    in score order through the sorted-form wrapper, against the plain
    version, twice, with times."""
    for path, calls in captured:
        for k, (boxes, valid, t, order) in enumerate(calls):
            name = f"{path}_call{k}_s{boxes.shape[0]}_n{boxes.shape[1]}"
            nms_record(torch, nms, name, boxes, valid, t, order, timed=True)
            if order is not None:
                sb = torch.gather(boxes, 1,
                                  order[..., None].expand(-1, -1, 4))
                nms_record(torch, nms, name + "_sorted", sb.contiguous(),
                           torch.gather(valid, 1, order), t, timed=True)


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


def roi_samples(torch, roi_align, levels, boxes, strides, out=7, ratio=2):
    """Level, neighbour cells and inside flags of every sample of every RoI
    (``[B, K, out * ratio]`` per axis), by the plain version's arithmetic."""
    lvl = roi_align.assign_levels(boxes, len(strides),
                                  base_stride=float(strides[0])).long()
    dev = boxes.device
    heights = torch.tensor([f.shape[1] for f in levels], device=dev)
    widths = torch.tensor([f.shape[2] for f in levels], device=dev)
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
    return lvl, heights, widths, (ylo, yhi, yin), (xlo, xhi, xin)


def roi_bound(torch, roi_align, levels, boxes, strides, out=7, ratio=2):
    """Bytes and operations RoIAlign must spend on this data: every feature
    cell some inside sample touches, read once; boxes read once; the output
    written once; 12 operations per inside sample and channel."""
    b, k = boxes.shape[:2]
    c = levels[0].shape[-1]
    dev = boxes.device
    lvl, heights, widths, (ylo, yhi, yin), (xlo, xhi, xin) = roi_samples(
        torch, roi_align, levels, boxes, strides, out, ratio)
    offsets = torch.cumsum(heights * widths, 0) - heights * widths
    wid = widths[lvl][..., None]
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


def k3_tile_hits(torch, roi_align, levels, boxes, strides, out=7, ratio=2):
    """(RoI, tile) pairs K3 visits: for each RoI the tiles of K3_TILE cells
    a side that the rectangle of its inside samples' cells meets."""
    _, _, _, (ylo, yhi, yin), (xlo, xhi, xin) = roi_samples(
        torch, roi_align, levels, boxes, strides, out, ratio)
    big = 1 << 30

    def span(lo, hi, inside):
        first = torch.where(inside, lo, big).amin(-1) // K3_TILE
        last = torch.where(inside, hi, -1).amax(-1) // K3_TILE
        return torch.where(inside.any(-1), last - first + 1, 0)

    return int((span(ylo, yhi, yin) * span(xlo, xhi, xin)).sum())


def random_levels(torch, dev, gen, b, c=256, canvas=1024,
                  strides=(4, 8, 16, 32), dtype=None):
    """P2..P5-shaped levels as the model hands them to RoIAlign: the
    contiguous NHWC view of channels_last NCHW tensors."""
    levels = []
    for st in strides:
        nchw = torch.randn((b, c, canvas // st, canvas // st), device=dev,
                           generator=gen).to(dtype or torch.bfloat16)
        nchw = nchw.contiguous(memory_format=torch.channels_last)
        levels.append(nchw.permute(0, 2, 3, 1))
    return levels


def check_roi_align(torch, roi_align, dev, b=4, k=1000, seed=SEED + 1,
                    case="serving_b4_k1000_c256_bf16"):
    """K2 in both output layouts against the float32 plain run on the same
    bf16 inputs.  ``kernel_ms`` is the JAX package's layout, ``[B, K, out,
    out, C]``; ``kernel_ms_channels_first`` the box head's, which the
    model's paths launch."""
    rng = np.random.default_rng(seed)
    c, canvas = 256, 1024
    strides = (4, 8, 16, 32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    levels = random_levels(torch, dev, gen, b, c, canvas, strides)
    boxes = torch.from_numpy(roi_boxes(rng, b, k, canvas)).to(dev)
    got = roi_align.batched_roi_align(levels, boxes, strides)
    got_cf = roi_align.batched_roi_align(levels, boxes, strides,
                                         channels_first=True)
    levels32 = [f.float() for f in levels]
    want = roi_align.batched_roi_align_plain(levels32, boxes, strides)
    # The card computes each box's level in one kernel of its own; the
    # plain version computes it with torch operations.
    level_mismatches = int((roi_align._assign_levels_kernel(
        boxes, len(strides), 224.0, 4, 2, float(strides[0]))
        != roi_align.assign_levels(boxes, len(strides),
                                   base_stride=float(strides[0]))).sum())
    torch.cuda.synchronize()
    same_layouts = bool(torch.equal(got_cf, got.permute(0, 1, 4, 2, 3)))
    err = float((got.float() - want).abs().max())
    ok = bool(torch.allclose(got.float(), want, atol=2e-2, rtol=1e-2))
    del got_cf
    ms = time_ms(lambda: roi_align.batched_roi_align(levels, boxes, strides))
    ms_cf = time_ms(lambda: roi_align.batched_roi_align(
        levels, boxes, strides, channels_first=True))
    plain_ms = time_ms(lambda: roi_align.batched_roi_align_plain(
        levels32, boxes, strides), reps=20)
    nbytes, ops, touched = roi_bound(torch, roi_align, levels, boxes, strides)
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / F32_OPS_PER_S
    rec = {"phase": "kernels", "kernel": "roi_align_fwd",
           "case": case, "shape": list(got.shape),
           "max_abs_err": err, "within_tolerance": ok,
           "channels_first_equal_bits": same_layouts,
           "level_mismatches": level_mismatches, "kernel_ms": ms,
           "kernel_ms_channels_first": ms_cf,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bytes": nbytes, "ops": ops, "touched_cells": touched,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    emit(rec)
    if not ok:
        raise AssertionError(f"roi_align: max abs error {err} exceeds atol "
                             "2e-2 / rtol 1e-2")
    if not same_layouts:
        raise AssertionError("roi_align: the channels-first output differs "
                             "from the permuted channels-last output")
    if level_mismatches:
        raise AssertionError(f"roi_align: {level_mismatches} boxes get "
                             "another level on the card than in torch")
    return {"ms": ms_cf, "plain_ms": plain_ms, "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "max_abs_err": err}


def tile_case_boxes(rng, b, k, canvas=1024.0):
    """RoIs placed against K3's 8x8-cell tiles (32 px at P2, 64 at P3, 128
    at P4, 256 at P5): straddling tile borders and corners on every level,
    wholly inside one tile, covering all of P5, stacked on one spot, at and
    beyond the canvas edge, zero-size, then random ones."""
    fixed = np.array([
        [36, 36, 56, 56], [2, 2, 20, 28],            # inside one P2 tile
        [20, 20, 44, 44], [28, 60, 70, 68],          # across P2 borders
        [200, 200, 330, 330], [130, 120, 250, 260],  # P3, across corners
        [136, 136, 180, 184],                        # inside one P3 tile
        [300, 100, 600, 380], [250, 250, 520, 516],  # P4 across borders
        [0, 0, 1023, 1023], [0, 0, 1024, 1024],      # all of P5
        [100, 200, 900, 760], [500, 500, 1100, 1100],
        [10, 500, 1010, 530], [-50, 100, 80, 140],   # elongated, outside
        [1000, 1000, 1030, 1030], [0, 0, 0, 0], [512, 512, 512, 512],
    ], np.float32)
    boxes = roi_boxes(rng, b, k, canvas)
    n = len(fixed)
    boxes[:, :n] = fixed
    boxes[:, n:2 * n] = fixed      # every fixed RoI twice: sums over RoIs
    boxes[:, 2 * n:2 * n + 6] = [[250, 250, 520, 516]]
    return boxes


def check_roi_align_cases(torch, roi_align, dev):
    """K2 and K3 on RoIs placed against K3's tiles, in bf16 and float32,
    both layouts, output sizes 7 and 14, at the training level shapes with
    48 channels (one ragged chunk and group), against the float32 plain
    versions; K3 twice for equal bits."""
    b, k, c, canvas = 2, 64, 48, 1024
    strides = (4, 8, 16, 32)
    rng = np.random.default_rng(SEED + 4)
    boxes = torch.from_numpy(tile_case_boxes(rng, b, k, canvas)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    tols = {torch.bfloat16: dict(atol=2e-2, rtol=1e-2),
            torch.float32: dict(atol=1e-4, rtol=1e-4)}
    worst = {}
    for out_size in (7, 14):
        for dtype, tol in tols.items():
            if out_size == 14 and dtype == torch.float32:
                # 196 bins a RoI and stacked RoIs: sums of hundreds of
                # float32 terms, in the plain version too.
                tol = dict(atol=5e-4, rtol=1e-4)
            levels = random_levels(torch, dev, gen, b, c, canvas, strides,
                                   dtype)
            levels32 = [f.float() for f in levels]
            g = torch.randn((b, k, out_size, out_size, c), device=dev,
                            generator=gen).to(dtype)
            want_f = roi_align.batched_roi_align_plain(
                levels32, boxes, strides, out_size)
            want_b = roi_align.batched_roi_align_backward_plain(
                g.float(), levels32, boxes, strides, out_size)
            for cf in (False, True):
                name = (f"out{out_size}_"
                        f"{'bf16' if dtype == torch.bfloat16 else 'f32'}_"
                        f"{'channels_first' if cf else 'channels_last'}")
                got_f = roi_align.batched_roi_align(
                    levels, boxes, strides, out_size, channels_first=cf)
                if cf:
                    got_f = got_f.permute(0, 1, 3, 4, 2)
                g_in = g.permute(0, 1, 4, 2, 3).contiguous() if cf else g
                got_b = roi_align.batched_roi_align_backward(
                    g_in, levels, boxes, strides, out_size,
                    channels_first=cf)
                again = roi_align.batched_roi_align_backward(
                    g_in, levels, boxes, strides, out_size,
                    channels_first=cf)
                torch.cuda.synchronize()
                # The forward's own tolerance in float32: sums of four
                # products of values near 1 in another order.
                f_tol = tol if dtype == torch.bfloat16 else dict(
                    atol=1e-4, rtol=1e-4)
                rec = {"phase": "kernels", "kernel": "roi_align_cases",
                       "case": name,
                       "fwd_max_abs_err": float(
                           (got_f.float() - want_f).abs().max()),
                       "fwd_ok": bool(torch.allclose(got_f.float(), want_f,
                                                     **f_tol)),
                       "bwd_max_abs_err": max(
                           float((x.float() - w).abs().max())
                           for x, w in zip(got_b, want_b)),
                       "bwd_ok": all(
                           x.dtype == dtype
                           and torch.allclose(x.float(), w, **tol)
                           for x, w in zip(got_b, want_b)),
                       "bwd_equal_bits": all(
                           torch.equal(x, y) for x, y in zip(got_b, again))}
                emit(rec)
                if not (rec["fwd_ok"] and rec["bwd_ok"]
                        and rec["bwd_equal_bits"]):
                    raise AssertionError(f"roi_align cases {name}: {rec}")
                worst[name] = rec
    return worst


def check_roi_align_bwd(torch, roi_align, dev):
    """K3 at the training shapes, in bf16 (the training path) and float32,
    in both layouts of the upstream gradient, against the float32 plain
    backward on the same inputs, and twice for equal bits.  Its bound
    counts what the function must move: the upstream gradient and the
    boxes, read once, and every cell of the level gradients, written once
    in the level dtype (the untouched cells as zeros).  ``bytes_moved``
    counts what this design moves: the level and preparing passes (boxes
    read, levels, each RoI's sample entries and 8 bytes of rectangle
    written), each block's scan of its image's rectangles, the upstream
    gradient and the sample entries of a RoI once for every tile its
    rectangle meets, the float32 partial tiles of the split coarse levels
    written and read once, and the level gradients written once."""
    rng = np.random.default_rng(SEED + 2)
    b, k, c, canvas = TRAIN_B, TRAIN_K, 256, 1024
    strides = (4, 8, 16, 32)
    boxes = torch.from_numpy(roi_boxes(rng, b, k, canvas)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    out = {}
    for dtype, tol in ((torch.bfloat16, dict(atol=2e-2, rtol=1e-2)),
                       (torch.float32, dict(atol=1e-4, rtol=1e-4))):
        levels = random_levels(torch, dev, gen, b, c, canvas, strides, dtype)
        g = torch.randn((b, k, 7, 7, c), device=dev, generator=gen).to(dtype)
        g_cf = g.permute(0, 1, 4, 2, 3).contiguous()
        got = roi_align.batched_roi_align_backward(g, levels, boxes, strides)
        again = roi_align.batched_roi_align_backward(g, levels, boxes,
                                                     strides)
        got_cf = roi_align.batched_roi_align_backward(
            g_cf, levels, boxes, strides, channels_first=True)
        levels32 = [f.float() for f in levels]
        want = roi_align.batched_roi_align_backward_plain(
            g.float(), levels32, boxes, strides)
        torch.cuda.synchronize()
        err = max(float((x.float() - w).abs().max())
                  for x, w in zip(got, want))
        ok = all(x.dtype == dtype and torch.allclose(x.float(), w, **tol)
                 for x, w in zip(got, want))
        equal_bits = all(torch.equal(x, y) for x, y in zip(got, again))
        same_layouts = all(torch.equal(x, y) for x, y in zip(got, got_cf))
        del got, again, got_cf, want
        ms = time_ms(lambda: roi_align.batched_roi_align_backward(
            g, levels, boxes, strides))
        ms_cf = time_ms(lambda: roi_align.batched_roi_align_backward(
            g_cf, levels, boxes, strides, channels_first=True))
        plain_ms = time_ms(lambda: roi_align.batched_roi_align_backward_plain(
            g.float(), levels32, boxes, strides), reps=10)
        _, fwd_ops, touched = roi_bound(torch, roi_align, levels, boxes,
                                        strides)
        size = levels[0].element_size()
        cells = sum(f.numel() for f in levels)
        reads = g.numel() * g.element_size() + boxes.numel() * 4
        nbytes = reads + cells * size
        per_roi = 2 * 7 * 2 * 8                # sample entries, bytes
        groups = -(-c * size // 512)           # 32 16-byte vectors a block
        units = partial_tiles = 0
        for f in levels:
            n = -(-f.shape[1] // K3_TILE) * -(-f.shape[2] // K3_TILE)
            split = min(max(K3_SPLIT_TARGET // n, 1), K3_MAX_SPLIT)
            units += n * split
            partial_tiles += n * split if split > 1 else 0
        hits = k3_tile_hits(torch, roi_align, levels, boxes, strides)
        partial = b * partial_tiles * K3_TILE * K3_TILE * c * 4
        moved = (b * k * (16 + 4) + b * k * (16 + 4 + per_roi + 8)
                 + b * units * groups * k * 8
                 + hits * (49 * c * size + per_roi * groups)
                 + 2 * partial + cells * size)
        ops = fwd_ops // ROI_OPS_PER_SAMPLE * ROI_BWD_OPS_PER_SAMPLE
        t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / F32_OPS_PER_S
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        rec = {"phase": "kernels", "kernel": "roi_align_bwd",
               "case": f"train_b{b}_k{k}_c{c}_{name}",
               "grad_shape": list(g.shape), "max_abs_err": err,
               "tolerance": tol, "within_tolerance": ok,
               "equal_bits_twice": equal_bits,
               "channels_first_equal_bits": same_layouts, "kernel_ms": ms,
               "kernel_ms_channels_first": ms_cf,
               "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bytes": nbytes, "bytes_moved": moved, "tile_hits": hits,
               "blocks": b * units * groups, "partial_bytes": partial,
               "ops": ops,
               "touched_cells": touched,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        emit(rec)
        if not ok:
            raise AssertionError(f"roi_align_bwd {name}: max abs error {err} "
                                 f"exceeds {tol}")
        if not (equal_bits and same_layouts):
            raise AssertionError(f"roi_align_bwd {name}: two runs, or the "
                                 "two layouts, differ in bits")
        out[name] = {"ms": ms_cf, "plain_ms": plain_ms,
                     "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                     "max_abs_err": err}
    return out["bf16"]


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


def device_profile(torch, run, reps=3, unit="forward"):
    """Device busy share over ``reps`` calls of ``run`` (the union of the
    device activities that ``torch.profiler`` records, over the host wall
    time of the window), the device time of the busiest kernels, and the
    self device time of the busiest operators with their calls per
    ``unit``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # A record_function range also shows on the device's timeline, under
    # the name of its host event; it is not device work.
    host = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.name not in host)
    busy, end = 0.0, float("-inf")
    by_name = {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    ours = {}       # the port's own kernels, by function name
    for name, ms in by_name.items():
        found = re.search(r"\b(roi_\w+|nms_\w+)", name)
        if found:
            ours[found.group(1)] = (ours.get(found.group(1), 0.0)
                                    + ms / 1e3 / reps)
    ops = sorted(((e.key, e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0), key=lambda t: -t[1])[:12]
    return {f"{unit}s": reps, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us if spans else None,
            "device_activities": len(spans),
            f"port_kernels_ms_per_{unit}": ours,
            f"top_kernels_ms_per_{unit}": [
                [name[:160], ms / 1e3 / reps] for name, ms in top],
            f"top_ops_self_device_ms_per_{unit}": [
                [key, us / 1e3 / reps, count // reps]
                for key, us, count in ops]}


def serve_slice(torch, card, dev, cfg, captured):
    from podtpu_torch.infer.server import DetectionServer, make_handler
    from podtpu_torch.models.detector import init_parameters, make_detector
    from podtpu_torch.ops import _build, nms
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
            x = torch.from_numpy(np.stack(images[:4])).cuda()

            def forward():
                with torch.inference_mode():
                    server.model(x)

            prof = device_profile(torch, forward)
            captured.append(("serve", capture_nms(nms, forward)))
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


# -- phases 6 and 7: training -------------------------------------------------

def synthetic_batch(rng, b, size, max_gt, n_gt=(1, 30), side=(16, 256),
                    classes=3):
    """uint8 canvases with 1..30 gt boxes of 16..256 px each, padded to
    ``max_gt`` slots."""
    h, w = size
    boxes = np.zeros((b, max_gt, 4), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    valid = np.zeros((b, max_gt), bool)
    for i in range(b):
        n = int(rng.integers(n_gt[0], n_gt[1] + 1))
        wh = rng.uniform(side[0], side[1], (n, 2))
        xy = rng.uniform(0, 1, (n, 2)) * (np.array([w, h]) - wh)
        boxes[i, :n] = np.concatenate([xy, xy + wh], 1)
        labels[i, :n] = rng.integers(1, classes + 1, n)
        valid[i, :n] = True
    return {"image": rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
            "boxes": boxes, "labels": labels, "valid": valid}


def move(x, dev):
    """A tensor, or a nest of NamedTuples of tensors, moved to ``dev``."""
    if isinstance(x, tuple):
        return type(x)(*(move(v, dev) for v in x))
    return x.to(dev)


# The train step with K3 against the same step with K3's plain version, on
# the card: about five times the largest readings over the six seeds of an
# earlier run (PERF.md; losses equal, gradients within 9.4e-7 of their norm
# and 1.34e-6 of their largest entry, parameters within 1.5e-8).
LIMITS_K3_VS_PLAIN = dict(loss=1e-6, grad_l2=5e-6, grad_max=1e-5, param=1e-7)


def relu_signs(torch):
    """A dispatch mode that keeps the sign of every ReLU input, in call
    order, on the host."""
    from torch.utils._python_dispatch import TorchDispatchMode

    relus = (torch.ops.aten.relu.default, torch.ops.aten.relu_.default)

    class ReluSigns(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.signs = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in relus:
                self.signs.append((args[0] > 0).cpu())
            return func(*args, **(kwargs or {}))

    return ReluSigns()


@contextlib.contextmanager
def plain_k3(torch, mcfg):
    """K3 replaced by its plain version (autograd of the plain forward) on
    the same device, inside the model's RoIAlign autograd function."""
    from podtpu_torch.ops import roi_align

    kernel = roi_align._backward_kernel

    def plain(grad_out, shapes, dtype, boxes, level, strides, out, ratio,
              channels_first):
        feats = [torch.empty(sh, dtype=dtype, device=boxes.device)
                 for sh in shapes]
        return roi_align.batched_roi_align_backward_plain(
            grad_out, feats, boxes, strides, out, ratio,
            canonical_scale=mcfg.roi_canonical_scale,
            canonical_level=mcfg.roi_canonical_level,
            channels_first=channels_first)

    roi_align._backward_kernel = plain
    try:
        yield
    finally:
        roi_align._backward_kernel = kernel


def check_train_reference(torch, dev, seeds=range(SEED, SEED + 6)):
    """One train step of a small float32 model on the CPU (plain versions)
    and twice on the card, with K3 and with K3 swapped for its plain
    version; same weights, batch and draws per seed, TF32 off.  Each line
    counts the ReLU inputs whose sign differs between two runs: float32
    sums taken in another order move values near zero across it, and a
    gradient then passes in one run and not in the other.  At 128x128 a
    deep layer has few positions, so one such input can move a weight
    gradient by percent; the limits against the CPU are five times the
    largest readings over these seeds in an earlier run (PERF.md): losses
    within rtol 1e-4, each gradient within 3e-2 of its norm (relative L2)
    and 1.5e-1 of its largest entry, updated parameters within 2.5e-5.
    The two card runs share their forward, so K3 against its plain
    version is held to LIMITS_K3_VS_PLAIN."""
    from podtpu_torch.core.config import Config, ModelConfig
    from podtpu_torch.models.detector import init_parameters, make_detector
    from podtpu_torch.ops import _build
    from podtpu_torch.train.optim import make_optimizer
    from podtpu_torch.train.step import draw_train, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mcfg = ModelConfig(image_size=(128, 128), rpn_pre_nms_topk_train=128,
                       rpn_post_nms_topk_train=128, box_batch_per_image=32,
                       max_gt_boxes=8, compute_dtype="float32", num_classes=4)
    cfg = Config(model=mcfg)

    def run(seed, batch, draws, device, swap):
        model = make_detector(mcfg)
        init_parameters(model, torch.Generator().manual_seed(seed))
        model = model.to(memory_format=torch.channels_last)
        step = make_train_step(model, make_optimizer(cfg.train, model), cfg,
                               device=device)
        signs = relu_signs(torch)
        _build.reset_launches()
        with (plain_k3(torch, mcfg) if swap else contextlib.nullcontext()):
            with signs:
                metrics = step(batch, 0.005, draws=move(draws, device))
        return ({k: float(v) for k, v in metrics.items()},
                {n: (p.detach().cpu(), p.grad.cpu())
                 for n, p in model.named_parameters() if p.grad is not None},
                signs.signs, _build.launches["roi_align_bwd"])

    def compare(ref, got):
        (lc, pc, sc, _), (lg, pg, sg, k3) = ref, got
        assert len(sc) == len(sg), "ReLU calls differ in number"
        return {
            "loss_max_rel_err": max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12)
                                    for k in lc),
            "grad_max_err_over_tensor_max": max(
                (float((pg[n][1] - g).abs().max() / g.abs().max()), n)
                for n, (_, g) in pc.items()),
            "grad_max_rel_l2_err": max(
                (float((pg[n][1] - g).norm() / g.norm()), n)
                for n, (_, g) in pc.items()),
            "param_max_abs_err": max(float((pg[n][0] - p).abs().max())
                                     for n, (p, _) in pc.items()),
            "relu_sign_flips": sum(int((a != b).sum())
                                   for a, b in zip(sc, sg)),
            "k3_launches": k3, "finite": all(np.isfinite(v)
                                             for v in lg.values())}

    def within(r, limits):
        return (r["loss_max_rel_err"] <= limits["loss"]
                and r["grad_max_rel_l2_err"][0] <= limits["grad_l2"]
                and r["grad_max_err_over_tensor_max"][0] <= limits["grad_max"]
                and r["param_max_abs_err"] <= limits["param"] and r["finite"])

    vs_cpu = dict(loss=1e-4, grad_l2=3e-2, grad_max=1.5e-1, param=2.5e-5)
    bad = []
    for seed in seeds:
        batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
            np.random.default_rng(seed), 2, (128, 128), 8, n_gt=(1, 8),
            side=(8, 48)).items()}
        draws = draw_train(torch.Generator().manual_seed(seed), cfg, batch)
        cpu = run(seed, batch, draws, "cpu", False)
        rec = {"phase": "train_reference", "seed": seed,
               "losses_cpu": cpu[0], "trained_tensors": len(cpu[1]),
               "relu_inputs": sum(x.numel() for x in cpu[2])}
        k3 = run(seed, batch, draws, dev, False)
        plain = run(seed, batch, draws, dev, True)
        rec["k3"] = compare(cpu, k3)
        rec["plain_k3"] = compare(cpu, plain)
        rec["k3_vs_plain_k3"] = compare(plain, k3)
        if not (within(rec["k3"], vs_cpu) and within(rec["plain_k3"], vs_cpu)
                and within(rec["k3_vs_plain_k3"], LIMITS_K3_VS_PLAIN)
                and k3[3] > 0 and plain[3] == 0):
            bad.append(seed)
        emit(rec)
    torch.backends.cudnn.allow_tf32 = True
    if bad:
        raise AssertionError(f"train_reference out of its limits on seeds "
                             f"{bad}")


def train_breakdown(torch, model, optimizer, cfg, batch, gen, reps=5):
    """Median CUDA-event milliseconds of each part of the train step
    (draws and augmentation, forward and losses, backward, optimiser),
    between events recorded where ``make_train_step``'s ``mark`` hook says
    each part begins."""
    from podtpu_torch.train.step import make_train_step

    events = []

    def mark(part):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((part, ev))

    step = make_train_step(model, optimizer, cfg,
                           device=next(model.parameters()).device, mark=mark)
    times = {}
    for _ in range(reps):
        events.clear()
        step(batch, cfg.train.lr, generator=gen)
        events[-1][1].synchronize()
        for (part, start), (_, end) in zip(events, events[1:]):
            times.setdefault(part, []).append(start.elapsed_time(end))
    return {p: statistics.median(v) for p, v in times.items()}


def train_slice(torch, card, dev, captured):
    from podtpu_torch.core.config import Config, ModelConfig
    from podtpu_torch.infer.inference import load_inference_model
    from podtpu_torch.models.detector import init_parameters, make_detector
    from podtpu_torch.ops import _build, nms
    from podtpu_torch.train.checkpoints import save_labels, save_model
    from podtpu_torch.train.optim import make_optimizer
    from podtpu_torch.train.step import make_train_step

    cfg = Config(model=ModelConfig(num_classes=4))
    labels = ["radiolarian", "foraminifera", "diatom"]
    model = make_detector(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(SEED))
    model = model.to(memory_format=torch.channels_last)
    optimizer = make_optimizer(cfg.train, model)
    step = make_train_step(model, optimizer, cfg, device=dev)
    rng = np.random.default_rng(SEED)
    batches = [synthetic_batch(rng, cfg.train.batch_size,
                               cfg.model.image_size, cfg.model.max_gt_boxes)
               for _ in range(4)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lr = cfg.train.lr
    warmup, timed = 3, 20
    t0 = time.perf_counter()
    for i in range(warmup):
        m = step(batches[i % len(batches)], lr, generator=gen)
        assert all(np.isfinite(float(v)) for v in m.values()), m
    warm_s = time.perf_counter() - t0
    kernels = ("nms", "roi_align_fwd", "roi_align_bwd")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    step_s, losses = [], []
    t_all = time.perf_counter()
    for i in range(timed):
        before = {k: _build.launches[k] for k in kernels}
        t0 = time.perf_counter()
        m = step(batches[i % len(batches)], lr, generator=gen)
        vals = {k: float(v) for k, v in m.items()}  # waits for the step
        step_s.append(time.perf_counter() - t0)
        losses.append(vals)
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"step {i}: loss not finite: {vals}")
        missing = [k for k in kernels if _build.launches[k] <= before[k]]
        if missing:
            raise AssertionError(f"step {i}: {missing} not launched")
    wall = time.perf_counter() - t_all
    launches = {k: _build.launches[k] for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lat = sorted(step_s)
    rec = {"phase": "train", "model": "faster_rcnn_resnet50_fpn",
           "image_size": list(cfg.model.image_size),
           "compute_dtype": cfg.model.compute_dtype,
           "batch_size": cfg.train.batch_size,
           "optimiser": cfg.train.optimiser, "lr": lr,
           "aug_policy": cfg.data.aug_policy,
           "gt_boxes": [int(b["valid"].sum()) for b in batches],
           "warmup_steps": warmup, "warmup_s": warm_s, "steps": timed,
           "wall_s": wall,
           "images_per_s": timed * cfg.train.batch_size / wall,
           "step_ms_p50": statistics.median(lat) * 1e3,
           "step_ms_max": lat[-1] * 1e3,
           "loss_first": losses[0], "loss_last": losses[-1],
           "peak_memory_gib": peak, "launches": launches,
           "launches_per_step": {k: v / timed for k, v in launches.items()},
           "card": card}

    # The trained weights as a model directory, served one batch.
    with tempfile.TemporaryDirectory() as model_dir:
        save_model(model_dir, model, cfg.model, labels)
        save_labels(model_dir, labels)
        forward, served, _, got_labels = load_inference_model(model_dir,
                                                              device=dev)
        det = forward(batches[0]["image"])
        torch.cuda.synchronize()
    assert got_labels == labels
    assert det.boxes.shape == (cfg.train.batch_size,
                               cfg.model.detections_per_image, 4)
    assert bool(torch.isfinite(det.boxes).all()) and \
        bool(torch.isfinite(det.scores).all())
    same = all(torch.equal(a, b) for a, b in zip(
        served.state_dict().values(), model.state_dict().values()))
    if not same:
        raise AssertionError("the served model's weights differ from the "
                             "trained ones")
    rec["served_detections"] = int(det.valid.sum())
    emit(rec)
    del served, forward, det

    parts = train_breakdown(torch, model, optimizer, cfg, batches[0], gen)
    prof = device_profile(
        torch, lambda: step(batches[0], lr, generator=gen), reps=3,
        unit="step")
    emit({"phase": "train_breakdown", "batch_size": cfg.train.batch_size,
          "parts_ms": parts, "profile": prof, "card": card})
    captured.append(("train", capture_nms(
        nms, lambda: step(batches[0], lr, generator=gen))))
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
                    if "registers" in ln or "spill" in ln
                    or "entry function" in ln]})

    from podtpu_torch.core.config import ModelConfig

    nms_rec = check_nms(torch, nms, "cuda")
    roi_rec = check_roi_align(torch, roi_align, "cuda")
    check_roi_align(torch, roi_align, "cuda", b=TRAIN_B, k=TRAIN_K,
                    seed=SEED + 3, case="train_b2_k512_c256_bf16")
    bwd_rec = check_roi_align_bwd(torch, roi_align, "cuda")
    check_roi_align_cases(torch, roi_align, "cuda")
    check_reference(torch, "cuda")
    captured = []
    serve = serve_slice(torch, card, "cuda", ModelConfig(num_classes=4),
                        captured)
    check_train_reference(torch, "cuda")
    train = train_slice(torch, card, "cuda", captured)
    check_nms_main_path(torch, nms, captured)

    def launches(name):
        by_path = {"serve": serve.get(name, 0), "train": train.get(name, 0)}
        return dict(launches=sum(by_path.values()),
                    launches_by_path={k: v for k, v in by_path.items() if v})

    kernels = [
        dict(name="nms", route="cuda", source="podtpu_torch/csrc/nms.cu",
             replaces="podtpu/ops/pallas/nms_kernel.py:46",
             **launches("nms"), max_abs_err=nms_rec["max_abs_err"],
             ms=nms_rec["ms"], plain_ms=nms_rec["plain_ms"],
             bound_ms=nms_rec["bound_ms"], bound_by=nms_rec["bound_by"],
             library_ms=None),
        dict(name="roi_align_fwd", route="cuda",
             source="podtpu_torch/csrc/roi_align.cu",
             replaces="podtpu/ops/pallas/roi_align_kernel.py:157",
             **launches("roi_align_fwd"),
             max_abs_err=roi_rec["max_abs_err"], ms=roi_rec["ms"],
             plain_ms=roi_rec["plain_ms"], bound_ms=roi_rec["bound_ms"],
             bound_by=roi_rec["bound_by"], library_ms=None),
        dict(name="roi_align_bwd", route="cuda",
             source="podtpu_torch/csrc/roi_align.cu",
             replaces="podtpu/ops/pallas/roi_align_kernel.py:226",
             **launches("roi_align_bwd"),
             max_abs_err=bwd_rec["max_abs_err"], ms=bwd_rec["ms"],
             plain_ms=bwd_rec["plain_ms"], bound_ms=bwd_rec["bound_ms"],
             bound_by=bwd_rec["bound_by"], library_ms=None),
    ]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
