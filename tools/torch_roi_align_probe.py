#!/usr/bin/env python3
"""Probe of the port's RoIAlign kernels on one NVIDIA GPU, for tuning.

Run from the repository root on a machine with a CUDA GPU and ``nvcc``:

    python3 tools/torch_roi_align_probe.py [-DMACRO=VALUE ...] [MODE ...]

Each ``-D`` is passed to ``nvcc`` and the build goes to a directory of its
own, so variants of ``podtpu_torch/csrc/roi_align.cu`` that differ in a
macro can be compared in one run of a machine.  Modes (default: cases fwd bwd):

- ``cases``, ``fwd``, ``bwd``: ``chip_smoke.py``'s checks of K2 and K3
  against their plain versions, with the wrappers' CUDA-event times;
- ``prof``: the device time of each kernel function alone, from
  ``torch.profiler``, at the serving shape and twice at the training shape
  (forward and backward in turn, channels first, bf16);
- ``host``: per call of each wrapper and of ``assign_levels``, the host's
  enqueue time, the time with a synchronise, and the CUDA-event time;
- ``levels``: ``roi_level_kernel`` against ``assign_levels`` on 160,000
  boxes.
"""
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import chip_smoke as smoke
from podtpu_torch.ops import _build, roi_align

STRIDES = (4, 8, 16, 32)
KEEP = ("kernel", "case", "kernel_ms", "kernel_ms_channels_first",
        "max_abs_err", "within_tolerance", "equal_bits_twice", "fwd_ok",
        "bwd_ok", "bwd_equal_bits", "bytes_moved", "tile_hits",
        "level_mismatches")


def inputs(b, k, seed):
    gen = torch.Generator(device="cuda").manual_seed(0)
    levels = smoke.random_levels(torch, "cuda", gen, b, 256, 1024, STRIDES)
    boxes = torch.from_numpy(smoke.roi_boxes(
        np.random.default_rng(seed), b, k, 1024.0)).cuda()
    grad = torch.randn((b, k, 256, 7, 7), device="cuda",
                       generator=gen).bfloat16()
    return levels, boxes, grad


def profile_kernels():
    from torch.profiler import ProfilerActivity, profile

    for b, k, seed in ((4, 1000, 1), (2, 512, 3), (2, 512, 2)):
        levels, boxes, grad = inputs(b, k, seed)

        def run():
            roi_align.batched_roi_align(levels, boxes, STRIDES,
                                        channels_first=True)
            roi_align.batched_roi_align_backward(
                grad, levels, boxes, STRIDES, channels_first=True)

        for _ in range(3):
            run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                run()
            torch.cuda.synchronize()
        rows = sorted(((e.key[:70], e.self_device_time_total / 5)
                       for e in prof.key_averages()
                       if e.self_device_time_total > 0 and "roi_" in e.key),
                      key=lambda r: -r[1])
        print("PROFILE", b, k, "device_us_per_call", json.dumps(rows),
              flush=True)


def host_times():
    levels, boxes, grad = inputs(2, 512, 2)
    calls = {
        "bwd": lambda: roi_align.batched_roi_align_backward(
            grad, levels, boxes, STRIDES, channels_first=True),
        "fwd": lambda: roi_align.batched_roi_align(
            levels, boxes, STRIDES, channels_first=True),
        "assign_levels": lambda: roi_align.assign_levels(
            boxes, 4, base_stride=4.0),
        "check_inputs": lambda: roi_align._check_inputs(
            levels, boxes, STRIDES, 7, 2),
    }
    for name, fn in calls.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        enqueue = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        synced = (time.perf_counter() - t0) / 50 * 1e3
        print("HOST", name, "enqueue_ms", enqueue, "with_sync_ms", synced,
              "event_ms", smoke.time_ms(fn), flush=True)


def level_mismatches():
    bad = 0
    for seed in range(20):
        boxes = torch.from_numpy(smoke.roi_boxes(
            np.random.default_rng(seed), 4, 1000, 1024.0)).cuda()
        for scale in (224.0, 56.0):
            want = roi_align.assign_levels(boxes, 4, canonical_scale=scale,
                                           base_stride=4.0)
            got = roi_align._assign_levels_kernel(boxes, 4, scale, 4, 2, 4.0)
            bad += int((want != got).sum())
    print("LEVELS mismatches", bad, flush=True)


def main():
    defines = [a for a in sys.argv[1:] if a.startswith("-D")]
    modes = [a for a in sys.argv[1:] if not a.startswith("-D")] \
        or ["cases", "fwd", "bwd"]
    if defines:
        _build.NVCC_FLAGS += defines
        _build.BUILD_DIR = _build.BUILD_DIR / "_".join(
            d[2:].replace("=", "") for d in defines)
    print("VARIANT", defines, smoke.card_line(), flush=True)
    t0 = time.perf_counter()
    _build.library()
    log = (_build.BUILD_DIR / "nvcc.log").read_text()
    print("\n".join(ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln), flush=True)
    print("build_s", time.perf_counter() - t0, flush=True)
    smoke.emit = lambda rec: print(json.dumps(
        {k: v for k, v in rec.items() if k in KEEP}), flush=True)
    if "levels" in modes:
        level_mismatches()
    if "cases" in modes:
        smoke.check_roi_align_cases(torch, roi_align, "cuda")
    if "fwd" in modes:
        smoke.check_roi_align(torch, roi_align, "cuda")
        smoke.check_roi_align(torch, roi_align, "cuda", b=smoke.TRAIN_B,
                              k=smoke.TRAIN_K, seed=smoke.SEED + 3,
                              case="train_b2_k512_c256_bf16")
    if "bwd" in modes:
        smoke.check_roi_align_bwd(torch, roi_align, "cuda")
    if "prof" in modes:
        profile_kernels()
    if "host" in modes:
        host_times()


if __name__ == "__main__":
    main()
