#!/usr/bin/env python3
"""Probe of the port's NMS kernel (K1) on one NVIDIA GPU, for tuning.

Run from the repository root on a machine with a CUDA GPU and ``nvcc``:

    python3 tools/torch_nms_probe.py [-DMACRO=VALUE ...] [MODE ...]

Each ``-D`` is passed to ``nvcc`` and the build goes to a directory of its
own.  Modes (default: cases prof host):

- ``cases``: ``chip_smoke.py``'s checks of K1 against its plain version,
  with the wrapper's CUDA-event times;
- ``prof``: the device time of each kernel function alone (``nms_*``, from
  ``torch.profiler``), per call of ``nms_keep_batched`` on score-sorted
  boxes, for every case of ``chip_smoke.nms_cases``;
- ``host``: per call of the wrapper, the host's enqueue time, the time with
  a synchronise, and the CUDA-event time, at the serving RPN case.

Only ``nms_keep_batched(sorted_boxes, valid, threshold)`` is called, so the
script also runs against a checkout whose kernel takes no ``order``.
"""
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import chip_smoke as smoke
from podtpu_torch.ops import _build, nms


def cases():
    for name, b, v, t in smoke.nms_cases(np.random.default_rng(smoke.SEED)):
        yield name, torch.from_numpy(b).cuda(), torch.from_numpy(v).cuda(), t


def profile_kernels(reps=5):
    from torch.profiler import ProfilerActivity, profile

    for name, boxes, valid, t in cases():
        for _ in range(3):
            nms.nms_keep_batched(boxes, valid, t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                nms.nms_keep_batched(boxes, valid, t)
            torch.cuda.synchronize()
        rows = {e.key[:40]: e.self_device_time_total / reps
                for e in prof.key_averages()
                if e.self_device_time_total > 0 and "nms_" in e.key}
        print("PROFILE", json.dumps({"case": name,
                                     "shape": list(boxes.shape),
                                     "device_us_per_call": rows}),
              flush=True)


def host_times(reps=50):
    """Host time of the wrapper and of its parts, at the serving RPN case."""
    name, boxes, valid, t = next(cases())
    s, n = valid.shape
    lib = _build.library()
    dev = boxes.device

    def stream():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream().cuda_stream

    parts = {
        "wrapper": lambda: nms.nms_keep_batched(boxes, valid, t),
        "allocation": lambda: torch.empty(s * 20000, dtype=torch.int64,
                                          device=dev),
        "device_and_stream": stream,
        "stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "library_lock": _build.library,
    }
    if hasattr(lib, "podtpu_nms_scratch_words"):
        keep = torch.empty((s, n), dtype=torch.bool, device=dev)
        scratch = torch.empty((s, lib.podtpu_nms_scratch_words(n)),
                              dtype=torch.int64, device=dev)
        st = stream()
        parts["checks"] = lambda: nms._check_kernel_inputs(boxes, valid, None)
        parts["c_entry_point"] = lambda: lib.podtpu_nms_keep(
            boxes.data_ptr(), valid.data_ptr(), None, scratch.data_ptr(),
            keep.data_ptr(), s, n, float(t), dev.index, st)
    for part, fn in parts.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
        synced = (time.perf_counter() - t0) / reps * 1e3
        print("HOST", json.dumps({"case": name, "part": part,
                                  "enqueue_ms": enqueue,
                                  "with_sync_ms": synced}), flush=True)
    print("HOST", json.dumps({"case": name, "event_ms": smoke.time_ms(
        parts["wrapper"])}), flush=True)


def main():
    defines = [a for a in sys.argv[1:] if a.startswith("-D")]
    modes = [a for a in sys.argv[1:] if not a.startswith("-D")] \
        or ["cases", "prof", "host"]
    if defines:
        _build.NVCC_FLAGS += defines
        _build.BUILD_DIR = _build.BUILD_DIR / "_".join(
            d[2:].replace("=", "") for d in defines)
    print("VARIANT", defines, smoke.card_line(), flush=True)
    t0 = time.perf_counter()
    _build.library()
    log = (_build.BUILD_DIR / "nvcc.log").read_text()
    print("\n".join(ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "entry function" in ln), flush=True)
    print("build_s", time.perf_counter() - t0, flush=True)
    if "prof" in modes:
        profile_kernels()
    if "host" in modes:
        host_times()
    if "cases" in modes:
        smoke.check_nms(torch, nms, "cuda")


if __name__ == "__main__":
    main()
