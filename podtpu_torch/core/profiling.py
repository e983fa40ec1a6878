"""Profiling and tracing hooks.

Counterpart of ``podtpu/core/profiling.py``:

* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace into ``PODTPU_TRACE_DIR`` (or the path passed), and
  :func:`start_trace` / :func:`stop_trace`, the same as a pair of calls
  (``train()`` traces a window of dispatches with them);
* :func:`annotate`: a named span (``torch.profiler.record_function``) for
  host-side phases;
* :class:`StepTimer`: wall-clock step latencies with percentile summaries
  (p50/p90), the JAX package's rule;
* :func:`slope_time`: seconds per iteration by the slope method (run
  ``iters[0]`` and ``iters[1]`` iterations, divide the difference), which
  cancels the fixed cost of a run; a run is forced with
  ``torch.cuda.synchronize``.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import torch


def _force() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def slope_time(fn, iters=(2, 12), reps=2) -> float:
    """Seconds per iteration of ``fn`` by the slope method.

    ``fn(i)`` is called with the iteration index; each run ends with
    ``torch.cuda.synchronize`` (when a GPU is present), so its device work
    is done.  Timing = min over ``reps`` of ``(t[iters[1]] - t[iters[0]])
    / (iters[1] - iters[0])``.
    """
    def run(n):
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        _force()
        return time.perf_counter() - t0

    run(1)  # first call: kernel builds, allocations
    t_short = min(run(iters[0]) for _ in range(reps))
    t_long = min(run(iters[1]) for _ in range(reps))
    return max((t_long - t_short) / (iters[1] - iters[0]), 1e-9)


def start_trace(device=None):
    """Start recording host activity with ``torch.profiler``, and device
    activity when ``device`` is a GPU (when None: when there is one);
    returns the profiler for :func:`stop_trace`."""
    from torch.profiler import ProfilerActivity, profile

    gpu = torch.device(device).type == "cuda" if device is not None \
        else torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if gpu:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, log_dir: str) -> None:
    """Stop ``prof`` and write its Chrome trace to ``log_dir/trace.json``."""
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[podtpu] profiler trace written to {path}")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Record host and device activity with ``torch.profiler`` if a log
    directory is configured, and write ``trace.json`` there."""
    log_dir = log_dir or os.environ.get("PODTPU_TRACE_DIR")
    if not log_dir:
        yield
        return
    prof = start_trace()
    try:
        yield
        _force()
    finally:
        stop_trace(prof, log_dir)


def annotate(name: str):
    """Named span visible in profiler traces."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step latencies with percentile summaries."""

    def __init__(self, skip_first: int = 3):
        self.skip_first = skip_first
        self._all: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._all.append(time.perf_counter() - self._t0)

    @property
    def steady(self) -> List[float]:
        return self._all[self.skip_first:] if len(self._all) > self.skip_first \
            else self._all

    def percentile(self, q: float) -> float:
        xs = sorted(self.steady)
        if not xs:
            return 0.0
        idx = min(int(q / 100.0 * len(xs)), len(xs) - 1)
        return xs[idx]

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p90(self) -> float:
        return self.percentile(90)

    def summary(self, unit_per_step: float = 1.0, unit: str = "items") -> str:
        p50 = self.p50
        rate = unit_per_step / p50 if p50 > 0 else 0.0
        return (f"p50 {p50 * 1000:.1f} ms, p90 {self.p90 * 1000:.1f} ms, "
                f"{rate:.1f} {unit}/s")
