"""Metric smoothing + periodic progress logging.

Counterpart of the reference's ``SmoothedValue`` / ``MetricLogger``
(`miso/object_detection/engine/utils.py:11-204`): windowed median/avg/global
averages, periodic line printing with iteration time, data-loading time and
ETA.  Counterpart of ``podtpu/core/logging.py``.  The port runs one
process on one GPU, so every process is the main one; data parallelism
(ROADMAP.md, item 18) will gate printing on the rank.
"""
from __future__ import annotations

import collections
import datetime
import time
from typing import Dict, Iterable, Optional


def is_main_process() -> bool:
    return True


class SmoothedValue:
    """Track a series with a sliding window and a global average."""

    def __init__(self, window: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self._window = collections.deque(maxlen=window)
        self._total = 0.0
        self._count = 0
        self._fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self._window.append(float(value))
        self._total += float(value) * n
        self._count += n

    @property
    def median(self) -> float:
        if not self._window:
            return 0.0
        s = sorted(self._window)
        return s[len(s) // 2]

    @property
    def avg(self) -> float:
        return sum(self._window) / max(len(self._window), 1)

    @property
    def global_avg(self) -> float:
        return self._total / max(self._count, 1)

    @property
    def value(self) -> float:
        return self._window[-1] if self._window else 0.0

    def __str__(self) -> str:
        return self._fmt.format(median=self.median, avg=self.avg,
                                global_avg=self.global_avg, value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(
            SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, name: str) -> SmoothedValue:
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: Optional[int] = None):
        """Yield from ``iterable`` printing progress every ``print_freq``."""
        n = total if total is not None else len(iterable)  # type: ignore
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        start = time.time()
        end = start
        for i, obj in enumerate(iterable):
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            end = time.time()
            if (i % print_freq == 0 or i == n - 1) and is_main_process():
                eta = datetime.timedelta(
                    seconds=int(iter_time.avg * (n - i - 1)))
                print(f"{header} [{i}/{n}] eta: {eta} {self} "
                      f"time: {iter_time} data: {data_time}")
        if is_main_process():
            elapsed = datetime.timedelta(seconds=int(time.time() - start))
            per_it = (time.time() - start) / max(n, 1)
            print(f"{header} Total time: {elapsed} ({per_it:.4f} s / it)")
