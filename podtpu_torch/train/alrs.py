"""Adaptive learning-rate scheduler with early stopping.

Behavioral parity with the reference's ALRS
(`miso/shared/learning_rate_scheduler.py:5-112`), the convergence criterion
of its training loop (`miso/object_detection/training.py:109-127`):

* keep a rolling buffer of the last ``nb_epochs`` epoch losses;
* after a warmup of ``startup_delay_factor * nb_epochs`` epochs, fit a linear
  regression to the buffer and compute P(slope < 0) from a normal
  distribution over the slope estimate (slope std-error from the residual
  variance, ``sqrt(var * 12 / (n^3 - n))``);
* when the buffer is full and P(loss still decreasing) < 0.5, multiply the
  LR by ``factor`` (0.5) and clear the buffer;
* training FINISHES after ``nb_drops`` (default 4) reductions.

This version is framework-agnostic: it tracks the LR value itself and the
train step reads ``scheduler.lr`` — no optimizer mutation (the JAX optimizer
gets the LR injected per step).  State is a plain dict so it checkpoints
alongside params (the reference has no mid-training checkpoints to carry ALRS
state; we do — SURVEY.md §5 checkpoint/resume).

Counterpart of ``podtpu/train/alrs.py``, with the same semantics.
"""
from __future__ import annotations

import math
from typing import List


def slope_probability_less_than(values: List[float], prob: float = 0.0) -> float:
    """P(regression slope over ``values`` < ``prob``), normal approximation.

    Mirrors the reference's statistic exactly (linear fit on indices
    0..n-1; slope std error ``sqrt(residual_var * 12 / (n^3 - n))``;
    returns 1 when fewer than 3 points).
    """
    n = len(values)
    if n < 3:
        return 1.0
    xs = list(range(n))
    mean_x = (n - 1) / 2.0
    mean_y = sum(values) / n
    sxx = sum((x - mean_x) ** 2 for x in xs)          # = (n^3 - n) / 12
    sxy = sum((x - mean_x) * (y - mean_y) for x, y in zip(xs, values))
    slope = sxy / sxx
    intercept = mean_y - slope * mean_x
    residual_var = sum((slope * x + intercept - y) ** 2
                       for x, y in zip(xs, values)) / (n - 2)
    slope_std_err = math.sqrt(residual_var * (12.0 / (n ** 3 - n)))
    if slope_std_err == 0:
        return 0.0 if slope >= prob else 1.0
    z = (prob - slope) / (slope_std_err * math.sqrt(2.0))
    return 0.5 * (1.0 + math.erf(z))


class RollingBuffer:
    """Fixed-capacity ring of the most recent losses."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._items: List[float] = []

    def append(self, value: float) -> None:
        self._items.append(float(value))
        if len(self._items) > self.capacity:
            self._items.pop(0)

    def values(self) -> List[float]:
        return list(self._items)

    def clear(self) -> None:
        self._items = []

    def full(self) -> bool:
        return len(self._items) == self.capacity

    def __len__(self) -> int:
        return len(self._items)


class AdaptiveLearningRateScheduler:
    def __init__(self,
                 base_lr: float,
                 factor: float = 0.5,
                 nb_drops: int = 4,
                 nb_epochs: int = 10,
                 startup_delay_factor: int = 2,
                 verbose: bool = True):
        self.base_lr = base_lr
        self.factor = factor
        self.nb_drops = nb_drops
        self.nb_epochs = nb_epochs
        self.startup_delay_factor = startup_delay_factor
        self.verbose = verbose
        self.drop_count = 0
        self.buffer = RollingBuffer(nb_epochs)
        self.finished = False

    @property
    def lr(self) -> float:
        return self.base_lr * (self.factor ** self.drop_count)

    def lr_for(self, epoch: int) -> float:
        """Scheduler-protocol accessor (see schedules.py):
        ALRS's LR depends on drop count, not the epoch index."""
        return self.lr

    def step(self, epoch: int, loss: float) -> bool:
        """Record an epoch loss; returns True when training should stop."""
        if self._needs_drop(epoch, loss):
            self.drop_count += 1
            self.buffer.clear()
            if self.verbose:
                print(f"Epoch {epoch:05d}: reducing learning rate to "
                      f"{self.lr:.4e} (drop {self.drop_count}/{self.nb_drops})")
        self.finished = self.drop_count >= self.nb_drops
        return self.finished

    def _needs_drop(self, epoch: int, loss: float) -> bool:
        self.buffer.append(loss)
        if epoch < self.startup_delay_factor * self.nb_epochs:
            if self.verbose:
                print(f"Epoch: [{epoch}]  loss: {loss:04f}, warmup")
            return False
        prob = slope_probability_less_than(self.buffer.values(), 0.0)
        if self.verbose:
            print(f"Epoch: [{epoch}]  phase: {self.drop_count}, "
                  f"loss: {loss:04f}, prob: {prob:04f}, "
                  f"buffer full? {self.buffer.full()}")
        return self.buffer.full() and prob < 0.50

    def exhausted(self, epoch: int) -> bool:
        """Scheduler-protocol: True when no further training epoch should
        run (a resumed checkpoint whose run already early-stopped)."""
        return self.finished

    # -- checkpointable state ------------------------------------------------
    def state_dict(self) -> dict:
        return {"schedule": "alrs",
                "drop_count": self.drop_count,
                "buffer": self.buffer.values(),
                "finished": self.finished}

    def load_state_dict(self, state: dict) -> None:
        kind = state.get("schedule", "alrs")
        if kind != "alrs":
            raise ValueError(
                f"checkpoint was saved with --lr-schedule {kind!r}; resume "
                f"with the same schedule (got 'alrs')")
        self.drop_count = int(state["drop_count"])
        self.buffer.clear()
        for v in state["buffer"]:
            self.buffer.append(v)
        self.finished = bool(state["finished"])
