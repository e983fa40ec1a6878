"""Fixed epoch-budget LR schedules (vendored-trainer parity).

The reference's miso path steers the LR with ALRS early stopping
(`miso/shared/learning_rate_scheduler.py`), but its vendored multi-GPU
trainer exposes torch ``MultiStepLR`` and ``CosineAnnealingLR`` over a fixed
epoch budget (`miso/object_detection/engine/train.py:254-262`, defaults
``--epochs 26 --lr-steps 16 22 --lr-gamma 0.1``).  These are their
equivalents: pure functions of the epoch index (nothing to checkpoint — a
resumed run recomputes the LR from the restored epoch), sharing the ALRS
protocol the training loop drives:

* ``lr_for(epoch)`` — the LR to use during ``epoch``;
* ``step(epoch, loss) -> bool`` — record the epoch; True = stop training;
* ``state_dict()`` / ``load_state_dict()`` — checkpointable state.

Counterpart of ``podtpu/train/schedules.py``.
"""
from __future__ import annotations

import math
from typing import Sequence

from podtpu_torch.train.alrs import AdaptiveLearningRateScheduler


class MultiStepScheduler:
    """torch ``MultiStepLR`` semantics: ``lr = base * gamma^k`` where ``k``
    counts milestones <= epoch; training stops after ``epochs`` epochs."""

    def __init__(self, base_lr: float, epochs: int,
                 steps: Sequence[int] = (16, 22), gamma: float = 0.1):
        self.base_lr = base_lr
        self.epochs = epochs
        self.steps = tuple(sorted(int(s) for s in steps))
        self.gamma = gamma

    def lr_for(self, epoch: int) -> float:
        k = sum(1 for s in self.steps if epoch >= s)
        return self.base_lr * (self.gamma ** k)

    def step(self, epoch: int, loss: float) -> bool:
        return epoch + 1 >= self.epochs

    def exhausted(self, epoch: int) -> bool:
        """True when the fixed budget is already spent (a resumed run whose
        checkpoint is the final epoch must train ZERO further epochs — torch's
        ``range(start_epoch, epochs)`` semantics)."""
        return epoch >= self.epochs

    def state_dict(self) -> dict:
        return {"schedule": "multistep"}

    def load_state_dict(self, state: dict) -> None:
        _check_schedule_kind(state, "multistep")


class CosineScheduler:
    """torch ``CosineAnnealingLR(T_max=epochs)`` semantics:
    ``lr(e) = base * (1 + cos(pi * e / epochs)) / 2``; stops after
    ``epochs`` epochs."""

    def __init__(self, base_lr: float, epochs: int):
        self.base_lr = base_lr
        self.epochs = max(1, epochs)

    def lr_for(self, epoch: int) -> float:
        return self.base_lr * 0.5 * (
            1.0 + math.cos(math.pi * epoch / self.epochs))

    def step(self, epoch: int, loss: float) -> bool:
        return epoch + 1 >= self.epochs

    def exhausted(self, epoch: int) -> bool:
        return epoch >= self.epochs

    def state_dict(self) -> dict:
        return {"schedule": "cosine"}

    def load_state_dict(self, state: dict) -> None:
        _check_schedule_kind(state, "cosine")


def _check_schedule_kind(state: dict, expect: str) -> None:
    """Reject resuming a checkpoint under a different --lr-schedule: an ALRS
    state under multistep would silently discard the drop/buffer state, and a
    multistep state under alrs would KeyError deep in load_state_dict."""
    kind = state.get("schedule")
    if kind is None:
        # Legacy ALRS checkpoints carried no tag but do carry drop_count.
        kind = "alrs" if "drop_count" in state else expect
    if kind != expect:
        raise ValueError(
            f"checkpoint was saved with --lr-schedule {kind!r}; resume with "
            f"the same schedule (got {expect!r})")


def make_scheduler(train_cfg, base_lr: float):
    """Scheduler factory from ``TrainConfig`` fields.

    ``lr_schedule='alrs'`` (default) keeps the reference miso path's
    adaptive early stopping; ``'multistep'`` / ``'cosine'`` run the vendored
    trainer's fixed ``epochs`` budget.
    """
    kind = train_cfg.lr_schedule
    if kind == "alrs":
        return AdaptiveLearningRateScheduler(
            base_lr, factor=train_cfg.alrs_factor,
            nb_drops=train_cfg.alrs_drops, nb_epochs=train_cfg.alrs_epochs,
            startup_delay_factor=train_cfg.alrs_startup_factor)
    if kind == "multistep":
        return MultiStepScheduler(base_lr, epochs=train_cfg.epochs,
                                  steps=train_cfg.lr_steps,
                                  gamma=train_cfg.lr_gamma)
    if kind == "cosine":
        return CosineScheduler(base_lr, epochs=train_cfg.epochs)
    raise ValueError(
        f"lr_schedule must be 'alrs', 'multistep' or 'cosine' (got {kind!r})")
