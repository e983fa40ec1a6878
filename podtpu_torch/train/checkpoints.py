"""Model directories and mid-training checkpoints.

Counterpart of ``podtpu/train/checkpoints.py``.  A model directory is in
the JAX package's format, so one written by either package loads in the
other: ``model.msgpack`` holds the flax ``params`` and ``frozen`` trees
(written and read by :mod:`podtpu_torch.shared.msgpack`), ``config.json``
the model configuration and the label names, beside ``labels.txt`` and
``results.txt``.

The per-epoch resume checkpoint is the port's own: ``checkpoint.pt``
(``torch.save``) with the model's and the optimiser's ``state_dict``, the
step and epoch, the scheduler state and the model configuration.  The JAX
package's ``checkpoint.pkl`` holds optax state, which does not translate; a
directory that has only that file cannot be resumed here.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import torch

from podtpu_torch.core.config import ModelConfig, model_config_from_dict
from podtpu_torch.models.weights import flax_from_state_dict
from podtpu_torch.shared import msgpack


def save_model(out_dir: str, model, model_cfg: ModelConfig, labels) -> None:
    """Write ``model`` (a port detector) as a model directory."""
    os.makedirs(out_dir, exist_ok=True)
    params, frozen = flax_from_state_dict(model.state_dict(),
                                          model_cfg.roi_pool_size)
    with open(os.path.join(out_dir, "model.msgpack"), "wb") as fp:
        fp.write(msgpack.packb({"params": params, "frozen": frozen}))
    with open(os.path.join(out_dir, "config.json"), "w") as fp:
        json.dump({"model": dataclasses.asdict(model_cfg),
                   "labels": list(labels)}, fp, indent=2)


def load_model(model_dir: str) -> Tuple[Dict, Dict, ModelConfig, list]:
    """``(params, frozen, model_cfg, labels)`` with numpy-array trees."""
    with open(os.path.join(model_dir, "config.json")) as fp:
        meta = json.load(fp)
    model_cfg = model_config_from_dict(meta["model"])
    with open(os.path.join(model_dir, "model.msgpack"), "rb") as fp:
        payload = msgpack.unpackb(fp.read())
    return payload["params"], payload["frozen"], model_cfg, meta["labels"]


def save_labels(out_dir: str, labels) -> None:
    """``labels.txt`` in the ``idx,name`` format (1-based)."""
    with open(os.path.join(out_dir, "labels.txt"), "w") as fp:
        for idx, label in enumerate(labels):
            fp.write(f"{idx + 1},{label}\n")


def read_labels(path: str) -> list:
    labels = []
    with open(path) as fp:
        for line in fp.readlines():
            parts = line.split(",")
            if len(parts) > 1:
                labels.append(parts[1].strip())
    return labels


def save_results(out_dir: str, stats, stat_names,
                 filename: str = "results.txt") -> None:
    """``results.txt`` with the reference's 12-stat block."""
    with open(os.path.join(out_dir, filename), "w") as fp:
        for name, stat in zip(stat_names, stats):
            fp.write(f"{name} = {stat:.3f}\n")


# -- mid-training checkpoints -------------------------------------------------

CHECKPOINT = "checkpoint.pt"


def save_train_checkpoint(out_dir: str, model, optimizer, step: int,
                          epoch: int, alrs_state: Dict,
                          model_cfg: Optional[ModelConfig] = None) -> None:
    """Write ``checkpoint.pt`` atomically (a temporary file, then a
    rename)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, CHECKPOINT)
    payload = {"model": model.state_dict(),
               "optimizer": optimizer.state_dict(),
               "step": int(step), "epoch": int(epoch), "alrs": alrs_state}
    if model_cfg is not None:
        # Resume rebuilds the exact architecture from this, not from the
        # resuming call's arguments (see train.py).
        payload["model_cfg"] = dataclasses.asdict(model_cfg)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_train_checkpoint(out_dir: str) -> Optional[Dict]:
    """The checkpoint's payload (tensors on the CPU), or None when the
    directory has none.  Raises when it has only the JAX package's
    ``checkpoint.pkl``."""
    path = os.path.join(out_dir, CHECKPOINT)
    if not os.path.exists(path):
        if os.path.exists(os.path.join(out_dir, "checkpoint.pkl")):
            raise ValueError(
                f"{out_dir} holds a checkpoint.pkl from the JAX package "
                "(optax optimiser state), which podtpu_torch cannot resume; "
                "start a new run, or pass its model directory as pretrained")
        return None
    return torch.load(path, map_location="cpu", weights_only=True)
