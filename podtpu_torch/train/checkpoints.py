"""Model directory: ``config.json`` + ``model.msgpack`` (+ ``labels.txt``).

Counterpart of ``podtpu/train/checkpoints.py`` (the final-model artifact).
The files are in the JAX package's format, so a directory written by either
package loads in the other: ``model.msgpack`` holds the flax ``params`` and
``frozen`` trees (written and read by :mod:`podtpu_torch.shared.msgpack`),
``config.json`` the model configuration and the label names.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

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
