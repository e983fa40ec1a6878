"""Crop-classifier training and inference drivers.

Counterpart of ``podtpu/train/classify.py``: trains
:class:`podtpu_torch.models.classifier.CropClassifier` on a folder of
class-sorted crops, the layout ``crop-objects`` writes
(``<root>/<label>/<crop>.jpg``), with the ALRS early stopping the detector
uses, and classifies crop folders.  As in the JAX package:

* the held-out split is the last ``int(split_fraction * n)`` of a
  ``default_rng(1)`` permutation, each epoch's order a
  ``default_rng(seed + epoch)`` permutation of the training indices;
* every batch is full: training wraps its tail around to the epoch's
  first crops, the held-out pass counts only the crops it has not counted,
  and ``classify_crops`` pads its tail with zero images;
* the optimiser is optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, weight
  decay 1e-4 on every parameter) as ``torch.optim.AdamW``, its learning
  rate ALRS's, set before each step;
* the model directory holds ``classifier.msgpack`` (flax's
  ``serialization.to_bytes`` of the params tree, written and read by
  :mod:`podtpu_torch.shared.msgpack`), ``classifier.json`` (labels, image
  size, held-out accuracy) and ``labels.txt``, so a directory written by
  either package loads in the other.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from podtpu_torch.core.device import resolve_device
from podtpu_torch.core.logging import MetricLogger, is_main_process
from podtpu_torch.data.imageio import pil_to_rgb
from podtpu_torch.models.classifier import CropClassifier, init_classifier
from podtpu_torch.models.weights import (classifier_flax_from_state_dict,
                                         classifier_state_dict_from_flax)
from podtpu_torch.shared import msgpack
from podtpu_torch.shared.utils import now_as_str
from podtpu_torch.train.alrs import AdaptiveLearningRateScheduler
from podtpu_torch.train.optim import apply_optimizer

IMAGE_SUFFIXES = {".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".tif"}
WEIGHT_DECAY = 1e-4  # optax.adamw's default


def scan_crop_folders(root: str) -> Tuple[List[str], List[int], List[str]]:
    """Recursively collect (paths, label indices, label names) from a
    class-sorted crop tree; the class is the immediate parent directory."""
    rootp = Path(root)
    files = [p for p in sorted(rootp.rglob("*.*"))
             if p.suffix.lower() in IMAGE_SUFFIXES]
    labels = sorted({p.parent.name for p in files})
    label_to_idx = {label: i for i, label in enumerate(labels)}
    return ([str(p) for p in files],
            [label_to_idx[p.parent.name] for p in files],
            labels)


def load_crop(path: str, size: int) -> np.ndarray:
    """``[size, size, 3]`` float32 in [0, 1]: resized by OpenCV's bilinear
    filter where ``cv2`` imports, else by Pillow's default filter."""
    from PIL import Image

    with Image.open(path) as im:
        arr = pil_to_rgb(im)
    try:
        import cv2
        arr = cv2.resize(arr, (size, size), interpolation=cv2.INTER_LINEAR)
    except ImportError:
        arr = np.asarray(Image.fromarray(arr).resize((size, size)))
    return arr.astype(np.float32) / 255.0


def _batches(paths, labels, idx_order, batch_size, size):
    for start in range(0, len(idx_order), batch_size):
        sel = idx_order[start: start + batch_size]
        if len(sel) < batch_size:  # wrap for static shapes
            sel = np.concatenate([sel, idx_order[: batch_size - len(sel)]])
        images = np.stack([load_crop(paths[i], size) for i in sel])
        yield images, np.asarray([labels[i] for i in sel], np.int32)


def _load_params(model: CropClassifier, params: Dict) -> None:
    sd = classifier_state_dict_from_flax(params)
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})


def train_classifier(
    input_dir: str,
    output_dir: Optional[str] = None,
    name: Optional[str] = None,
    batch_size: int = 32,
    image_size: int = 128,
    lr: float = 0.001,
    max_epochs: int = 500,
    alrs_epochs: int = 10,
    alrs_drops: int = 4,
    alrs_startup_factor: int = 2,
    seed: int = 0,
    split_fraction: float = 0.2,
    device=None,
    *,
    initial_params: Optional[Dict] = None,
) -> str:
    """Train on a class-sorted crop folder; returns the model directory.

    ``initial_params``: the starting weights as a flax params tree of
    numpy arrays (the JAX package's ``model.init``); without it the model
    is initialised from a ``torch.Generator`` seeded by ``seed``."""
    dev = resolve_device(device)
    paths, labels, label_names = scan_crop_folders(input_dir)
    if not paths:
        raise ValueError(f"No crops found under {input_dir}")
    n = len(paths)
    rng = np.random.default_rng(1)
    perm = rng.permutation(n)
    k = int(split_fraction * n)
    train_idx, test_idx = (perm[:-k], perm[-k:]) if k else (perm, perm[:0])

    if output_dir is None:
        output_dir = os.getcwd()
    output_dir = os.path.join(output_dir, name or now_as_str())
    print(f"Crop classifier training: {n} crops, "
          f"{len(label_names)} classes {label_names}")

    model = CropClassifier(num_classes=len(label_names))
    if initial_params is None:
        init_classifier(model, torch.Generator().manual_seed(seed))
    else:
        _load_params(model, initial_params)
    model = model.to(dev).to(memory_format=torch.channels_last)
    optimizer = torch.optim.AdamW(model.parameters(), lr=lr,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=WEIGHT_DECAY)

    def train_step(images, targets, step_lr):
        logits = model(images)
        logp = F.log_softmax(logits, -1)
        loss = -logp.gather(1, targets[:, None])[:, 0].mean()
        acc = (logits.argmax(-1) == targets).float().mean()
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        apply_optimizer(optimizer, step_lr)
        return loss.detach(), acc

    def to_device(images, targets):
        return (torch.from_numpy(images).to(dev),
                torch.from_numpy(targets).long().to(dev))

    alrs = AdaptiveLearningRateScheduler(
        lr, nb_drops=alrs_drops, nb_epochs=alrs_epochs,
        startup_delay_factor=alrs_startup_factor)

    for epoch in range(max_epochs):
        order = np.random.default_rng(seed + epoch).permutation(train_idx)
        logger = MetricLogger()
        for images, targets in _batches(paths, labels, order, batch_size,
                                        image_size):
            loss, acc = train_step(*to_device(images, targets),
                                   np.float32(alrs.lr))
            logger.update(loss=float(loss), acc=float(acc))
        if is_main_process():
            print(f"Epoch [{epoch}] {logger}")
        if alrs.step(epoch, logger.meters["loss"].global_avg):
            break

    # Held-out accuracy.
    correct = total = 0
    with torch.inference_mode():
        for images, targets in _batches(paths, labels, test_idx, batch_size,
                                        image_size):
            x, _ = to_device(images, targets)
            preds = model(x).argmax(-1).cpu().numpy()
            m = min(len(test_idx) - total, len(preds))
            correct += int((preds[:m] == targets[:m]).sum())
            total += m
    test_acc = correct / max(total, 1)
    print(f"Test accuracy: {test_acc:.3f} ({correct}/{total})")

    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "classifier.msgpack"), "wb") as fp:
        fp.write(msgpack.packb(classifier_flax_from_state_dict(
            model.state_dict())))
    with open(os.path.join(output_dir, "classifier.json"), "w") as fp:
        json.dump({"labels": label_names, "image_size": image_size,
                   "test_accuracy": test_acc}, fp, indent=2)
    with open(os.path.join(output_dir, "labels.txt"), "w") as fp:
        for idx, label in enumerate(label_names):
            fp.write(f"{idx + 1},{label}\n")
    return output_dir


def classify_crops(input_dir: str, model_dir: str, batch_size: int = 32,
                   device=None) -> Dict[str, str]:
    """Classify every crop under ``input_dir``; returns path -> label."""
    dev = resolve_device(device)
    with open(os.path.join(model_dir, "classifier.json")) as fp:
        meta = json.load(fp)
    label_names = meta["labels"]
    image_size = meta["image_size"]
    model = CropClassifier(num_classes=len(label_names))
    with open(os.path.join(model_dir, "classifier.msgpack"), "rb") as fp:
        _load_params(model, msgpack.unpackb(fp.read()))
    model = model.to(dev).to(memory_format=torch.channels_last).eval()
    paths = [str(p) for p in sorted(Path(input_dir).rglob("*.*"))
             if p.suffix.lower() in IMAGE_SUFFIXES]
    out: Dict[str, str] = {}
    for start in range(0, len(paths), batch_size):
        chunk = paths[start: start + batch_size]
        images = np.stack([load_crop(p, image_size) for p in chunk])
        if len(chunk) < batch_size:
            images = np.concatenate(
                [images, np.zeros((batch_size - len(chunk),) +
                                  images.shape[1:], np.float32)])
        with torch.inference_mode():
            preds = model(torch.from_numpy(images).to(dev)).argmax(-1)
        for p, pred in zip(chunk, preds.cpu().numpy()):
            out[p] = label_names[int(pred)]
    return out
