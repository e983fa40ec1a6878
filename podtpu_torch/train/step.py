"""The training step: augment, forward, losses, backward, update.

Counterpart of ``podtpu/train/step.py`` (``images_to_float``,
``make_train_step``, ``warmup_factor``).  The JAX step is one jitted
program; the port's runs eagerly on the model's device.  Every random
decision of a step is an explicit tensor of :class:`TrainDraws`, made by
:func:`draw_train` from a ``torch.Generator`` or handed in by the caller (the
tests hand in the draws JAX made from its key).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from podtpu_torch.core.config import Config
from podtpu_torch.data.presets import (SCALE_RANGES, AugmentDraws,
                                       augment_batch_policy, draw_augment,
                                       get_policy, policy_kwargs)
from podtpu_torch.infer.inference import resolve_device
from podtpu_torch.models.detector import ModelDraws, draw_model
from podtpu_torch.ops.image_ops import copy_paste_batch
from podtpu_torch.train.optim import apply_optimizer, make_capturable


def images_to_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 canvases -> [0, 1] float32; float inputs pass through."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) / 255.0
    return images


class TrainDraws(NamedTuple):
    augment: AugmentDraws
    # The samplers' draws; None for a one-stage model, which draws nothing.
    model: Optional[ModelDraws]
    # [B, G] uniforms: copy-paste keeps the neighbour's gt where < 0.5
    # (only with DataConfig.copy_paste).
    copy_paste: Optional[torch.Tensor] = None


def draw_train(generator: torch.Generator, cfg: Config,
               batch: Dict[str, torch.Tensor]) -> TrainDraws:
    """Every random number of one step for ``batch``, on ``generator``'s
    device (a scale per image under a scale-jitter policy)."""
    b, g = batch["boxes"].shape[:2]
    cp = None
    if cfg.data.copy_paste:
        cp = torch.rand((b, g), generator=generator, device=generator.device)
    return TrainDraws(
        augment=draw_augment(generator, b,
                             SCALE_RANGES.get(cfg.data.aug_policy)),
        model=draw_model(generator, cfg.model, b, g), copy_paste=cp)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    cfg: Config, device=None,
                    mark: Optional[Callable[[str], None]] = None
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(batch, lr, generator=None, draws=None) -> metrics``.

    The model is moved to ``device`` (in place: the optimiser keeps its
    parameters), which is the GPU unless the caller passes ``"cpu"``; with
    no GPU and no device this raises; there an Adam or AdamW optimiser is
    made capturable (:func:`podtpu_torch.train.optim.make_capturable`), so
    a state to resume from is loaded first.  ``batch`` holds ``image`` uint8
    ``[B, H, W, 3]``, ``boxes [B, G, 4]``, ``labels [B, G]``, ``valid
    [B, G]`` and optionally ``image_weight [B]``, mask targets ``masks
    [B, G, Hm, Wm]`` and keypoint targets ``keypoints [B, G, K, 3]``; it is
    moved to the device.  With ``DataConfig.copy_paste`` the batch is
    copy-pasted before the policy (keypoints stay as they were, as in the
    JAX step).
    ``lr`` is a float or a 0-d float32 tensor on the device (the form a
    CUDA graph of steps reads: nothing in the step reads the device from
    the host, and a batch already on the device is not copied).
    ``generator`` (on the device) makes the step's draws unless ``draws``
    gives them.  ``metrics`` holds the losses (``loss_mask`` too for a mask
    model, ``loss_keypoint`` for a keypoint model), their sum ``loss`` and
    ``lr``, as tensors on the device (reading them waits for the step).
    ``mark``, if given, is called with ``"augment"``, ``"forward_losses"``,
    ``"backward"`` and ``"optimizer"`` as each part of a step begins, and
    with ``"end"`` after the last, so a profiler can time the parts.
    """
    policy = get_policy(cfg.data.aug_policy)
    policy_kw = policy_kwargs(cfg)
    clip = cfg.train.clip_grad_norm
    dev = resolve_device(device)
    model.to(dev)
    make_capturable(optimizer)
    mark = mark or (lambda part: None)

    def step(batch: Dict, lr, generator: Optional[torch.Generator] = None,
             draws: Optional[TrainDraws] = None) -> Dict[str, torch.Tensor]:
        batch = {k: torch.as_tensor(v).to(dev, non_blocking=True)
                 for k, v in batch.items()}
        mark("augment")
        if draws is None:
            if generator is None:
                raise ValueError("step needs a torch.Generator or draws")
            draws = draw_train(generator, cfg, batch)
        images, boxes, labels, valid, masks = (
            images_to_float(batch["image"]), batch["boxes"],
            batch["labels"], batch["valid"], batch.get("masks"))
        keypoints = batch.get("keypoints")
        if cfg.data.copy_paste:
            images, boxes, labels, valid, masks = copy_paste_batch(
                draws.copy_paste, images, boxes, labels, valid, masks)
        images, boxes, valid, masks, keypoints = augment_batch_policy(
            policy, images, boxes, valid, draws.augment, masks=masks,
            keypoints=keypoints, **policy_kw)
        gt = {"boxes": boxes, "labels": labels, "valid": valid}
        if masks is not None:
            gt["masks"] = masks
        if keypoints is not None:
            gt["keypoints"] = keypoints
        if "image_weight" in batch:
            gt["image_weight"] = batch["image_weight"]
        mark("forward_losses")
        losses = model(images, gt=gt, draws=draws.model)
        total = sum(losses.values())
        mark("backward")
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        mark("optimizer")
        if not torch.is_tensor(lr):
            lr = torch.full((), float(lr), dtype=torch.float32, device=dev)
        apply_optimizer(optimizer, lr, clip)
        mark("end")
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        metrics["lr"] = lr
        return metrics

    return step


def warmup_factor(cfg: Config, epoch: int, it: int,
                  iters_in_epoch: int) -> float:
    """Linear warmup on epoch 0 only: factor ``warmup_start_factor`` -> 1
    over ``min(warmup_iters, iters_in_epoch - 1)`` iterations."""
    if epoch != 0:
        return 1.0
    total = min(cfg.train.warmup_iters, max(iters_in_epoch - 1, 1))
    if it >= total:
        return 1.0
    alpha = it / total
    return cfg.train.warmup_start_factor * (1 - alpha) + alpha
