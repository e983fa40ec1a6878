#!/usr/bin/env python3
"""How far one v2 training step of the port moves under a 1e-7 relative
change of one weight tensor, on the CPU.

Run from the repository root:

    python3 tools/torch_v2_step_noise.py

A float32 step flips ReLU inputs that lie within rounding of zero when its
sums are taken in another order, and each flip moves some gradients.  This
measures that floor for the port alone: for Faster R-CNN v2 under ``lsj``
and Mask R-CNN v2 under ``multiscale`` at ``tests/conftest.py::
tiny_config``'s sizes (128^2, float32, 4 classes), it takes one step, then
the same step with one weight tensor scaled by ``1 + 1e-7`` (each of a few
tensors in turn), and prints per configuration the largest change of any
gradient as a share of that gradient's largest entry, with the tensor.
Two configurations: the tiny config's (32 sampled RoIs an image, the
ResNet body training from stage 3) and the one
``tests/test_torch_v2_train.py`` holds against JAX (64 RoIs an image, the
body frozen).  One JSON line each.
"""
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from podtpu_torch.core.config import (Config, DataConfig, ModelConfig,
                                      TrainConfig, fasterrcnn_v2_config)
from podtpu_torch.models.detector import init_parameters, make_detector
from podtpu_torch.train.optim import make_optimizer
from podtpu_torch.train.step import draw_train, make_train_step

PERTURBED = ("backbone.fpn.layer_blocks.0.0.weight",
             "rpn.head.conv.0.0.weight", "roi_heads.box_head.0.0.weight",
             "roi_heads.box_predictor.cls_score.weight")


def batch(seed, with_masks, b=2, g=8, size=128):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        n = int(rng.integers(1, g + 1))
        xy = rng.uniform(0, size - 24, (n, 2))
        boxes[i, :n] = np.concatenate(
            [xy, np.minimum(xy + rng.uniform(8, 48, (n, 2)), size)], 1)
        valid[i, :n] = True
    out = {"image": rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
           "boxes": boxes, "valid": valid,
           "labels": np.where(valid, rng.integers(1, 4, (b, g)), 0)
           .astype(np.int32)}
    if with_masks:
        out["masks"] = (rng.uniform(size=(b, g, size // 8, size // 8))
                        < 0.3).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def gradients(cfg, data, draws, scaled=None):
    model = make_detector(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    if scaled is not None:
        with torch.no_grad():
            dict(model.named_parameters())[scaled].mul_(1 + 1e-7)
    step = make_train_step(model, make_optimizer(cfg.train, model), cfg,
                           device="cpu")
    step(data, 0.005, draws=draws)
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


def main():
    torch.set_num_threads(2)
    for name, policy in (("faster_v2", "lsj"), ("mask_v2", "multiscale")):
        for rois, stages in ((32, 3), (64, 0)):
            mcfg = fasterrcnn_v2_config(ModelConfig(
                image_size=(128, 128), rpn_pre_nms_topk_train=128,
                rpn_post_nms_topk_train=128, box_batch_per_image=rois,
                max_gt_boxes=8, compute_dtype="float32", num_classes=4,
                trainable_backbone_stages=stages,
                with_mask=name == "mask_v2"))
            cfg = Config(model=mcfg, train=TrainConfig(warmup_iters=10),
                         data=DataConfig(aug_policy=policy,
                                         photometric_distort=False))
            data = batch(1, name == "mask_v2")
            draws = draw_train(torch.Generator().manual_seed(7), cfg, data)
            base = gradients(cfg, data, draws)
            worst = (0.0, None, None)
            for scaled in PERTURBED:
                moved = gradients(cfg, data, draws, scaled)
                for n, g in base.items():
                    share = float((moved[n] - g).abs().max()
                                  / g.abs().max().clamp(min=1e-30))
                    worst = max(worst, (share, n, scaled))
            print(json.dumps({"model": name, "aug_policy": policy,
                              "rois_per_image": rois,
                              "trainable_backbone_stages": stages,
                              "max_gradient_change_over_max": worst[0],
                              "tensor": worst[1], "scaled": worst[2]}),
                  flush=True)


if __name__ == "__main__":
    main()
