"""Faster R-CNN ResNet-50-FPN, eval forward.

Counterpart of ``podtpu/models/detector.py`` (``FasterRCNN`` on the
``resnet50_fpn`` backbone with the MLP box head, eval path, and
``make_detector``).  The forward takes ``[B, H, W, 3]`` images (uint8, or
float in [0, 1]) like the JAX model, normalises them in float32 and runs the
network on NCHW tensors in ``torch.channels_last`` memory.  Capacities are
static: ``rpn_post_nms_topk_test`` proposals and ``detections_per_image``
detections per image, with validity masks.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from podtpu_torch.core.config import ModelConfig
from podtpu_torch.models import roi_heads as rh
from podtpu_torch.models import rpn as rpn_lib
from podtpu_torch.models.fpn import BackboneWithFPN, FeaturePyramidNetwork
from podtpu_torch.models.resnet import (FrozenBatchNorm2d, ResNet,
                                        variance_scaling_)
from podtpu_torch.ops.anchors import grid_anchors

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


class FasterRCNN(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dt = _DTYPES[cfg.compute_dtype]
        self.backbone = BackboneWithFPN(
            ResNet((3, 4, 6, 3), compute_dtype=dt),
            FeaturePyramidNetwork((256, 512, 1024, 2048), cfg.fpn_channels,
                                  compute_dtype=dt))
        anchors = grid_anchors(tuple(cfg.image_size), tuple(cfg.strides),
                               tuple(cfg.anchor_sizes),
                               tuple(cfg.anchor_ratios))
        self.rpn = rpn_lib.RegionProposalNetwork(
            rpn_lib.RPNHead(cfg.fpn_channels, cfg.anchors_per_location,
                            compute_dtype=dt), anchors)
        self.roi_heads = rh.BoxHead(cfg.fpn_channels, cfg.roi_pool_size,
                                    cfg.num_classes, compute_dtype=dt)
        self.register_buffer(
            "pixel_mean", torch.tensor(cfg.pixel_mean).view(1, 3, 1, 1),
            persistent=False)
        self.register_buffer(
            "pixel_std", torch.tensor(cfg.pixel_std).view(1, 3, 1, 1),
            persistent=False)

    def features(self, images: torch.Tensor):
        """P2..P6 of ``[B, H, W, 3]`` images."""
        x = images.permute(0, 3, 1, 2)  # NHWC memory = channels_last NCHW
        if x.dtype == torch.uint8:
            x = x.to(torch.float32) / 255.0
        x = (x - self.pixel_mean) / self.pixel_std
        return self.backbone(x.contiguous(memory_format=torch.channels_last))

    def forward(self, images: torch.Tensor) -> rh.Detections:
        cfg = self.cfg
        pyramid = self.features(images)
        level_logits, level_deltas = self.rpn.head(pyramid)
        proposals = rpn_lib.select_proposals(
            level_logits, level_deltas, self.rpn.anchors(), cfg, train=False)
        pooled = rh.pool_rois_batched(pyramid, proposals.boxes, cfg)
        b, p = pooled.shape[:2]
        logits, deltas = self.roi_heads(pooled.reshape(b * p,
                                                       *pooled.shape[2:]))
        return rh.postprocess_detections(
            logits.reshape(b, p, -1), deltas.reshape(b, p, -1),
            proposals.boxes, proposals.valid, cfg)


def _unsupported(cfg: ModelConfig) -> Optional[str]:
    if cfg.family != "faster_rcnn":
        return (f"family={cfg.family!r} (ROADMAP.md, open item 1: the "
                "one-stage and SSD families)")
    if cfg.backbone != "resnet50_fpn":
        return (f"backbone={cfg.backbone!r} (ROADMAP.md, open item 1: the "
                "mobile trunks)")
    if cfg.box_head_type != "mlp" or cfg.rpn_conv_depth != 1 or cfg.fpn_norm:
        return "the v2 recipe heads (ROADMAP.md, open item 1: v2 recipes)"
    if cfg.with_mask:
        return "with_mask (ROADMAP.md, open item 1: Mask R-CNN)"
    if cfg.with_keypoints:
        return "with_keypoints (ROADMAP.md, open item 1: Keypoint R-CNN)"
    if cfg.anchors_per_location != len(cfg.anchor_ratios) \
            or len(cfg.strides) != 5:
        return "anchor layouts other than one size per P2..P6 level"
    return None


def make_detector(cfg: ModelConfig) -> FasterRCNN:
    """The model for ``cfg``; raises ``NotImplementedError`` for what the
    port has not reached yet, naming the ROADMAP item that brings it."""
    missing = _unsupported(cfg)
    if missing is not None:
        raise NotImplementedError(f"podtpu_torch does not port {missing} "
                                  "yet")
    return FasterRCNN(cfg)


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise as flax does: ``lecun_normal`` convs and dense layers,
    ``variance_scaling(2, fan_out)`` for the stem, zero biases, identity
    frozen BatchNorm.  Draws come from ``generator`` (a CPU generator; the
    model must be on the CPU)."""
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            stem = name.endswith("body.conv1")
            variance_scaling_(mod.weight.data, 2.0 if stem else 1.0,
                              "fan_out" if stem else "fan_in", generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, FrozenBatchNorm2d):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)

