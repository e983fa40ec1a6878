"""FCOS ResNet-50-FPN: the anchor-free one-stage detector.

Counterpart of ``podtpu/models/fcos.py``: RetinaNet's backbone, P3..P7
pyramid and postprocess (``models/retinanet.py``), with one stride-sized
cell box per location as its "anchor", shared 4-block towers of conv (with
bias), GroupNorm(32) and ReLU, ReLU'd (l, t, r, b) distances decoded by
the linear box coder, a centre-ness logit beside them, and the score
``sqrt(sigmoid(cls) * sigmoid(ctrness))``.  Training assigns each location
to a gt by centre sampling and per-level scale ranges
(:func:`fcos_match`; ties to the smallest area), then sums the focal loss
over every location, GIoU and the centre-ness BCE over the foreground.
Module names follow torchvision's ``fcos_resnet50_fpn``
(``head.classification_head.conv.{3i}`` the conv, ``.{3i+1}`` the norm,
``cls_logits``; ``head.regression_head.bbox_reg`` and ``bbox_ctrness``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from podtpu_torch.core.config import ModelConfig
from podtpu_torch.models.resnet import Conv2d
from podtpu_torch.models.retinanet import (GroupNorm, OneStageDetector,
                                           flatten_level, gather_rows,
                                           one_stage_postprocess,
                                           sigmoid_focal_loss)
from podtpu_torch.models.roi_heads import Detections
from podtpu_torch.models.rpn import sigmoid_bce
from podtpu_torch.ops import boxes as box_ops


def _tower(channels: int, dt: torch.dtype) -> nn.Sequential:
    layers = []
    for _ in range(4):
        layers += [Conv2d(channels, channels, 3, padding=1, compute_dtype=dt),
                   GroupNorm(32, channels, eps=1e-5), nn.ReLU()]
    return nn.Sequential(*layers)


class FCOSClassificationHead(nn.Module):
    def __init__(self, channels: int, num_classes: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.num_classes = num_classes
        self.conv = _tower(channels, compute_dtype)
        self.cls_logits = Conv2d(channels, num_classes, 3, padding=1,
                                 compute_dtype=compute_dtype)

    def forward(self, features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [flatten_level(self.cls_logits(self.conv(f)),
                              self.num_classes) for f in features]


class FCOSRegressionHead(nn.Module):
    def __init__(self, channels: int, compute_dtype: torch.dtype):
        super().__init__()
        self.conv = _tower(channels, compute_dtype)
        kw = dict(padding=1, compute_dtype=compute_dtype)
        self.bbox_reg = Conv2d(channels, 4, 3, **kw)
        self.bbox_ctrness = Conv2d(channels, 1, 3, **kw)

    def forward(self, features: Sequence[torch.Tensor]):
        deltas, ctr = [], []
        for f in features:
            h = self.conv(f)
            deltas.append(flatten_level(F.relu(self.bbox_reg(h)), 4))
            ctr.append(flatten_level(self.bbox_ctrness(h), 1)[..., 0])
        return deltas, ctr


class FCOSHead(nn.Module):
    """Per level: logits ``[B, Hl*Wl, C]``, non-negative (l, t, r, b) codes
    ``[B, Hl*Wl, 4]`` and centre-ness logits ``[B, Hl*Wl]``."""

    def __init__(self, channels: int, num_classes: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.classification_head = FCOSClassificationHead(
            channels, num_classes, compute_dtype)
        self.regression_head = FCOSRegressionHead(channels, compute_dtype)

    def forward(self, features):
        return (self.classification_head(features),
                *self.regression_head(features))


def fcos_match(anchors: torch.Tensor, sizes: torch.Tensor,
               lower: torch.Tensor, upper: torch.Tensor,
               gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
               center_radius: float) -> torch.Tensor:
    """``[B, N]`` matched gt index (-1: background) of ``[N, 4]`` location
    cells for ``[B, M, 4]`` gt boxes: the cell's centre within
    ``center_radius * size`` of the gt's centre (Chebyshev), strictly
    inside the gt, its largest side distance in the level's open range
    ``(lower, upper)``, the gt valid; ties to the gt of smallest area (the
    float32 score ``match * (1e8 - area)``, first maximum)."""
    acx = (0.5 * (anchors[:, 0] + anchors[:, 2]))[None, :, None]
    acy = (0.5 * (anchors[:, 1] + anchors[:, 3]))[None, :, None]
    gx1, gy1 = gt_boxes[..., None, :, 0], gt_boxes[..., None, :, 1]
    gx2, gy2 = gt_boxes[..., None, :, 2], gt_boxes[..., None, :, 3]
    off = torch.maximum((acx - 0.5 * (gx1 + gx2)).abs(),
                        (acy - 0.5 * (gy1 + gy2)).abs())     # [B, N, M]
    match = off < center_radius * sizes[None, :, None]
    l, t, r, b = acx - gx1, acy - gy1, gx2 - acx, gy2 - acy
    dmin = torch.minimum(torch.minimum(l, t), torch.minimum(r, b))
    dmax = torch.maximum(torch.maximum(l, t), torch.maximum(r, b))
    match &= dmin > 0
    match &= (dmax > lower[None, :, None]) & (dmax < upper[None, :, None])
    match &= gt_valid[:, None, :]
    area = box_ops.box_area(gt_boxes)
    score = match.float() * (1e8 - area[:, None, :])
    best, idx = score.max(-1).values, torch.argmax(score, -1)
    return torch.where(best < 1e-5, torch.full_like(idx, -1), idx)


def level_constants(cfg: ModelConfig, grids) -> tuple:
    """Per-location cell size and scale range ``(lower, upper)`` over the
    concatenated levels: ``(0, 8s)`` on the first level, ``(4s, inf)`` on
    the last, ``(4s, 8s)`` between."""
    sizes, lower, upper = [], [], []
    for li, g in enumerate(grids):
        n = g.shape[0]
        s = float(np.asarray(g[0, 2] - g[0, 0]))
        sizes.append(np.full((n,), s, np.float32))
        lower.append(np.full((n,), 0.0 if li == 0 else 4.0 * s, np.float32))
        upper.append(np.full((n,), np.inf if li == len(grids) - 1
                             else 8.0 * s, np.float32))
    return tuple(torch.from_numpy(np.concatenate(x))
                 for x in (sizes, lower, upper))


class FCOS(OneStageDetector):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        self.head = FCOSHead(cfg.fpn_channels, cfg.num_classes,
                             compute_dtype=self.compute_dtype)
        grids = [a.numpy() for a in self.anchors()]
        for name, x in zip(("level_sizes", "level_lower", "level_upper"),
                           level_constants(cfg, grids)):
            self.register_buffer(name, x, persistent=False)

    def forward(self, images: torch.Tensor, gt: Optional[Dict] = None,
                draws=None, generator=None):
        """Detections of ``[B, H, W, 3]`` images; with ``gt`` (as
        RetinaNet's) the losses ``classification``, ``bbox_regression`` and
        ``bbox_ctrness``."""
        logits, deltas, ctr = self.head(self.features(images))
        if gt is not None:
            return self.losses(torch.cat(logits, 1), torch.cat(deltas, 1),
                               torch.cat(ctr, 1), torch.cat(self.anchors()),
                               gt)
        return self.postprocess(logits, deltas, ctr)

    def losses(self, logits, deltas, ctr, anchors,
               gt) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        gt_b = gt["boxes"].float()
        m = fcos_match(anchors, self.level_sizes, self.level_lower,
                       self.level_upper, gt_b, gt["valid"],
                       cfg.fcos_center_radius)
        fg = (m >= 0).float()
        safe = m.clamp(min=0)
        cls = torch.gather(gt["labels"].long(), 1, safe)
        tgt = F.one_hot(cls, cfg.num_classes).float() * fg[..., None]
        cls_sums = sigmoid_focal_loss(logits.float(), tgt, cfg.focal_alpha,
                                      cfg.focal_gamma).sum((-2, -1))
        matched = gather_rows(gt_b, safe)
        pred = box_ops.decode_boxes_linear(deltas.float(), anchors)
        giou = box_ops.elementwise_giou(pred, matched)
        box_sums = ((1.0 - giou) * fg).sum(-1)
        # Centre-ness target of the encoded gt distances; background rows
        # hold garbage that the eps guards keep finite.
        enc = box_ops.encode_boxes_linear(anchors, matched)
        lr_min = torch.minimum(enc[..., 0], enc[..., 2])
        lr_max = torch.maximum(enc[..., 0], enc[..., 2])
        tb_min = torch.minimum(enc[..., 1], enc[..., 3])
        tb_max = torch.maximum(enc[..., 1], enc[..., 3])
        ratio = (lr_min / lr_max.clamp(min=1e-6)) \
            * (tb_min / tb_max.clamp(min=1e-6))
        ctr_tgt = torch.sqrt(ratio.clamp(min=0.0))
        ctr_sums = (sigmoid_bce(ctr.float(), ctr_tgt) * fg).sum(-1)
        num_fg = fg.sum(-1)
        img_w = gt.get("image_weight")
        if img_w is not None:
            cls_sums, box_sums = cls_sums * img_w, box_sums * img_w
            ctr_sums, num_fg = ctr_sums * img_w, num_fg * img_w
        denom = num_fg.sum().clamp(min=1.0)
        return {"classification": cls_sums.sum() / denom,
                "bbox_regression": box_sums.sum() / denom,
                "bbox_ctrness": ctr_sums.sum() / denom}

    decode = staticmethod(box_ops.decode_boxes_linear)

    def level_scores(self, level_logits, level_deltas, level_ctr):
        """Per level, ``sqrt(sigmoid(cls) * sigmoid(ctrness))`` of the
        foreground classes, float32, and the box codes."""
        return ([torch.sqrt(torch.sigmoid(lg.float()[..., 1:])
                            * torch.sigmoid(ct.float())[..., None])
                 for lg, ct in zip(level_logits, level_ctr)], level_deltas)

    def postprocess(self, *head_out) -> Detections:
        return one_stage_postprocess(*self.level_scores(*head_out),
                                     self.anchors(), self.cfg, self.decode)
