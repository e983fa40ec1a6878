"""RetinaNet ResNet-50-FPN, v1 and the v2 recipe: the one-stage focal-loss
detector.

Counterpart of ``podtpu/models/retinanet.py``: the ResNet-50 body, the FPN
over C3..C5 with the P6/P7 convolutions, shared 4-conv classification and
regression subnets applied to every level (with GroupNorm(32) and no conv
bias in the v2 recipe, ``retinanet_head_norm``), the sigmoid focal loss
over every anchor with the 0.5/0.4 IoU bands and low-quality matches, L1
on encoded deltas or (v2, ``retinanet_box_loss="giou"``) GIoU on decoded
boxes, and the eval postprocess: a per-level top-k over (anchor, class)
pairs, the merged pool re-topped to ``retinanet_nms_candidates``, and one
class-offset NMS an image, every image in one kernel launch.  Module names
follow torchvision's ``retinanet_resnet50_fpn`` (``head.classification_
head.conv.{i}.0``, ``.1`` the v2 GroupNorm, ``cls_logits``;
``head.regression_head.bbox_reg``).

:class:`OneStageDetector` holds what FCOS (``models/fcos.py``) shares: the
backbone and pyramid, the anchor grids and :func:`one_stage_postprocess`.
Head outputs are flattened location-major, anchor-minor (the anchor
grids' (y, x, A) order), and every top-k is a stable sort, so ties go to
the lower (anchor, class) index as in ``lax.top_k``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from podtpu_torch.core.config import ModelConfig
from podtpu_torch.models.fpn import (BackboneWithFPN, FeaturePyramidNetwork,
                                     PyramidDetector)
from podtpu_torch.models.resnet import Conv2d, ResNet
from podtpu_torch.models.roi_heads import Detections
from podtpu_torch.models.rpn import sigmoid_bce
from podtpu_torch.ops import boxes as box_ops
from podtpu_torch.ops import matching
from podtpu_torch.ops.anchors import grid_anchors
from podtpu_torch.ops.matching import stable_topk
from podtpu_torch.ops.nms import NEG_INF, batched_nms_keep, topk_by_score

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
# Bias of the classification logits at init: sigmoid(prior) = 0.01.
PRIOR_BIAS = -math.log((1.0 - 0.01) / 0.01)


class GroupNorm(nn.GroupNorm):
    """GroupNorm as flax computes it: float32 statistics, the variance as
    ``E[x^2] - E[x]^2`` clipped at 0, ``(x - mean) * (rsqrt(var + eps) *
    weight) + bias`` in float32, cast back to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        g = self.num_groups
        xf = x.float()
        grouped = xf.view(b, g, c // g, h, w)
        mean = grouped.mean((2, 3, 4))
        var = torch.maximum((grouped * grouped).mean((2, 3, 4))
                            - mean * mean, mean.new_zeros(()))
        mean = mean.repeat_interleave(c // g, 1)[..., None, None]
        var = var.repeat_interleave(c // g, 1)[..., None, None]
        mul = torch.rsqrt(var + self.eps) * self.weight.view(1, -1, 1, 1)
        y = (xf - mean) * mul + self.bias.view(1, -1, 1, 1)
        return y.to(x.dtype)


def flatten_level(x: torch.Tensor, k: int) -> torch.Tensor:
    """``[B, A*k, H, W]`` -> ``[B, H*W*A, k]``, location-major."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, k)


def _subnet(channels: int, norm: bool, dt: torch.dtype) -> nn.Sequential:
    """Four 3x3 conv (+ GroupNorm(32)) + ReLU blocks (torchvision's
    ``Conv2dNormActivation``: ``.0`` the conv, ``.1`` the norm)."""
    def block():
        conv = Conv2d(channels, channels, 3, padding=1, bias=not norm,
                      compute_dtype=dt)
        if norm:
            return nn.Sequential(conv, GroupNorm(32, channels, eps=1e-5),
                                 nn.ReLU())
        return nn.Sequential(conv, nn.ReLU())
    return nn.Sequential(*(block() for _ in range(4)))


class RetinaNetClassificationHead(nn.Module):
    def __init__(self, channels: int, num_anchors: int, num_classes: int,
                 norm: bool, compute_dtype: torch.dtype):
        super().__init__()
        self.num_classes = num_classes
        self.conv = _subnet(channels, norm, compute_dtype)
        self.cls_logits = Conv2d(channels, num_anchors * num_classes, 3,
                                 padding=1, compute_dtype=compute_dtype)

    def forward(self, features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [flatten_level(self.cls_logits(self.conv(f)),
                              self.num_classes) for f in features]


class RetinaNetRegressionHead(nn.Module):
    def __init__(self, channels: int, num_anchors: int, norm: bool,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.conv = _subnet(channels, norm, compute_dtype)
        self.bbox_reg = Conv2d(channels, num_anchors * 4, 3, padding=1,
                               compute_dtype=compute_dtype)

    def forward(self, features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [flatten_level(self.bbox_reg(self.conv(f)), 4)
                for f in features]


class RetinaNetHead(nn.Module):
    """Per level: logits ``[B, Hl*Wl*A, C]`` and deltas ``[B, Hl*Wl*A,
    4]`` in the compute dtype."""

    def __init__(self, channels: int, num_anchors: int, num_classes: int,
                 norm: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.classification_head = RetinaNetClassificationHead(
            channels, num_anchors, num_classes, norm, compute_dtype)
        self.regression_head = RetinaNetRegressionHead(
            channels, num_anchors, norm, compute_dtype)

    def forward(self, features):
        return (self.classification_head(features),
                self.regression_head(features))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float, gamma: float) -> torch.Tensor:
    """Elementwise sigmoid focal loss (torchvision's, no reduction)."""
    p = torch.sigmoid(logits)
    ce = sigmoid_bce(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return loss


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, n]]`` for ``[B, M, ...]`` ``x`` and ``[B, N]``
    ``idx``."""
    shape = idx.shape + x.shape[2:]
    return torch.gather(x, 1, idx.reshape(*idx.shape, *(
        1 for _ in x.shape[2:])).expand(shape))


def candidate_pool(level_scores: Sequence[torch.Tensor],
                   level_codes: Sequence[torch.Tensor],
                   level_anchors: Sequence[torch.Tensor], cfg: ModelConfig,
                   decode: Callable):
    """The NMS pool of one-stage head outputs: per level, ``[B, n, C-1]``
    float32 class scores (background excluded), ``[B, n, 4]`` box codes
    and ``[n, 4]`` anchors.  The top ``retinanet_topk_per_level`` (anchor,
    class) pairs of each level are decoded with ``decode(codes, anchors)``
    and clipped; the merged candidates, scores over ``score_thresh`` and
    boxes of at least 1e-2 px, are re-topped to
    ``retinanet_nms_candidates``, which leaves them in score order.
    Returns ``(boxes [B, P, 4], scores [B, P], labels [B, P], valid [B,
    P])``."""
    c1 = cfg.num_classes - 1
    cand_boxes, cand_scores, cand_labels = [], [], []
    for scores, codes, anchors in zip(level_scores, level_codes,
                                      level_anchors):
        flat = scores.reshape(scores.shape[0], -1)
        top, idx = stable_topk(flat, min(cfg.retinanet_topk_per_level,
                                         flat.shape[1]))
        a_idx = torch.div(idx, c1, rounding_mode="floor")
        boxes = decode(gather_rows(codes, a_idx).float(), anchors[a_idx])
        cand_boxes.append(box_ops.clip_boxes(boxes, cfg.image_size))
        cand_scores.append(top)
        cand_labels.append((idx % c1 + 1).to(torch.int32))
    boxes = torch.cat(cand_boxes, 1)
    scores = torch.cat(cand_scores, 1)
    labels = torch.cat(cand_labels, 1)
    ok = (scores > cfg.score_thresh) & box_ops.small_box_mask(boxes, 1e-2)
    pool = min(cfg.retinanet_nms_candidates, scores.shape[1])
    top, idx = stable_topk(torch.where(ok, scores,
                                       torch.full_like(scores, NEG_INF)),
                           pool)
    return (gather_rows(boxes, idx), top, gather_rows(labels, idx),
            top > NEG_INF / 2)


def select_detections(boxes: torch.Tensor, scores: torch.Tensor,
                      labels: torch.Tensor, keep: torch.Tensor,
                      cfg: ModelConfig) -> Detections:
    """The top ``detections_per_image`` kept entries of the pool."""
    oidx, out_valid = topk_by_score(scores, keep, cfg.detections_per_image)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    out_labels = gather_rows(labels, oidx)
    return Detections(
        boxes=torch.where(out_valid[..., None], gather_rows(boxes, oidx),
                          zero),
        scores=torch.where(out_valid, torch.gather(scores, 1, oidx), zero),
        labels=torch.where(out_valid, out_labels,
                           torch.zeros_like(out_labels)),
        valid=out_valid)


def one_stage_postprocess(level_scores: Sequence[torch.Tensor],
                          level_codes: Sequence[torch.Tensor],
                          level_anchors: Sequence[torch.Tensor],
                          cfg: ModelConfig,
                          decode: Callable) -> Detections:
    """Detections of one-stage head outputs (see :func:`candidate_pool`):
    one class-offset NMS per image over the pool, all images in one
    launch, then :func:`select_detections`."""
    boxes, scores, labels, valid = candidate_pool(
        level_scores, level_codes, level_anchors, cfg, decode)
    keep = batched_nms_keep(boxes, scores, labels, cfg.nms_thresh, valid,
                            presorted=True)
    return select_detections(boxes, scores, labels, keep, cfg)


class OneStageDetector(PyramidDetector):
    """ResNet-50 + FPN P3..P7 (``features``) and the anchor grids of the
    canvas, shared by RetinaNet and FCOS; subclasses add ``head``."""

    def __init__(self, cfg: ModelConfig, p6_on_c5: bool = False):
        dt = DTYPES[cfg.compute_dtype]
        super().__init__(cfg, BackboneWithFPN(
            ResNet((3, 4, 6, 3), compute_dtype=dt,
                   trainable_stages=cfg.trainable_backbone_stages),
            FeaturePyramidNetwork((512, 1024, 2048), cfg.fpn_channels,
                                  compute_dtype=dt, extra="p6p7",
                                  p6_on_c5=p6_on_c5)))
        self.compute_dtype = dt
        grids = grid_anchors(tuple(cfg.image_size), tuple(cfg.strides),
                             tuple(cfg.anchor_sizes),
                             tuple(cfg.anchor_ratios))
        for i, a in enumerate(grids):
            self.register_buffer(f"anchors_{i}", torch.as_tensor(a),
                                 persistent=False)
        self.num_levels = len(grids)

    def anchors(self) -> List[torch.Tensor]:
        return [getattr(self, f"anchors_{i}") for i in range(self.num_levels)]


class RetinaNet(OneStageDetector):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg, p6_on_c5=cfg.retinanet_p6_on_c5)
        self.head = RetinaNetHead(cfg.fpn_channels, cfg.anchors_per_location,
                                  cfg.num_classes,
                                  norm=cfg.retinanet_head_norm,
                                  compute_dtype=self.compute_dtype)

    def forward(self, images: torch.Tensor, gt: Optional[Dict] = None,
                draws=None, generator=None):
        """Detections of ``[B, H, W, 3]`` images; with ``gt`` (``boxes [B,
        G, 4]``, ``labels [B, G]``, ``valid [B, G]``, optional
        ``image_weight [B]``) the losses ``classification`` and
        ``bbox_regression``.  The model draws nothing: ``draws`` and
        ``generator`` are accepted for the two-stage models' signature."""
        logits, deltas = self.head(self.features(images))
        if gt is not None:
            return self.losses(torch.cat(logits, 1), torch.cat(deltas, 1),
                               torch.cat(self.anchors()), gt)
        return self.postprocess(logits, deltas)

    def losses(self, logits, deltas, anchors, gt) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        gt_b, gt_l = gt["boxes"].float(), gt["labels"]
        iou = box_ops.box_iou(anchors, gt_b)                      # [B, N, M]
        m = matching.match(iou, gt["valid"], cfg.retinanet_fg_iou,
                           cfg.retinanet_bg_iou, allow_low_quality=True)
        del iou
        fg = (m.labels == 1).float()
        considered = (m.labels >= 0).float()
        cls = torch.gather(gt_l.long(), 1, m.matched_idx)
        tgt = F.one_hot(cls, cfg.num_classes).float() * fg[..., None]
        fl = sigmoid_focal_loss(logits.float(), tgt, cfg.focal_alpha,
                                cfg.focal_gamma)
        cls_sums = (fl.sum(-1) * considered).sum(-1)
        matched = gather_rows(gt_b, m.matched_idx)
        if cfg.retinanet_box_loss == "giou":
            pred = box_ops.decode_boxes(deltas.float(), anchors)
            giou = box_ops.elementwise_giou(pred, matched)
            box_sums = ((1.0 - giou) * fg).sum(-1)
        else:
            enc = box_ops.encode_boxes(matched, anchors)
            box_sums = ((deltas.float() - enc).abs().sum(-1) * fg).sum(-1)
        num_fg = fg.sum(-1)
        img_w = gt.get("image_weight")
        if img_w is not None:
            cls_sums, box_sums = cls_sums * img_w, box_sums * img_w
            num_fg = num_fg * img_w
        denom = num_fg.sum().clamp(min=1.0)
        return {"classification": cls_sums.sum() / denom,
                "bbox_regression": box_sums.sum() / denom}

    decode = staticmethod(box_ops.decode_boxes)

    def level_scores(self, level_logits, level_deltas):
        """Per level, the foreground classes' float32 scores and the box
        codes of the head's outputs."""
        return ([torch.sigmoid(lg.float()[..., 1:]) for lg in level_logits],
                level_deltas)

    def postprocess(self, *head_out) -> Detections:
        return one_stage_postprocess(*self.level_scores(*head_out),
                                     self.anchors(), self.cfg, self.decode)
