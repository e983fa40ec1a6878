"""RoI box head, RoI pooling, training targets and losses, and detection
postprocess.

Counterpart of ``podtpu/models/roi_heads.py``: ``BoxHead`` (torchvision's
TwoMLPHead + FastRCNNPredictor), ``sample_rois`` and ``box_head_losses``
(batched over images here, vmapped there), ``postprocess_detections`` and
``pool_rois_batched``.  Module names follow torchvision
(``box_head.fc6``, ``box_predictor.cls_score``).  fc6 consumes the pooled
features flattened as (C, H, W), torchvision's order, so its weight is in
torchvision layout; the JAX head flattens (H, W, C) and the weight bridge
(``models/weights.py``) permutes between the two.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from podtpu_torch.core.config import ModelConfig
from podtpu_torch.models.rpn import smooth_l1
from podtpu_torch.ops import boxes as box_ops
from podtpu_torch.ops import matching
from podtpu_torch.ops.matching import stable_topk
from podtpu_torch.ops.nms import NEG_INF, nms_keep_segments
from podtpu_torch.ops.roi_align import batched_roi_align


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype``; float32 params."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class TwoMLPHead(nn.Module):
    def __init__(self, in_features: int, hidden: int = 1024,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc6 = Linear(in_features, hidden, compute_dtype=compute_dtype)
        self.fc7 = Linear(hidden, hidden, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class FastRCNNPredictor(nn.Module):
    def __init__(self, in_features: int, num_classes: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cls_score = Linear(in_features, num_classes,
                                compute_dtype=compute_dtype)
        self.bbox_pred = Linear(in_features, num_classes * 4,
                                compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor):
        return self.cls_score(x), self.bbox_pred(x)


class BoxHead(nn.Module):
    """TwoMLPHead + predictor over ``[N, P, P, C]`` pooled features ->
    float32 class logits ``[N, classes]`` and deltas ``[N, classes*4]``."""

    def __init__(self, channels: int, pool_size: int, num_classes: int,
                 hidden: int = 1024,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.box_head = TwoMLPHead(channels * pool_size ** 2, hidden,
                                   compute_dtype)
        self.box_predictor = FastRCNNPredictor(hidden, num_classes,
                                               compute_dtype)

    def forward(self, pooled: torch.Tensor):
        x = pooled.permute(0, 3, 1, 2).reshape(pooled.shape[0], -1)
        logits, deltas = self.box_predictor(self.box_head(x))
        return logits.float(), deltas.float()


class Detections(NamedTuple):
    boxes: torch.Tensor   # [B, D, 4] xyxy, canvas coords
    scores: torch.Tensor  # [B, D]
    labels: torch.Tensor  # [B, D] int32, 1-based (0 = invalid slot)
    valid: torch.Tensor   # [B, D]


def postprocess_detections(logits: torch.Tensor, deltas: torch.Tensor,
                           proposals: torch.Tensor, prop_valid: torch.Tensor,
                           cfg: ModelConfig) -> Detections:
    """Batched final filtering: softmax, per-class decode and clip, score
    and size filters, per-(image, class) NMS in one launch, top
    ``detections_per_image``.  ``logits [B, P, C]``, ``deltas [B, P, 4C]``,
    ``proposals [B, P, 4]``, ``prop_valid [B, P]``."""
    b, p, c = logits.shape
    scores = torch.softmax(logits, dim=-1)
    boxes_pc = box_ops.decode_boxes(deltas.reshape(b, p, c, 4),
                                    proposals[:, :, None, :],
                                    weights=cfg.box_reg_weights)
    boxes_pc = box_ops.clip_boxes(boxes_pc, cfg.image_size)
    # Drop the background column; class-major [B, C-1, P] layout.
    cls_scores = scores[..., 1:].transpose(1, 2)
    cls_boxes = boxes_pc[:, :, 1:, :].transpose(1, 2)
    ok = ((cls_scores > cfg.score_thresh) & prop_valid[:, None, :]
          & box_ops.small_box_mask(cls_boxes, 1e-2))
    keep = nms_keep_segments(cls_boxes.reshape(b * (c - 1), p, 4),
                             cls_scores.reshape(b * (c - 1), p),
                             cfg.nms_thresh, ok.reshape(b * (c - 1), p))
    flat_ok = keep.reshape(b, -1) & ok.reshape(b, -1)
    flat_scores = cls_scores.reshape(b, -1)
    flat_scores = torch.where(flat_ok, flat_scores,
                              torch.full_like(flat_scores, NEG_INF))
    top, idx = stable_topk(flat_scores, cfg.detections_per_image)
    valid = top > NEG_INF / 2
    out_boxes = torch.gather(cls_boxes.reshape(b, -1, 4), 1,
                             idx[..., None].expand(-1, -1, 4))
    labels = (torch.div(idx, p, rounding_mode="floor") + 1).to(torch.int32)
    return Detections(
        boxes=torch.where(valid[..., None], out_boxes,
                          torch.zeros_like(out_boxes)),
        scores=torch.where(valid, top, torch.zeros_like(top)),
        labels=torch.where(valid, labels, torch.zeros_like(labels)),
        valid=valid)


class SampledRois(NamedTuple):
    boxes: torch.Tensor        # [B, S, 4]
    valid: torch.Tensor        # [B, S]
    is_pos: torch.Tensor       # [B, S]
    cls_targets: torch.Tensor  # [B, S] int64, 0 = background
    reg_targets: torch.Tensor  # [B, S, 4]


@torch.no_grad()
def sample_rois(proposals: torch.Tensor, prop_valid: torch.Tensor,
                gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                gt_valid: torch.Tensor, cfg: ModelConfig, u_pos: torch.Tensor,
                u_neg: torch.Tensor) -> SampledRois:
    """Training RoI subsample: the gt boxes are appended to the ``[B, P, 4]``
    proposals (every gt then has a perfectly overlapping positive), matched
    without low-quality matches, and ``box_batch_per_image`` of the
    ``P + G`` candidates sampled with the draws ``u_pos``/``u_neg
    [B, P + G]``."""
    boxes = torch.cat([proposals, gt_boxes], 1)
    valid = torch.cat([prop_valid, gt_valid], 1)
    iou = box_ops.box_iou(boxes, gt_boxes)
    m = matching.match(iou, gt_valid, cfg.box_fg_iou, cfg.box_bg_iou,
                       allow_low_quality=False)
    labels = torch.where(valid, m.labels, -1)  # padded candidates: ignored
    samp = matching.balanced_sample_gather(
        labels, valid, cfg.box_batch_per_image, cfg.box_positive_fraction,
        u_pos, u_neg)
    sboxes = torch.gather(boxes, 1, samp.idx[..., None].expand(-1, -1, 4))
    matched = torch.gather(m.matched_idx, 1, samp.idx)
    cls_t = torch.where(samp.is_pos, torch.gather(gt_labels.long(), 1,
                                                  matched), 0)
    cls_t = torch.where(samp.valid, cls_t, 0)
    matched_gt = torch.gather(gt_boxes, 1, matched[..., None].expand(-1, -1, 4))
    reg_t = box_ops.encode_boxes(matched_gt, sboxes,
                                 weights=cfg.box_reg_weights)
    return SampledRois(
        boxes=torch.where(samp.valid[..., None], sboxes,
                          torch.zeros_like(sboxes)),
        valid=samp.valid, is_pos=samp.is_pos, cls_targets=cls_t,
        reg_targets=reg_t)


def box_head_losses(logits: torch.Tensor, deltas: torch.Tensor,
                    rois: SampledRois,
                    sample_weight: Optional[torch.Tensor] = None):
    """Classification and box-regression losses over ``[N, C]`` logits and
    ``[N, 4C]`` deltas of ``N = B * S`` sampled RoIs (``rois`` fields
    flattened the same way), normalised as torchvision's ``fastrcnn_loss``:
    mean cross-entropy over the samples; box loss summed over positives,
    over the sample count.  ``sample_weight [N]`` scales each sample."""
    n, c = logits.shape
    w = rois.valid.float()
    if sample_weight is not None:
        w = w * sample_weight
    total = w.sum().clamp(min=1.0)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, 1, rois.cls_targets[:, None])[:, 0]
    cls_loss = (ce * w).sum() / total
    picked = torch.gather(deltas.reshape(n, c, 4), 1,
                          rois.cls_targets[:, None, None].expand(-1, 1, 4))
    pw = (rois.is_pos & rois.valid).float()
    if sample_weight is not None:
        pw = pw * sample_weight
    l1 = smooth_l1(picked[:, 0] - rois.reg_targets, 1.0 / 9.0).sum(-1)
    return cls_loss, (l1 * pw).sum() / total


def pool_rois_batched(pyramid: Sequence[torch.Tensor], rois: torch.Tensor,
                      cfg: ModelConfig,
                      pool_size: Optional[int] = None) -> torch.Tensor:
    """Multi-level RoIAlign of ``[B, K, 4]`` RoIs over the box-head levels
    (NCHW, channels_last) -> ``[B, K, P, P, C]``."""
    n_lvl = len(cfg.roi_strides)
    # The NHWC view of a channels_last level is contiguous: no copy.
    levels = [f.permute(0, 2, 3, 1).contiguous() for f in pyramid[:n_lvl]]
    return batched_roi_align(
        levels, rois, cfg.roi_strides,
        output_size=pool_size or cfg.roi_pool_size,
        sampling_ratio=cfg.roi_sampling_ratio,
        canonical_scale=cfg.roi_canonical_scale,
        canonical_level=cfg.roi_canonical_level)
