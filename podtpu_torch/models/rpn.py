"""Region Proposal Network: shared head and static-shape proposal selection.

Counterpart of ``podtpu/models/rpn.py``.  Per level: top ``pre_k`` anchors
by objectness, decode, clip, size filter; one NMS per (image, level) at
``rpn_nms_thresh``, all of them in one kernel launch; then the global top
``post_k``.  Top-k is a stable descending sort, so ties go to the lower
index as in ``lax.top_k``.  :func:`rpn_losses` is the training loss: match
every anchor to the gt boxes, sample 256 anchors per image, and take the
objectness BCE and the smooth-L1 box loss over the sampled ones only.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from podtpu_torch.core.config import ModelConfig
from podtpu_torch.models.resnet import Conv2d
from podtpu_torch.ops import boxes as box_ops
from podtpu_torch.ops import matching
from podtpu_torch.ops.matching import stable_topk
from podtpu_torch.ops.nms import NEG_INF, nms_keep_segments


class RPNHead(nn.Module):
    """3x3 conv + ReLU, then 1x1 objectness (``cls_logits``, A channels) and
    box deltas (``bbox_pred``, 4A channels), shared by every level.  With
    ``conv_depth`` > 1 (the v2 recipe) the tower is that many 3x3 convs,
    each followed by a ReLU, under torchvision v2's names ``conv.{d}.0``."""

    def __init__(self, channels: int, num_anchors: int,
                 compute_dtype: torch.dtype = torch.float32,
                 conv_depth: int = 1):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype)
        self.num_anchors = num_anchors
        if conv_depth == 1:
            self.conv = Conv2d(channels, channels, 3, padding=1, **kw)
        else:
            self.conv = nn.Sequential(*(
                nn.Sequential(Conv2d(channels, channels, 3, padding=1, **kw),
                              nn.ReLU())
                for _ in range(conv_depth)))
        self.cls_logits = Conv2d(channels, num_anchors, 1, **kw)
        self.bbox_pred = Conv2d(channels, num_anchors * 4, 1, **kw)

    def forward(self, features: Sequence[torch.Tensor]):
        """Per level: logits ``[B, Hl*Wl*A]`` and deltas ``[B, Hl*Wl*A, 4]``
        in anchor-grid (y, x, A) order, in the compute dtype."""
        logits, deltas = [], []
        a = self.num_anchors
        for f in features:
            t = self.conv(f)
            if isinstance(self.conv, Conv2d):
                t = F.relu(t)
            obj = self.cls_logits(t)                       # [B, A, H, W]
            dlt = self.bbox_pred(t)                        # [B, 4A, H, W]
            b, _, h, w = obj.shape
            logits.append(obj.permute(0, 2, 3, 1).reshape(b, -1))
            deltas.append(dlt.reshape(b, a, 4, h, w).permute(0, 3, 4, 1, 2)
                          .reshape(b, -1, 4))
        return logits, deltas


class RegionProposalNetwork(nn.Module):
    """Holds the head (``rpn.head``) and the anchor grids of the canvas."""

    def __init__(self, head: RPNHead, anchors: Sequence):
        super().__init__()
        self.head = head
        for i, a in enumerate(anchors):
            self.register_buffer(f"anchors_{i}", torch.as_tensor(a),
                                 persistent=False)
        self.num_levels = len(anchors)

    def anchors(self) -> List[torch.Tensor]:
        return [getattr(self, f"anchors_{i}") for i in range(self.num_levels)]


class Proposals(NamedTuple):
    boxes: torch.Tensor   # [B, P, 4]
    scores: torch.Tensor  # [B, P] objectness logits
    valid: torch.Tensor   # [B, P]


def select_proposals(level_logits: Sequence[torch.Tensor],
                     level_deltas: Sequence[torch.Tensor],
                     level_anchors: Sequence[torch.Tensor],
                     cfg: ModelConfig, train: bool = False) -> Proposals:
    """Decode and filter RPN outputs into ``post_k`` proposals per image."""
    pre_k = cfg.rpn_pre_nms_topk_train if train else cfg.rpn_pre_nms_topk_test
    post_k = (cfg.rpn_post_nms_topk_train if train
              else cfg.rpn_post_nms_topk_test)
    cand_boxes, cand_scores, cand_valid = [], [], []
    for logits, deltas, anchors in zip(level_logits, level_deltas,
                                       level_anchors):
        kl = min(pre_k, logits.shape[-1])
        top, idx = stable_topk(logits, kl)                  # [B, kl]
        # Gather first, then cast the few entries kept (not the full grid).
        top = top.float()
        d = torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4)).float()
        boxes = box_ops.decode_boxes(d, anchors[idx])
        boxes = box_ops.clip_boxes(boxes, cfg.image_size)
        ok = box_ops.small_box_mask(boxes, cfg.rpn_min_size)
        if cfg.rpn_score_thresh > 0.0:
            t = float(cfg.rpn_score_thresh)
            ok &= top > math.log(t / (1.0 - t))
        cand_boxes.append(boxes)
        cand_scores.append(top)
        cand_valid.append(ok)
    # Levels with fewer anchors than pre_k (P6) pad to a common K with
    # NEG_INF scores and invalid flags, so all levels share one NMS launch.
    kmax = max(s.shape[-1] for s in cand_scores)
    boxes = torch.stack([F.pad(x, (0, 0, 0, kmax - x.shape[1]))
                         for x in cand_boxes], 1)           # [B, L, K, 4]
    scores = torch.stack([F.pad(x, (0, kmax - x.shape[1]), value=NEG_INF)
                          for x in cand_scores], 1)         # [B, L, K]
    valid = torch.stack([F.pad(x, (0, kmax - x.shape[1]))
                         for x in cand_valid], 1) & (scores > NEG_INF / 2)
    b, n_lvl = valid.shape[:2]
    # stable_topk left each level's candidates in score order.
    keep = nms_keep_segments(boxes.reshape(b * n_lvl, kmax, 4),
                             scores.reshape(b * n_lvl, kmax),
                             cfg.rpn_nms_thresh,
                             valid.reshape(b * n_lvl, kmax), presorted=True)
    flat_scores = torch.where((keep.reshape(b, -1) & valid.reshape(b, -1)),
                              scores.reshape(b, -1),
                              torch.full_like(scores.reshape(b, -1), NEG_INF))
    top, idx = stable_topk(flat_scores, post_k)
    out_valid = top > NEG_INF / 2
    out_boxes = torch.gather(boxes.reshape(b, -1, 4), 1,
                             idx[..., None].expand(-1, -1, 4))
    return Proposals(
        boxes=torch.where(out_valid[..., None], out_boxes,
                          torch.zeros_like(out_boxes)),
        scores=torch.where(out_valid, top, torch.zeros_like(top)),
        valid=out_valid)


def smooth_l1(x: torch.Tensor, beta: float) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * x * x / beta, ax - 0.5 * beta)


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise sigmoid cross-entropy, ``max(x, 0) - x z + log1p(e^-|x|)``
    (optax's formula)."""
    return (torch.clamp(logits, min=0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def rpn_losses(level_logits: Sequence[torch.Tensor],
               level_deltas: Sequence[torch.Tensor],
               all_anchors: torch.Tensor, gt_boxes: torch.Tensor,
               gt_valid: torch.Tensor, cfg: ModelConfig, u_pos: torch.Tensor,
               u_neg: torch.Tensor,
               img_weight: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RPN objectness and box losses, normalised like torchvision: sums
    over the sampled anchors of the batch over their count.

    ``all_anchors [N, 4]``; ``gt_boxes [B, G, 4]``, ``gt_valid [B, G]``;
    ``u_pos``/``u_neg [B, N]`` are the sampler's uniform draws.  Matching
    and sampling run without autograd (the ``[B, N, G]`` IoU is large);
    the losses are taken on the gathered ``rpn_batch_per_image`` entries.
    """
    logits = torch.cat(list(level_logits), dim=1)    # [B, N]
    deltas = torch.cat(list(level_deltas), dim=1)    # [B, N, 4]
    with torch.no_grad():
        iou = box_ops.box_iou(all_anchors[None], gt_boxes)
        m = matching.match(iou, gt_valid, cfg.rpn_fg_iou, cfg.rpn_bg_iou,
                           allow_low_quality=True)
        del iou
        samp = matching.balanced_sample_gather(
            m.labels, torch.ones_like(u_pos, dtype=torch.bool),
            cfg.rpn_batch_per_image, cfg.rpn_positive_fraction, u_pos, u_neg)
        sel_anchors = all_anchors[samp.idx]                      # [B, S, 4]
        gt_idx = torch.gather(m.matched_idx, 1, samp.idx)
        sel_gt = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
        targets = box_ops.encode_boxes(sel_gt, sel_anchors)
        w = samp.valid.float()
        pw = (samp.is_pos & samp.valid).float()
    # Gather the sampled entries, then cast (the head emits bf16).
    sel_logits = torch.gather(logits, 1, samp.idx).float()
    sel_deltas = torch.gather(deltas, 1,
                              samp.idx[..., None].expand(-1, -1, 4)).float()
    obj_sums = (sigmoid_bce(sel_logits, pw) * w).sum(-1)
    box_sums = (smooth_l1(sel_deltas - targets, 1.0 / 9.0).sum(-1)
                * pw).sum(-1)
    counts = w.sum(-1)
    if img_weight is not None:
        # Zero the wrap-around duplicate images a static-shape loader pads
        # its last batch with.
        obj_sums = obj_sums * img_weight
        box_sums = box_sums * img_weight
        counts = counts * img_weight
    total = counts.sum().clamp(min=1.0)
    return obj_sums.sum() / total, box_sums.sum() / total
