"""Target assignment: IoU matcher and balanced positive/negative sampler.

Counterpart of ``podtpu/ops/matching.py`` (``match``,
``balanced_sample_gather``), batched over any leading axes.  The samplers'
uniform draws are arguments (``u_pos``, ``u_neg``, one per candidate), so a
caller can feed the draws another framework made; ``lax.top_k``'s order is
kept by a stable descending sort (ties to the lower index) and
``jnp.argmax``'s by ``torch.argmax`` (the first maximum).  The JAX
package's ``approx_topk`` is a TPU approximation; the port takes exact
top-k.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last axis, descending, ties to the lower index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class MatchResult(NamedTuple):
    matched_idx: torch.Tensor  # [..., N] index of the best gt (int64)
    labels: torch.Tensor       # [..., N] +1 fg / 0 bg / -1 ignore


def match(iou: torch.Tensor, gt_valid: torch.Tensor, high_thresh: float,
          low_thresh: float, allow_low_quality: bool = False) -> MatchResult:
    """Assign each of N candidates to one of M gts by ``[..., N, M]`` IoU;
    ``gt_valid [..., M]`` marks real gt boxes.  With ``allow_low_quality``,
    every candidate that ties a gt's best (positive) IoU is foreground."""
    valid = gt_valid[..., None, :]
    iou = torch.where(valid, iou, torch.full_like(iou, -1.0))
    matched_val = iou.max(dim=-1).values
    matched_idx = torch.argmax(iou, dim=-1)
    labels = torch.where(matched_val >= high_thresh, 1,
                         torch.where(matched_val >= low_thresh, -1, 0))
    if allow_low_quality:
        best_per_gt = iou.max(dim=-2, keepdim=True).values   # [..., 1, M]
        is_best = (iou == best_per_gt) & (best_per_gt > 0) & valid
        labels = torch.where(is_best.any(dim=-1), 1, labels)
    labels = torch.where(gt_valid.any(dim=-1, keepdim=True), labels, 0)
    return MatchResult(matched_idx=matched_idx, labels=labels)


class GatheredSample(NamedTuple):
    idx: torch.Tensor     # [..., batch] candidate indices, positives first
    valid: torch.Tensor   # [..., batch] slot validity
    is_pos: torch.Tensor  # [..., batch] positive-slot mask


def balanced_sample_gather(labels: torch.Tensor,
                           candidate_valid: torch.Tensor, batch: int,
                           positive_fraction: float, u_pos: torch.Tensor,
                           u_neg: torch.Tensor) -> GatheredSample:
    """Random balanced subsample as a compacted fixed-size index list: at
    most ``batch`` candidates, at most ``positive_fraction`` positive, the
    positives and negatives with the largest draws.  The positive slots,
    then the negative slots, with the sampled ones moved first by a stable
    sort and the first ``batch`` kept."""
    n = labels.shape[-1]
    pos_mask = (labels == 1) & candidate_valid
    neg_mask = (labels == 0) & candidate_valid
    max_pos = int(round(batch * positive_fraction))
    num_pos = pos_mask.sum(-1, keepdim=True).clamp(max=max_pos)
    num_neg = torch.minimum(neg_mask.sum(-1, keepdim=True), batch - num_pos)
    pos_scores = torch.where(pos_mask, u_pos, torch.full_like(u_pos, -1.0))
    neg_scores = torch.where(neg_mask, u_neg, torch.full_like(u_neg, -1.0))
    pos_top, pos_idx = stable_topk(pos_scores, min(max_pos, n))
    neg_top, neg_idx = stable_topk(neg_scores, min(batch, n))
    slot_p = torch.arange(pos_idx.shape[-1], device=labels.device)
    slot_n = torch.arange(neg_idx.shape[-1], device=labels.device)
    pos_sel = (slot_p < num_pos) & (pos_top > 0)
    neg_sel = (slot_n < num_neg) & (neg_top > 0)
    all_idx = torch.cat([pos_idx, neg_idx], -1)
    all_valid = torch.cat([pos_sel, neg_sel], -1)
    all_is_pos = torch.cat([torch.ones_like(pos_sel),
                            torch.zeros_like(neg_sel)], -1)
    order = torch.sort((~all_valid).to(torch.uint8), dim=-1,
                       stable=True).indices[..., :batch]
    valid = torch.gather(all_valid, -1, order)
    return GatheredSample(idx=torch.gather(all_idx, -1, order), valid=valid,
                          is_pos=torch.gather(all_is_pos, -1, order) & valid)
