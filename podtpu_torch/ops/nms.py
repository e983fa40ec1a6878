"""Non-maximum suppression: exact greedy keep masks with static shapes.

Counterpart of ``podtpu/ops/nms.py``.  Boxes are sorted by masked score,
descending and stable (ties keep the lower index), and the keep mask of the
sorted boxes is

    keep[i] = valid[i] and no j < i has keep[j] and IoU(j, i) > t

with invalid boxes neither kept nor suppressing.  On a CUDA tensor
:func:`nms_keep_batched` launches the hand-written kernel
(``csrc/nms.cu``), one launch for any number of segments; on a CPU tensor it
runs :func:`nms_keep_plain`, the same function in plain torch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from podtpu_torch.ops import _build
from podtpu_torch.ops.boxes import box_iou

NEG_INF = -1e10
KERNEL = "nms"


def nms_keep_plain(sorted_boxes: torch.Tensor, valid: torch.Tensor,
                   iou_threshold: float) -> torch.Tensor:
    """Keep mask ``[S, N]`` of score-sorted ``[S, N, 4]`` boxes, as the
    fixpoint of ``keep <- valid & !any_j(suppress[i, j] & keep[j])``.  The
    map is triangular in sorted order, so the iteration reaches the greedy
    solution in at most (suppression chain depth) steps."""
    n = sorted_boxes.shape[-2]
    iou = box_iou(sorted_boxes, sorted_boxes)
    idx = torch.arange(n, device=sorted_boxes.device)
    suppress = ((iou > iou_threshold) & (idx[None, :] < idx[:, None])
                & valid[..., None, :] & valid[..., :, None])
    keep = valid.clone()
    while True:
        hit = (suppress & keep[..., None, :]).any(dim=-1)
        new_keep = valid & ~hit
        if torch.equal(new_keep, keep):
            return keep
        keep = new_keep


def nms_keep_batched(sorted_boxes: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """Keep mask ``[S, N]`` (sorted order) of ``S`` segments of score-sorted
    ``[S, N, 4]`` float32 boxes with ``[S, N]`` bool validity.

    CPU tensors take :func:`nms_keep_plain`; CUDA tensors launch the kernel.
    """
    if sorted_boxes.dim() != 3 or sorted_boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [S, N, 4], got "
                         f"{tuple(sorted_boxes.shape)}")
    if valid.shape != sorted_boxes.shape[:2] or valid.dtype != torch.bool:
        raise ValueError("valid must be a [S, N] bool tensor")
    if sorted_boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {sorted_boxes.dtype}")
    if sorted_boxes.device != valid.device:
        raise ValueError("boxes and valid must be on one device")
    if sorted_boxes.device.type == "cpu":
        return nms_keep_plain(sorted_boxes, valid, iou_threshold)
    if sorted_boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {sorted_boxes.device}")
    boxes = sorted_boxes.contiguous()
    valid = valid.contiguous()
    s, n = valid.shape
    keep = torch.empty((s, n), dtype=torch.bool, device=boxes.device)
    if s == 0 or n == 0:
        return keep
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned")
    col_blocks = (n + 63) // 64
    mask = torch.empty((s, n, col_blocks), dtype=torch.int64,
                       device=boxes.device)
    lib = _build.library()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.podtpu_nms_keep(
            boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(),
            keep.data_ptr(), s, n, float(iou_threshold), stream)
    _build.check(status, "nms kernel")
    _build.count_launch(KERNEL)
    return keep


def sort_by_score(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Descending stable order of ``scores`` with invalid entries last
    (masked to ``NEG_INF``), along the last axis."""
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    return torch.sort(masked, dim=-1, descending=True, stable=True).indices


def nms_keep_segments(boxes: torch.Tensor, scores: torch.Tensor,
                      iou_threshold: float,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy NMS over ``S`` independent segments: ``[S, N, 4]`` boxes and
    ``[S, N]`` scores -> ``[S, N]`` keep mask in the original box order.
    One kernel launch covers every segment."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    order = sort_by_score(scores, valid)
    sboxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    svalid = torch.gather(valid, -1, order)
    keep_sorted = nms_keep_batched(sboxes.float(), svalid, iou_threshold)
    return torch.zeros_like(keep_sorted).scatter_(-1, order, keep_sorted)


def nms_keep(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy NMS keep mask ``[N]`` over ``[N, 4]`` xyxy boxes, in the
    original box order."""
    v = None if valid is None else valid[None]
    return nms_keep_segments(boxes[None], scores[None], iou_threshold, v)[0]


def topk_by_score(scores: torch.Tensor, keep: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices ``[..., k]`` of the top-``k`` kept entries by score, ties to
    the lower index (``lax.top_k``'s order), and their validity."""
    masked = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    top, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    return idx[..., :k], top[..., :k] > NEG_INF / 2


def nms_select(boxes: torch.Tensor, scores: torch.Tensor,
               iou_threshold: float, k: int,
               valid: Optional[torch.Tensor] = None,
               idxs: Optional[torch.Tensor] = None):
    """NMS then top-k: fixed-size ``(boxes[k, 4], scores[k], valid[k])``.
    With ``idxs``, boxes of different categories never suppress each other
    (torchvision's coordinate-offset trick)."""
    if idxs is not None and boxes.shape[0]:
        coords = boxes if valid is None else torch.where(
            valid[:, None], boxes, torch.zeros_like(boxes))
        offsets = idxs.to(boxes.dtype) * (coords.max() + 1.0)
        keep = nms_keep(boxes + offsets[:, None], scores, iou_threshold,
                        valid)
    else:
        keep = nms_keep(boxes, scores, iou_threshold, valid)
    idx, out_valid = topk_by_score(scores, keep, k)
    out_boxes = torch.where(out_valid[:, None], boxes[idx],
                            torch.zeros((), dtype=boxes.dtype,
                                        device=boxes.device))
    out_scores = torch.where(out_valid, scores[idx],
                             torch.zeros((), dtype=scores.dtype,
                                         device=scores.device))
    return out_boxes, out_scores, out_valid
