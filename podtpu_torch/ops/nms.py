"""Non-maximum suppression: exact greedy keep masks with static shapes.

Counterpart of ``podtpu/ops/nms.py``.  Boxes are taken in order of masked
score, descending and stable (ties keep the lower index), and the keep mask
in that order is

    keep[i] = valid[i] and no j < i has keep[j] and IoU(j, i) > t

with invalid boxes neither kept nor suppressing.  On a CUDA tensor
:func:`nms_keep_batched` launches the hand-written kernel
(``csrc/nms.cu``), one launch for any number of segments, which reads the
boxes through the score order and writes the flags back to the boxes' own
slots; on a CPU tensor it runs :func:`nms_keep_plain`, the same function in
plain torch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from podtpu_torch.ops import _build
from podtpu_torch.ops.boxes import box_iou

NEG_INF = -1e10
KERNEL = "nms"
# Boxes a segment the kernel holds: the scan keeps three words' mask rows
# in shared memory (kMaxColBlocks in csrc/nms.cu).
MAX_BOXES = 9216


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


def _check_kernel_inputs(boxes: torch.Tensor, valid: torch.Tensor,
                         order: Optional[torch.Tensor]) -> None:
    """What the kernel takes beyond the function's own shapes and types:
    contiguous tensors, 16-byte aligned boxes, at most ``MAX_BOXES`` boxes
    a segment.  Raises ``ValueError`` naming the argument."""
    n = boxes.shape[1]
    if n > MAX_BOXES:
        raise ValueError(f"boxes: {n} boxes a segment, the kernel holds at "
                         f"most MAX_BOXES = {MAX_BOXES}")
    for name, x in (("boxes", boxes), ("valid", valid), ("order", order)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned")


def nms_keep_batched(boxes: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float,
                     order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Keep mask ``[S, N]`` of ``S`` segments of ``[S, N, 4]`` float32
    boxes with ``[S, N]`` bool validity.

    Without ``order`` the boxes are in score order and so is the mask.  With
    ``order`` (``[S, N]`` int64, a permutation of ``0..N-1`` per segment)
    box ``order[s, i]`` is the ``i``-th in score order, and the mask comes
    back in the boxes' own order.  CPU tensors take :func:`nms_keep_plain`;
    CUDA tensors launch the kernel, which reads and writes through
    ``order`` itself.
    """
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [S, N, 4], got {tuple(boxes.shape)}")
    if boxes.dtype != torch.float32:
        raise ValueError(f"boxes must be float32, got {boxes.dtype}")
    if valid.shape != boxes.shape[:2] or valid.dtype != torch.bool:
        raise ValueError("valid must be a [S, N] bool tensor")
    if order is not None and (order.shape != valid.shape
                              or order.dtype != torch.int64):
        raise ValueError(f"order must be a [S, N] int64 tensor, got "
                         f"{tuple(order.shape)} {order.dtype}")
    if any(x is not None and x.device != boxes.device for x in (valid, order)):
        raise ValueError("boxes, valid and order must be on one device")
    if boxes.device.type == "cpu":
        if order is None:
            return nms_keep_plain(boxes, valid, iou_threshold)
        sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        kept = nms_keep_plain(sboxes, torch.gather(valid, 1, order),
                              iou_threshold)
        return torch.zeros_like(kept).scatter_(1, order, kept)
    if boxes.device.type != "cuda":
        raise ValueError(f"boxes: unsupported device {boxes.device}")
    _check_kernel_inputs(boxes, valid, order)
    dev = boxes.device
    s, n = valid.shape
    if s == 0 or n == 0:
        return torch.empty((s, n), dtype=torch.bool, device=dev)
    lib = _build.library()
    keep = torch.empty((s, n), dtype=torch.bool, device=dev)
    scratch = torch.empty((s, lib.podtpu_nms_scratch_words(n)),
                          dtype=torch.int64, device=dev)
    status = lib.podtpu_nms_keep(
        boxes.data_ptr(), valid.data_ptr(),
        None if order is None else order.data_ptr(), scratch.data_ptr(),
        keep.data_ptr(), s, n, float(iou_threshold), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
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
                      valid: Optional[torch.Tensor] = None,
                      presorted: bool = False) -> torch.Tensor:
    """Greedy NMS over ``S`` independent segments: ``[S, N, 4]`` boxes and
    ``[S, N]`` scores -> ``[S, N]`` keep mask in the original box order.
    One kernel launch covers every segment.

    ``presorted=True`` says that each segment's scores already descend with
    ties in index order (``stable_topk``'s output), so no sort runs and
    ``scores`` is not read.  Invalid boxes may sit anywhere: they neither
    keep nor suppress, so moving them to the end would change no flag."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    order = None if presorted else sort_by_score(scores, valid)
    return nms_keep_batched(boxes.float().contiguous(), valid.contiguous(),
                            iou_threshold, order)


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
