"""Box geometry on ``[..., 4]`` xyxy tensors.

Counterpart of ``podtpu/ops/boxes.py``; each function repeats the JAX
arithmetic in the same order, so float32 results agree to rounding.
"""
from __future__ import annotations

import math

import torch

# torchvision clips predicted log-size deltas at log(1000/16).
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of ``[..., N, 4]`` and ``[..., M, 4]`` -> ``[..., N, M]``;
    0 where the union is empty."""
    ix = (torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
          - torch.maximum(a[..., :, None, 0], b[..., None, :, 0]))
    iy = (torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
          - torch.maximum(a[..., :, None, 1], b[..., None, :, 1]))
    inter = ix.clamp(min=0.0) * iy.clamp(min=0.0)
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def encode_boxes(reference: torch.Tensor, proposals: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """(dx, dy, dw, dh) regression targets of ``reference`` boxes relative
    to ``proposals``; proposal and target sizes are floored at 1e-6."""
    wx, wy, ww, wh = weights
    pw = proposals[..., 2] - proposals[..., 0]
    ph = proposals[..., 3] - proposals[..., 1]
    pcx = proposals[..., 0] + 0.5 * pw
    pcy = proposals[..., 1] + 0.5 * ph
    gw = reference[..., 2] - reference[..., 0]
    gh = reference[..., 3] - reference[..., 1]
    gcx = reference[..., 0] + 0.5 * gw
    gcy = reference[..., 1] + 0.5 * gh
    pw = pw.clamp(min=1e-6)
    ph = ph.clamp(min=1e-6)
    dx = wx * (gcx - pcx) / pw
    dy = wy * (gcy - pcy) / ph
    dw = ww * torch.log(gw.clamp(min=1e-6) / pw)
    dh = wh * torch.log(gh.clamp(min=1e-6) / ph)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_boxes(codes: torch.Tensor, anchors: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0),
                 clip: float = BBOX_XFORM_CLIP) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) deltas to anchors; log-size deltas are clipped
    at ``clip``."""
    wx, wy, ww, wh = weights
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    acx = anchors[..., 0] + 0.5 * aw
    acy = anchors[..., 1] + 0.5 * ah
    dx = codes[..., 0] / wx
    dy = codes[..., 1] / wy
    dw = torch.clamp(codes[..., 2] / ww, max=clip)
    dh = torch.clamp(codes[..., 3] / wh, max=clip)
    cx = dx * aw + acx
    cy = dy * ah + acy
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_center_size(boxes: torch.Tensor):
    """(cx, cy, w, h) of xyxy boxes."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h, w, h


def encode_boxes_linear(anchors: torch.Tensor, boxes: torch.Tensor,
                        normalize_by_size: bool = True) -> torch.Tensor:
    """(l, t, r, b) distances from each anchor's centre to the sides of the
    paired box, divided by the anchor's width and height (floored at 1e-6)
    with ``normalize_by_size`` (torchvision's ``BoxLinearCoder``, FCOS's
    coder); the two broadcast on the leading axes."""
    acx, acy, aw, ah = box_center_size(anchors)
    codes = torch.stack([acx - boxes[..., 0], acy - boxes[..., 1],
                         boxes[..., 2] - acx, boxes[..., 3] - acy], dim=-1)
    if normalize_by_size:
        codes = codes / torch.stack([aw, ah, aw, ah], dim=-1).clamp(min=1e-6)
    return codes


def decode_boxes_linear(codes: torch.Tensor, anchors: torch.Tensor,
                        normalize_by_size: bool = True) -> torch.Tensor:
    """Invert :func:`encode_boxes_linear`: xyxy boxes from (l, t, r, b)."""
    acx, acy, aw, ah = box_center_size(anchors)
    if normalize_by_size:
        codes = codes * torch.stack([aw, ah, aw, ah], dim=-1)
    return torch.stack([acx - codes[..., 0], acy - codes[..., 1],
                        acx + codes[..., 2], acy + codes[..., 3]], dim=-1)


def elementwise_giou(a: torch.Tensor, b: torch.Tensor,
                     eps: float = 1e-7) -> torch.Tensor:
    """Generalised IoU of paired ``[..., 4]`` boxes (the loss is ``1 -
    giou``); ``eps`` in both divisions keeps value and gradient finite on
    zero-area boxes, since callers mask slots by multiplication."""
    ix = (torch.minimum(a[..., 2], b[..., 2])
          - torch.maximum(a[..., 0], b[..., 0]))
    iy = (torch.minimum(a[..., 3], b[..., 3])
          - torch.maximum(a[..., 1], b[..., 1]))
    # jnp.clip's maximum: a gradient at 0 splits as JAX's does.
    zero = ix.new_zeros(())
    inter = torch.maximum(ix, zero) * torch.maximum(iy, zero)
    union = box_area(a) + box_area(b) - inter
    iou = inter / (union + eps)
    ex = (torch.maximum(a[..., 2], b[..., 2])
          - torch.minimum(a[..., 0], b[..., 0]))
    ey = (torch.maximum(a[..., 3], b[..., 3])
          - torch.minimum(a[..., 1], b[..., 1]))
    enclose = ex * ey
    return iou - (enclose - union) / (enclose + eps)


def clip_boxes(boxes: torch.Tensor, image_size) -> torch.Tensor:
    """Clip to ``[0, W] x [0, H]``; ``image_size`` is (H, W)."""
    h, w = image_size
    return torch.stack([boxes[..., 0].clamp(0.0, w),
                        boxes[..., 1].clamp(0.0, h),
                        boxes[..., 2].clamp(0.0, w),
                        boxes[..., 3].clamp(0.0, h)], dim=-1)


def small_box_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """True where width AND height are >= ``min_size`` (callers AND it into
    their validity masks instead of filtering)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w >= min_size) & (h >= min_size)
