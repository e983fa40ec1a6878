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
