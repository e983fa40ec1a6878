"""Multi-level anchor grids (numpy constants), torchvision semantics.

Counterpart of ``podtpu/ops/anchors.py``: zero-centred cell anchors of area
``size**2`` at the requested aspect ratios, tiled at ``stride`` offsets.
Within a level anchors are ordered (y, x, A), the order in which the RPN
head's outputs are flattened.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

DEFAULT_SIZES = (32, 64, 128, 256, 512)
DEFAULT_RATIOS = (0.5, 1.0, 2.0)


def cell_anchors(size, aspect_ratios: Sequence[float]) -> np.ndarray:
    """Zero-centred ``[A, 4]`` xyxy anchors for one level, ratio-major and
    size-minor; half-extents are rounded after halving (torchvision)."""
    sizes = np.atleast_1d(np.asarray(size, dtype=np.float32))
    ratios = np.asarray(aspect_ratios, dtype=np.float32)
    h_ratios = np.sqrt(ratios)
    w_ratios = 1.0 / h_ratios
    hw = np.round(w_ratios[:, None] * sizes[None, :] / 2.0).reshape(-1)
    hh = np.round(h_ratios[:, None] * sizes[None, :] / 2.0).reshape(-1)
    return np.stack([-hw, -hh, hw, hh], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=32)
def grid_anchors(
    image_size: Tuple[int, int],
    strides: Tuple[int, ...] = (4, 8, 16, 32, 64),
    sizes: Tuple[float, ...] = DEFAULT_SIZES,
    aspect_ratios: Tuple[float, ...] = DEFAULT_RATIOS,
) -> Tuple[np.ndarray, ...]:
    """One ``[ceil(H/s) * ceil(W/s) * A, 4]`` float32 array per level."""
    H, W = image_size
    out = []
    for stride, size in zip(strides, sizes):
        base = cell_anchors(size, aspect_ratios)
        hl = -(-H // stride)
        wl = -(-W // stride)
        shift_x = np.arange(wl, dtype=np.float32) * stride
        shift_y = np.arange(hl, dtype=np.float32) * stride
        sx, sy = np.meshgrid(shift_x, shift_y)
        shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
        out.append((shifts + base[None, :, :]).reshape(-1, 4)
                   .astype(np.float32))
    return tuple(out)
