"""Multi-level anchor grids (numpy constants), torchvision semantics.

Counterpart of ``podtpu/ops/anchors.py``: zero-centred cell anchors of area
``size**2`` at the requested aspect ratios, tiled at ``stride`` offsets.
Within a level anchors are ordered (y, x, A), the order in which the RPN
head's outputs are flattened.  :func:`default_boxes` gives SSD's priors
(torchvision's ``DefaultBoxGenerator``) in the same order.
"""
from __future__ import annotations

import functools
import math
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


@functools.lru_cache(maxsize=32)
def default_boxes(
    image_size: Tuple[int, int],
    feature_shapes: Tuple[Tuple[int, int], ...],
    scales: Tuple[float, ...],
    aspect_ratios: Tuple[Tuple[float, ...], ...],
    steps: Tuple[int, ...] = (),
    clip: bool = True,
) -> Tuple[np.ndarray, ...]:
    """SSD's default boxes, one ``[Hk * Wk * A_k, 4]`` float32 xyxy array
    per level in pixels, location-major and anchor-minor.  A location of
    level ``k`` carries ``(s_k, s_k)``, ``(s', s')`` with ``s' =
    sqrt(s_k * s_{k+1})``, and ``(s_k * sqrt(a), s_k / sqrt(a))`` with its
    transpose for every ratio ``a`` (normalised widths and heights,
    clamped to [0, 1] with ``clip``), centred at ``(i + 0.5) / f_k``, where
    ``f_k`` is the grid's size or, with ``steps``, ``image_size /
    steps[k]``.  ``scales`` has one entry more than ``feature_shapes``."""
    H, W = image_size
    out = []
    for k, (fh, fw) in enumerate(feature_shapes):
        s_k = scales[k]
        s_prime = math.sqrt(scales[k] * scales[k + 1])
        pairs = [(s_k, s_k), (s_prime, s_prime)]
        for ar in aspect_ratios[k]:
            sq = math.sqrt(ar)
            pairs += [(s_k * sq, s_k / sq), (s_k / sq, s_k * sq)]
        wh = np.asarray(pairs, dtype=np.float32)
        if clip:
            wh = np.clip(wh, 0.0, 1.0)
        y_f, x_f = ((H / steps[k], W / steps[k]) if steps
                    else (float(fh), float(fw)))
        cx = (np.arange(fw, dtype=np.float32) + 0.5) / x_f
        cy = (np.arange(fh, dtype=np.float32) + 0.5) / y_f
        sx, sy = np.meshgrid(cx, cy)
        centers = np.stack([sx, sy], axis=-1).reshape(-1, 1, 2)
        boxes = np.concatenate([centers - 0.5 * wh[None],
                                centers + 0.5 * wh[None]], -1).reshape(-1, 4)
        boxes *= np.asarray([W, H, W, H], dtype=np.float32)
        out.append(boxes.astype(np.float32))
    return tuple(out)
