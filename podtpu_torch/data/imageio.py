"""Image decode helpers: high-bit-depth-safe RGB conversion.

Counterpart of ``podtpu/data/imageio.py``.  Pillow is imported only inside
:func:`read_rgb`; :func:`pil_to_rgb` works on an image object the caller
already opened.
"""
from __future__ import annotations

import numpy as np

# Modes whose samples exceed 8 bits: convert("RGB") would clip them.
_HIGH_DEPTH_MODES = ("I;16", "I;16B", "I;16L", "I;16N", "I", "F")


def pil_to_rgb(im) -> np.ndarray:
    """``[H, W, 3]`` uint8 RGB from a PIL image of any mode: 16-bit modes
    are scaled by 1/65535, ``I`` and ``F`` by their observed maximum."""
    if im.mode in _HIGH_DEPTH_MODES:
        arr = np.asarray(im, dtype=np.float32)
        if im.mode.startswith("I;16"):
            scale = 65535.0
        else:
            scale = float(max(arr.max(), 1.0))
        arr8 = (np.clip(arr / scale, 0.0, 1.0) * 255.0 + 0.5).astype(
            np.uint8)
        if arr8.ndim == 2:
            arr8 = np.repeat(arr8[..., None], 3, axis=2)
        return np.ascontiguousarray(arr8[..., :3])
    return np.asarray(im.convert("RGB"))


def read_rgb(path: str) -> np.ndarray:
    """Decode an image file to ``[H, W, 3]`` uint8 RGB (16-bit safe)."""
    from PIL import Image

    with Image.open(path) as im:
        return pil_to_rgb(im)
