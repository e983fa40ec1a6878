"""Canvas fitting for detection inputs.

Counterpart of ``podtpu/data/dataset.py::fit_resize``.  OpenCV (or Pillow
where OpenCV is missing) is imported only when an image really needs
resizing, so a canvas-sized array is served with no image library.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def fit_resize(image: np.ndarray, canvas: Tuple[int, int]):
    """Aspect-preserving resize so ``image`` fits ``canvas``; returns the
    resized array and the scale.  An image already at its fitted size comes
    back unchanged."""
    h, w = image.shape[:2]
    ch, cw = canvas
    scale = min(ch / h, cw / w)
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    if (nh, nw) == (h, w):
        return image, scale
    try:
        import cv2
    except ImportError:
        from PIL import Image

        return np.asarray(Image.fromarray(image).resize(
            (nw, nh), Image.BILINEAR)), scale
    interp = cv2.INTER_LINEAR if scale >= 1 else cv2.INTER_AREA
    return cv2.resize(image, (nw, nh), interpolation=interp), scale
