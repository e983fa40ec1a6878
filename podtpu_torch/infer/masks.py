"""Host-side mask utilities: paste box-local masks, trace polygon contours.

Counterpart of ``podtpu/infer/masks.py``, a numpy copy of it: torchvision's
``paste_masks_in_image`` and pycocotools' full-resolution RLE masks (the
reference's segm evaluation, `miso/object_detection/engine/coco_eval.py:
110-114`) become small numpy routines.  The mask head ran on the device;
pasting and tracing touch only the final detections of each image, so they
run on the host.  Pillow is imported only to rasterize a gt polygon.
"""
from __future__ import annotations

from typing import List

import numpy as np


def paste_mask(mask: np.ndarray, box: np.ndarray, out_h: int,
               out_w: int) -> np.ndarray:
    """Bilinearly resample a ``[M, M]`` box-local mask into an
    ``[out_h, out_w]`` canvas grid (float, 0 outside the box).

    ``box`` is xyxy in the OUTPUT grid's coordinate frame (torchvision's
    paste_masks_in_image semantics: the mask covers the box extent exactly,
    sampled at output-pixel centres).
    """
    out = np.zeros((out_h, out_w), np.float32)
    x0, y0, x1, y1 = [float(v) for v in box]
    if x1 <= x0 or y1 <= y0:
        return out
    m = mask.astype(np.float32)
    mh, mw = m.shape

    # Integer pixel range the box touches, clipped to the canvas.
    px0 = max(int(np.floor(x0)), 0)
    py0 = max(int(np.floor(y0)), 0)
    px1 = min(int(np.ceil(x1)), out_w)
    py1 = min(int(np.ceil(y1)), out_h)
    if px1 <= px0 or py1 <= py0:
        return out

    # Output pixel centres -> continuous mask coordinates in [0, mh/mw].
    ys = (np.arange(py0, py1, dtype=np.float32) + 0.5 - y0) \
        / (y1 - y0) * mh - 0.5
    xs = (np.arange(px0, px1, dtype=np.float32) + 0.5 - x0) \
        / (x1 - x0) * mw - 0.5

    y0i = np.clip(np.floor(ys).astype(np.int32), 0, mh - 1)
    x0i = np.clip(np.floor(xs).astype(np.int32), 0, mw - 1)
    y1i = np.clip(y0i + 1, 0, mh - 1)
    x1i = np.clip(x0i + 1, 0, mw - 1)
    wy = np.clip(ys - y0i, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0i, 0.0, 1.0)[None, :]

    patch = (m[np.ix_(y0i, x0i)] * (1 - wy) * (1 - wx)
             + m[np.ix_(y1i, x0i)] * wy * (1 - wx)
             + m[np.ix_(y0i, x1i)] * (1 - wy) * wx
             + m[np.ix_(y1i, x1i)] * wy * wx)
    # Zero contributions sampled outside the box interior.
    inside_y = (ys >= -0.5) & (ys <= mh - 0.5)
    inside_x = (xs >= -0.5) & (xs <= mw - 0.5)
    patch *= inside_y[:, None] * inside_x[None, :]
    out[py0:py1, px0:px1] = patch
    return out


def paste_masks(masks: np.ndarray, boxes: np.ndarray, out_h: int,
                out_w: int) -> np.ndarray:
    """``[N, M, M]`` masks + ``[N, 4]`` boxes -> ``[N, out_h, out_w]``."""
    return np.stack([paste_mask(m, b, out_h, out_w)
                     for m, b in zip(masks, boxes)]) \
        if len(masks) else np.zeros((0, out_h, out_w), np.float32)


class RegionMask:
    """A FULL-RESOLUTION instance mask stored only over its bounding window.

    This is the memory shape of pycocotools' RLE (the reference RLE-encodes
    masks at full image resolution for segm eval,
    `miso/object_detection/engine/coco_eval.py:110-114`): exact original-pixel
    IoU without ever materialising ``[N, H, W]`` canvases (300 detections at
    1024^2 would be gigabytes).  ``bitmap`` is bool ``[h, w]`` anchored at
    ``(y0, x0)`` in the full-resolution frame."""

    __slots__ = ("x0", "y0", "bitmap", "_area")

    def __init__(self, x0: int, y0: int, bitmap: np.ndarray):
        self.x0 = int(x0)
        self.y0 = int(y0)
        self.bitmap = np.asarray(bitmap, bool)
        self._area = None

    @property
    def area(self) -> int:
        if self._area is None:
            self._area = int(self.bitmap.sum())
        return self._area

    def intersection(self, other: "RegionMask") -> int:
        ax1 = self.x0 + self.bitmap.shape[1]
        ay1 = self.y0 + self.bitmap.shape[0]
        bx1 = other.x0 + other.bitmap.shape[1]
        by1 = other.y0 + other.bitmap.shape[0]
        x0, y0 = max(self.x0, other.x0), max(self.y0, other.y0)
        x1, y1 = min(ax1, bx1), min(ay1, by1)
        if x1 <= x0 or y1 <= y0:
            return 0
        a = self.bitmap[y0 - self.y0:y1 - self.y0, x0 - self.x0:x1 - self.x0]
        b = other.bitmap[y0 - other.y0:y1 - other.y0,
                         x0 - other.x0:x1 - other.x0]
        return int(np.count_nonzero(a & b))


def paste_region_mask(mask: np.ndarray, box: np.ndarray, out_h: int,
                      out_w: int, thresh: float = 0.5) -> RegionMask:
    """``paste_mask`` that keeps only the box-bounded window (binary)."""
    x0, y0, x1, y1 = [float(v) for v in box]
    px0 = min(max(int(np.floor(x0)), 0), out_w)
    py0 = min(max(int(np.floor(y0)), 0), out_h)
    px1 = max(min(int(np.ceil(x1)), out_w), px0)
    py1 = max(min(int(np.ceil(y1)), out_h), py0)
    if px1 <= px0 or py1 <= py0 or x1 <= x0 or y1 <= y0:
        return RegionMask(px0, py0, np.zeros((0, 0), bool))
    # Reuse paste_mask's sampling by pasting into a window-local canvas
    # whose frame is shifted by (px0, py0).
    local_box = np.asarray([x0 - px0, y0 - py0, x1 - px0, y1 - py0])
    window = paste_mask(mask, local_box, py1 - py0, px1 - px0)
    return RegionMask(px0, py0, window > thresh)


def paste_region_masks(masks: np.ndarray, boxes: np.ndarray, out_h: int,
                       out_w: int, thresh: float = 0.5) -> List[RegionMask]:
    return [paste_region_mask(m, b, out_h, out_w, thresh)
            for m, b in zip(masks, boxes)]


def rasterize_region(annotation, out_h: int, out_w: int) -> RegionMask:
    """Rasterize a gt annotation (polygon or rectangle) at FULL original
    resolution, bounded by its box.  Eval-side counterpart of the
    stride-downsampled training targets (``DetectionDataset._finish``)."""
    x0f, y0f, x1f, y1f = [float(v) for v in annotation.coords]
    px0 = min(max(int(np.floor(x0f)), 0), out_w)
    py0 = min(max(int(np.floor(y0f)), 0), out_h)
    px1 = max(min(int(np.ceil(x1f)), out_w), px0)
    py1 = max(min(int(np.ceil(y1f)), out_h), py0)
    h, w = py1 - py0, px1 - px0
    if h <= 0 or w <= 0:
        return RegionMask(px0, py0, np.zeros((0, 0), bool))
    xs = getattr(annotation, "xs", None)
    if xs is not None:  # polygon
        from PIL import Image, ImageDraw
        im = Image.new("L", (w, h), 0)
        pts = [(x - px0, y - py0)
               for x, y in zip(annotation.xs, annotation.ys)]
        if len(pts) >= 3:
            ImageDraw.Draw(im).polygon(pts, outline=1, fill=1)
        return RegionMask(px0, py0, np.asarray(im, bool))
    return RegionMask(px0, py0, np.ones((h, w), bool))  # filled rectangle


def region_mask_iou(a: List[RegionMask], b: List[RegionMask]) -> np.ndarray:
    """Pairwise IoU between two lists of :class:`RegionMask` (exact
    full-resolution mask IoU; zero-overlap windows short-circuit)."""
    iou = np.zeros((len(a), len(b)))
    for i, ra in enumerate(a):
        for j, rb in enumerate(b):
            inter = ra.intersection(rb)
            if inter:
                union = ra.area + rb.area - inter
                iou[i, j] = inter / union if union > 0 else 0.0
    return iou


def mask_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU between ``[N, H, W]`` and ``[M, H, W]`` boolean masks."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    af = a.reshape(len(a), -1).astype(np.float64)
    bf = b.reshape(len(b), -1).astype(np.float64)
    inter = af @ bf.T
    union = af.sum(1)[:, None] + bf.sum(1)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


# -- contour tracing ----------------------------------------------------------

# Moore-neighbourhood offsets, clockwise starting from west.
_NEIGHBOURS = np.array([(0, -1), (-1, -1), (-1, 0), (-1, 1),
                        (0, 1), (1, 1), (1, 0), (1, -1)], np.int32)


def _trace_boundary(grid: np.ndarray, start: tuple) -> np.ndarray:
    """Moore-neighbour boundary trace of the connected component containing
    ``start`` (a boundary pixel).  Returns ``[P, 2]`` (x, y) pixel coords."""
    h, w = grid.shape

    def on(p):
        y, x = p
        return 0 <= y < h and 0 <= x < w and grid[y, x]

    contour = [start]
    # Backtrack direction: we entered `start` scanning left-to-right, so the
    # previous (off) pixel is to the west.
    prev_dir = 0
    cur = start
    first_move = None  # direction of the very first step out of `start`
    for _ in range(4 * h * w):  # hard bound
        found = False
        # Search clockwise starting just after the backtrack direction.
        for k in range(1, 9):
            d = (prev_dir + k) % 8
            cand = (cur[0] + _NEIGHBOURS[d][0], cur[1] + _NEIGHBOURS[d][1])
            if on(cand):
                found = True
                break
        if not found:  # isolated pixel
            break
        # Jacob's stopping criterion: the walk is closed when, standing on
        # the start pixel again, the next move repeats the initial move.
        # A plain `cur == start` test truncates components whose boundary
        # passes through the start pixel more than once (two lobes joined
        # diagonally at the start).
        if cur == start and first_move is not None and d == first_move:
            break
        if cur == start and first_move is None:
            first_move = d
        # Resume the clockwise search just after the off-pixel we came
        # from (Moore tracing: back up one step).
        prev_dir = (d + 5) % 8
        cur = cand
        contour.append(cur)
    # The closed walk re-appends `start` on its final re-entry.
    if len(contour) > 1 and contour[-1] == contour[0]:
        contour.pop()
    return np.array([(x, y) for y, x in contour], np.float32)


def mask_to_polygons(bitmap: np.ndarray, threshold: float = 0.5,
                     min_area: float = 4.0) -> List[np.ndarray]:
    """Extract outer-boundary polygons from a float/bool mask.

    Returns a list of ``[P, 2]`` (x, y) arrays, one per connected component
    with area >= ``min_area`` pixels, largest first.  Boundary pixels are
    reported at pixel centres.
    """
    grid = np.asarray(bitmap) > threshold
    if not grid.any():
        return []
    h, w = grid.shape
    labels = np.zeros((h, w), np.int32)
    polys: List[np.ndarray] = []
    areas: List[float] = []
    next_label = 0
    for y in range(h):
        row = grid[y]
        for x in np.flatnonzero(row):
            if labels[y, x]:
                continue
            # Flood-fill the component (BFS, vectorised per frontier row).
            next_label += 1
            comp = _flood(grid, labels, (y, x), next_label)
            if comp < min_area:
                continue
            polys.append(_trace_boundary(grid, (y, x)))
            areas.append(comp)
    order = np.argsort(areas)[::-1]
    return [polys[i] for i in order]


def _flood(grid: np.ndarray, labels: np.ndarray, start: tuple,
           label: int) -> int:
    h, w = grid.shape
    stack = [start]
    labels[start] = label
    count = 0
    while stack:
        y, x = stack.pop()
        count += 1
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0),
                       (1, 1), (1, -1), (-1, 1), (-1, -1)):
            ny, nx = y + dy, x + dx
            if 0 <= ny < h and 0 <= nx < w and grid[ny, nx] \
                    and not labels[ny, nx]:
                labels[ny, nx] = label
                stack.append((ny, nx))
    return count
