"""Tiled sliding-window inference with cross-tile NMS.

Counterpart of ``podtpu/infer/tiled.py``: a scan of any size is cut into
overlapping canvas-sized tiles, batched through the model's eval forward
(every batch padded to ``batch_size`` with zero tiles, so the shapes stay
static), and merged:

* tiles overlap by a fraction of the canvas so that an object cut by one
  tile's edge is seen whole in a neighbour;
* detections whose centre lies in an edge tile's zero padding are dropped,
  the others are shifted into scan coordinates (a mask model's polygon
  too);
* duplicates from the overlaps are removed by class-aware greedy NMS on
  the host, in numpy (the survivors of the threshold are few), so its keep
  indices are the JAX package's exactly.

``tile_size`` rebuilds the model at another square canvas from the same
saved weights (anchors and clipping follow the canvas).  Spreading a tile
over several GPUs (``spatial_devices``) is not ported (ROADMAP.md, item
20).  ``infer_tiled`` runs on the GPU unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import List, Sequence, Tuple, Union

import numpy as np

from podtpu_torch.data.imageio import pil_to_rgb
from podtpu_torch.infer.inference import (build_inference_model,
                                          mask_to_annotation, resolve_device,
                                          split_eval_output)
from podtpu_torch.train.checkpoints import load_model


@dataclass
class TiledDetection:
    box: Tuple[float, float, float, float]  # xyxy in scan coordinates
    score: float
    label: int  # 1-based model label index
    # Mask models only: [P, 2] (x, y) polygon outline in scan coordinates
    # (largest connected component of the predicted instance mask).
    polygon: "np.ndarray" = None


def tile_origins(size: int, tile: int, stride: int) -> List[int]:
    """Start offsets covering ``size`` with ``tile``-sized windows."""
    if size <= tile:
        return [0]
    xs = list(range(0, size - tile, stride))
    xs.append(size - tile)  # final tile flush with the edge
    return xs


def greedy_nms(boxes: np.ndarray, scores: np.ndarray,
               iou_threshold: float) -> np.ndarray:
    """Greedy NMS on the host: indices of the kept boxes in descending
    (stable) score order; each kept box suppresses the later boxes whose
    IoU with it exceeds ``iou_threshold`` in one vector pass."""
    n = len(boxes)
    if n == 0:
        return np.zeros((0,), np.int64)
    order = np.argsort(-scores, kind="stable")
    b = boxes[order].astype(np.float32)
    areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    alive = np.ones(n, bool)
    keep: List[int] = []
    for i in range(n):
        if not alive[i]:
            continue
        keep.append(int(order[i]))
        if i + 1 == n:
            break
        rest = b[i + 1:]
        x1 = np.maximum(b[i, 0], rest[:, 0])
        y1 = np.maximum(b[i, 1], rest[:, 1])
        x2 = np.minimum(b[i, 2], rest[:, 2])
        y2 = np.minimum(b[i, 3], rest[:, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        union = areas[i] + areas[i + 1:] - inter
        iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
        alive[i + 1:] &= iou <= iou_threshold
    return np.asarray(keep, np.int64)


def cross_tile_nms(detections: Sequence[TiledDetection],
                   iou_threshold: float = 0.5) -> List[TiledDetection]:
    """Class-aware NMS across tile boundaries, sorted by score (stable)."""
    if not detections:
        return []
    boxes = np.asarray([d.box for d in detections], np.float64)
    scores = np.asarray([d.score for d in detections])
    labels = np.asarray([d.label for d in detections])
    out: List[TiledDetection] = []
    for cls in np.unique(labels):
        sel = np.flatnonzero(labels == cls)
        keep = greedy_nms(boxes[sel], scores[sel], iou_threshold)
        out.extend(detections[int(sel[k])] for k in keep)
    out.sort(key=lambda d: -d.score)
    return out


def infer_tiled(
    image: Union[str, np.ndarray],
    model_path: str,
    threshold: float = 0.5,
    overlap: float = 0.25,
    batch_size: int = 8,
    nms_threshold: float = 0.5,
    tile_size: int = None,
    spatial_devices: int = 1,
    device=None,
) -> List[TiledDetection]:
    """Detect objects in an arbitrarily large scan image.

    ``image``: path or ``[H, W, 3]`` array (uint8, another integer type,
    or float in [0, 1]).  ``model_path``: the model directory or a file in
    it.  ``tile_size``: the tile canvas, the model's own when None; an SSD
    model takes only its own (its default boxes are built on its canvas's
    ``ssd_feature_shapes``, which a new canvas does not recompute, in the
    JAX package either).  A keypoint model's keypoints are dropped; a mask
    model's detections carry polygons.
    """
    if spatial_devices > 1:
        raise NotImplementedError(
            "podtpu_torch does not port spatial_devices > 1 yet (ROADMAP.md, "
            "item 20: spatial partitioning)")
    dev = resolve_device(device)
    model_dir = str(Path(model_path).parent) if Path(model_path).suffix \
        else str(model_path)
    params, frozen, cfg, _labels = load_model(model_dir)
    if tile_size is not None and (tile_size, tile_size) != cfg.image_size:
        if cfg.family in ("ssd", "ssdlite"):
            raise ValueError(
                f"tile_size={tile_size}: a {cfg.family} model tiles only at "
                f"its own canvas {tuple(cfg.image_size)} (its default boxes "
                "follow ssd_feature_shapes, which are that canvas's)")
        cfg = dataclasses.replace(cfg, image_size=(tile_size, tile_size))
    forward, _ = build_inference_model(params, frozen, cfg, dev)
    th, tw = cfg.image_size
    assert th == tw, "tiled inference assumes a square canvas"
    tile = th
    stride = max(1, int(round(tile * (1.0 - overlap))))

    if isinstance(image, str):
        from PIL import Image

        with Image.open(image) as im:
            arr = pil_to_rgb(im)
    else:
        arr = np.asarray(image)
        if arr.dtype != np.uint8 and np.issubdtype(arr.dtype, np.integer):
            # Other integer scans (uint16 micrographs) are scaled by their
            # dtype's range: the model rescales only uint8.
            arr = (arr.astype(np.float32)
                   / float(np.iinfo(arr.dtype).max))
        elif arr.dtype != np.uint8:
            arr = arr.astype(np.float32)
    # uint8 tiles go to the device as they are (4x less transfer) and the
    # model normalises them there; float scans are taken to be in [0, 1].
    h, w = arr.shape[:2]
    origins = [(y, x) for y in tile_origins(h, tile, stride)
               for x in tile_origins(w, tile, stride)]

    detections: List[TiledDetection] = []
    for start in range(0, len(origins), batch_size):
        chunk = origins[start: start + batch_size]
        batch = np.zeros((batch_size, tile, tile, 3), arr.dtype)
        extents = []
        for bi, (y, x) in enumerate(chunk):
            sub = arr[y: y + tile, x: x + tile]
            batch[bi, : sub.shape[0], : sub.shape[1]] = sub
            extents.append((sub.shape[0], sub.shape[1]))
        det, out_masks, _ = split_eval_output(forward(batch))
        masks = None if out_masks is None \
            else out_masks.float().cpu().numpy()
        boxes = det.boxes.float().cpu().numpy()
        scores = det.scores.float().cpu().numpy()
        labels = det.labels.cpu().numpy()
        valid = det.valid.cpu().numpy()
        for bi, (y, x) in enumerate(chunk):
            keep = valid[bi] & (scores[bi] > threshold)
            # Drop detections whose centre falls in the zero-padded region
            # of an edge tile (phantom objects on the pad).
            sh, sw = extents[bi]
            cx = (boxes[bi][:, 0] + boxes[bi][:, 2]) / 2
            cy = (boxes[bi][:, 1] + boxes[bi][:, 3]) / 2
            keep &= (cx < sw) & (cy < sh)
            for j in np.flatnonzero(keep):
                b, s, lab = boxes[bi][j], scores[bi][j], labels[bi][j]
                poly = None
                if masks is not None:
                    # Box-local mask -> polygon in tile coordinates (the
                    # trace of infer()'s export), shifted into the scan.
                    ann = mask_to_annotation(masks[bi][j], b, "", float(s))
                    if ann is not None:
                        poly = np.stack([np.asarray(ann.xs) + x,
                                         np.asarray(ann.ys) + y], axis=1)
                detections.append(TiledDetection(
                    box=(float(b[0] + x), float(b[1] + y),
                         float(b[2] + x), float(b[3] + y)),
                    score=float(s), label=int(lab), polygon=poly))
    return cross_tile_nms(detections, nms_threshold)
