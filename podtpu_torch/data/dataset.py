"""Host-side detection dataset: decode, fit-resize, pad, fixed-shape targets.

Counterpart of ``podtpu/data/dataset.py`` (``Sample``, ``fit_resize``,
``DetectionDataset``, ``train_test_split``, ``collate``).  Every sample is
fit-resized (aspect-preserving) onto a fixed canvas and padded bottom/right;
targets are fixed-capacity ``[max_gt]`` arrays with a validity mask, and the
resize scale is kept so detections map back to original image coordinates.

:meth:`DetectionDataset.load_batch` decodes a batch through the native C++
host library (:mod:`podtpu_torch.core.native`), as the JAX package does.
Where that library is unavailable or an image of the batch fails to decode,
the batch falls back to the per-sample path: decode through
:func:`podtpu_torch.data.imageio.read_rgb` (looked up on the module at each
call, so a caller can replace the decoder) and :func:`fit_resize`.  OpenCV
(or Pillow where OpenCV is missing) is imported only when an image really
needs resizing, so a canvas-sized image needs no image library.  With
``with_masks`` each gt also gets a float32 mask target at 1/``mask_stride``
of the canvas, rasterized from its polygon (Pillow) or filled over its
rectangle.  With ``with_keypoints`` each gt gets its ``[K, 3]`` (x, y,
visibility) keypoints in canvas coordinates, from annotations that carry
``keypoints`` (all invisible where one carries none); a point scaled off
the canvas becomes invisible.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from podtpu_torch.core import native
from podtpu_torch.data import imageio
from podtpu_torch.data.project import Project


@dataclass
class Sample:
    image: np.ndarray        # [H, W, 3] uint8, canvas-sized
    boxes: np.ndarray        # [G, 4] float32 xyxy, canvas coords
    labels: np.ndarray       # [G] int32, 1-based; 0 on invalid slots
    valid: np.ndarray        # [G] bool
    scale: float             # canvas px per original px
    original_size: Tuple[int, int]  # (h, w)
    index: int
    masks: Optional[np.ndarray] = None  # [G, H/ms, W/ms] float32 bitmaps
    # [G, K, 3] float32 (x, y, visibility) in canvas coords; visibility 0
    # also marks padded slots.
    keypoints: Optional[np.ndarray] = None
    # False when the image failed to decode: the sample is a zero canvas
    # with no gt, and the loader folds it into batch_valid so training and
    # evaluation ignore it.
    ok: bool = True


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


class DetectionDataset:
    """Fixed-shape samples from a :class:`Project`."""

    def __init__(
        self,
        project: Project,
        image_size: Tuple[int, int] = (1024, 1024),
        max_gt: int = 100,
        label_names: Optional[Sequence[str]] = None,
        with_masks: bool = False,
        mask_stride: int = 8,
        with_keypoints: bool = False,
        num_keypoints: int = 17,
        cache: object = "auto",
        cache_budget_bytes: Optional[int] = None,
    ):
        self.project = project
        self.images = list(project.image_dict.values())
        self.image_size = tuple(image_size)
        self.max_gt = max_gt
        # Mask R-CNN targets: per-gt planes at 1/mask_stride of the canvas.
        self.with_masks = with_masks
        self.mask_stride = mask_stride
        # Keypoint R-CNN targets: per-gt (x, y, visibility) triples.
        self.with_keypoints = with_keypoints
        self.num_keypoints = num_keypoints
        # Label -> 1-based index (background = 0).
        names = list(label_names) if label_names is not None \
            else list(project.label_names)
        self.label_names = names
        self.label_to_index = {n: i + 1 for i, n in enumerate(names)}
        # Decoded-canvas cache: samples are deterministic per index
        # (augmentation runs in the train step), so later epochs skip the
        # decode.  True / False / "auto" (on when the whole dataset fits
        # ``cache_budget_bytes``, default 2 GiB or $PODTPU_CACHE_BYTES).
        budget = cache_budget_bytes if cache_budget_bytes is not None else \
            int(os.environ.get("PODTPU_CACHE_BYTES", 2 << 30))
        ch, cw = self.image_size
        per_sample = ch * cw * 3 + max_gt * 16
        if with_masks:
            per_sample += 4 * max_gt * (ch // mask_stride) * (
                cw // mask_stride)
        fits = len(self.images) * per_sample <= budget
        enabled = (cache is True) or (cache == "auto" and fits)
        self._cache: Optional[Dict[int, Sample]] = {} if enabled else None
        self._warned: set = set()

    def __len__(self) -> int:
        return len(self.images)

    def _failed(self, meta, i) -> Sample:
        if meta.full_path not in self._warned:
            self._warned.add(meta.full_path)
            print(f"[podtpu] could not decode {meta.full_path}; "
                  "skipping image")
        ch, cw = self.image_size
        g = self.max_gt
        mh, mw = ch // self.mask_stride, cw // self.mask_stride
        return Sample(
            image=np.zeros((ch, cw, 3), np.uint8),
            boxes=np.zeros((g, 4), np.float32),
            labels=np.zeros((g,), np.int32),
            valid=np.zeros((g,), bool), scale=1.0, original_size=(ch, cw),
            index=i, ok=False,
            masks=np.zeros((g, mh, mw), np.float32) if self.with_masks
            else None,
            keypoints=np.zeros((g, self.num_keypoints, 3), np.float32)
            if self.with_keypoints else None)

    def load(self, i: int) -> Sample:
        if self._cache is not None and i in self._cache:
            return self._cache[i]
        meta = self.images[i]
        try:
            arr = imageio.read_rgb(meta.full_path)
        except Exception:  # any unreadable file becomes an ok=False sample
            sample = self._failed(meta, i)
        else:
            orig_h, orig_w = arr.shape[:2]
            resized, scale = fit_resize(arr, self.image_size)
            ch, cw = self.image_size
            # Canvases stay uint8; the step converts to [0, 1] on the device.
            canvas = np.zeros((ch, cw, 3), np.uint8)
            canvas[: resized.shape[0], : resized.shape[1]] = resized
            sample = self._finish(meta, canvas, scale, (orig_h, orig_w), i)
        if self._cache is not None:
            self._cache[i] = sample
        return sample

    def _finish(self, meta, canvas, scale, original_size, i) -> Sample:
        ch, cw = self.image_size
        g = self.max_gt
        boxes = np.zeros((g, 4), np.float32)
        labels = np.zeros((g,), np.int32)
        valid = np.zeros((g,), bool)
        kept = [b for b in meta.boxes if b.label in self.label_to_index][:g]
        for j, box in enumerate(kept):
            x1, y1, x2, y2 = box.coords
            boxes[j] = np.array([x1, y1, x2, y2]) * scale
            labels[j] = self.label_to_index[box.label]
            valid[j] = True
        np.clip(boxes[:, 0::2], 0, cw, out=boxes[:, 0::2])
        np.clip(boxes[:, 1::2], 0, ch, out=boxes[:, 1::2])
        masks = None
        if self.with_masks:
            mh, mw = ch // self.mask_stride, cw // self.mask_stride
            masks = np.zeros((g, mh, mw), np.float32)
            mscale = scale / self.mask_stride
            for j, box in enumerate(kept):
                if hasattr(box, "rasterize"):
                    masks[j] = box.rasterize(mh, mw, scale=mscale)
                else:  # rectangle: filled box
                    x1, y1, x2, y2 = np.asarray(box.coords) * mscale
                    masks[j,
                          int(max(y1, 0)): int(min(np.ceil(y2), mh)),
                          int(max(x1, 0)): int(min(np.ceil(x2), mw))] = 1.0
        keypoints = None
        if self.with_keypoints:
            k = self.num_keypoints
            keypoints = np.zeros((g, k, 3), np.float32)
            for j, box in enumerate(kept):
                kp = getattr(box, "keypoints", None)
                if not kp:
                    continue
                arr = np.asarray(kp, np.float32).reshape(-1, 3)[:k].copy()
                arr[:, :2] *= scale
                off = ((arr[:, 0] < 0) | (arr[:, 0] >= cw)
                       | (arr[:, 1] < 0) | (arr[:, 1] >= ch))
                arr[off, 2] = 0.0
                keypoints[j, : arr.shape[0]] = arr
        return Sample(image=canvas, boxes=boxes, labels=labels, valid=valid,
                      scale=scale, original_size=tuple(original_size),
                      index=i, masks=masks, keypoints=keypoints)

    def load_batch(self, indices) -> List[Sample]:
        """The samples of ``indices``: cached ones from the cache, the rest
        decoded as one batch by the native library, or one by one through
        :meth:`load` when it returns None."""
        indices = [int(i) for i in indices]
        todo = indices if self._cache is None else \
            [i for i in indices if i not in self._cache]
        fresh: Dict[int, Sample] = {}
        if todo:
            metas = [self.images[i] for i in todo]
            res = native.decode_resize_batch([m.full_path for m in metas],
                                             self.image_size)
            if res is None:
                for i in todo:
                    fresh[i] = self.load(i)
            else:
                canvases, scales, orig_hw = res
                for j, (meta, idx) in enumerate(zip(metas, todo)):
                    fresh[idx] = self._finish(
                        meta, canvases[j], float(scales[j]),
                        (int(orig_hw[j, 0]), int(orig_hw[j, 1])), idx)
                if self._cache is not None:
                    self._cache.update(fresh)
        return [fresh[i] if i in fresh else self._cache[i] for i in indices]


def train_test_split(
    n: int, fraction: float = 0.2, seed: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Random split: last ``fraction`` of a seeded permutation is the test
    set (the reference's scheme, `miso/object_detection/training.py:53-57`:
    fixed seed 1, 20 % test)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    k = int(fraction * n)
    if k == 0:
        return perm, perm[:0]
    return perm[:-k], perm[-k:]


def collate(samples: Sequence[Sample]) -> Dict[str, np.ndarray]:
    """Stack samples into one fixed-shape batch dict (with ``masks`` and
    ``keypoints`` when the samples carry those targets)."""
    batch = {
        "image": np.stack([s.image for s in samples]),
        "boxes": np.stack([s.boxes for s in samples]),
        "labels": np.stack([s.labels for s in samples]),
        "valid": np.stack([s.valid for s in samples]),
        "scale": np.asarray([s.scale for s in samples], np.float32),
        "original_size": np.asarray([s.original_size for s in samples],
                                    np.int32),
        "index": np.asarray([s.index for s in samples], np.int32),
    }
    if samples[0].masks is not None:
        batch["masks"] = np.stack([s.masks for s in samples])
    if samples[0].keypoints is not None:
        batch["keypoints"] = np.stack([s.keypoints for s in samples])
    return batch
