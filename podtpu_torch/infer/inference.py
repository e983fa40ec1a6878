"""Model loading and batch inference: auto-annotate a project or a
directory.

Counterpart of ``podtpu/infer/inference.py`` (``load_inference_model``,
``infer``, ``infer_directory``) and of
``podtpu/train/step.py::make_eval_step``/``split_eval_output``, with the
reference's contract (`miso/object_detection/inference.py:16-131`):

* ``infer``: optional ``_NV`` label suffix, the labels added to the
  caller's project, only images with no annotations are run, and each
  detection with ``score > threshold`` becomes a ``RectangleAnnotation``
  labelled ``model_labels[label - 1]`` in original-image pixels (for a mask
  model a ``PolygonAnnotation`` traced around the largest component of its
  mask, or the rectangle when the mask is empty; for a keypoint model the
  rectangle carries its ``(x, y, score)`` keypoints in original-image
  pixels); returns a new project holding only the detections;
* ``infer_directory``: the project is every jpg/jpeg/png/bmp/tiff/tif file
  under a directory, recursively, then the same loop.

Entry points run on the GPU unless the caller passes ``device="cpu"``; with
no GPU and no explicit device they raise rather than fall back to the CPU.
"""
from __future__ import annotations

import copy
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from podtpu_torch.core.device import resolve_device
from podtpu_torch.data.annotation import (PolygonAnnotation,
                                          RectangleAnnotation)
from podtpu_torch.data.dataset import DetectionDataset
from podtpu_torch.data.image import ImageMetadata
from podtpu_torch.data.loader import Loader
from podtpu_torch.data.project import Project
from podtpu_torch.infer.masks import mask_to_polygons, paste_mask
from podtpu_torch.models.detector import make_detector
from podtpu_torch.models.roi_heads import Detections, KeypointOutput
from podtpu_torch.models.weights import state_dict_from_flax
from podtpu_torch.train.checkpoints import load_model

IMAGE_SUFFIXES = {".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".tif"}


def load_inference_model(model_dir: str, device=None
                         ) -> Tuple[Callable, torch.nn.Module, object, list]:
    """Load a saved model directory -> ``(forward, model, cfg, labels)``.

    ``forward(images)`` takes ``[B, H, W, 3]`` uint8 canvases (numpy or
    torch) and returns :class:`Detections` on the model's device, for a
    mask or keypoint model with its masks or keypoints (see
    :func:`split_eval_output`).
    """
    dev = resolve_device(device)
    params, frozen, cfg, labels = load_model(model_dir)
    forward, model = build_inference_model(params, frozen, cfg, dev)
    return forward, model, cfg, labels


def build_inference_model(params, frozen, cfg, device
                          ) -> Tuple[Callable, torch.nn.Module]:
    """``(forward, model)`` of :func:`load_inference_model` from a model
    directory's flax trees and a model configuration (whose canvas may
    differ from the saved one: the weights do not depend on it)."""
    model = make_detector(cfg)
    sd = state_dict_from_flax(params, frozen, cfg.roi_pool_size)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model = model.to(device).to(memory_format=torch.channels_last).eval()

    def forward(images) -> Detections:
        with torch.inference_mode():
            return model(torch.as_tensor(images).to(device))

    return forward, model


def split_eval_output(out) -> Tuple[
        Detections, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(Detections, masks, keypoints)`` of an eval forward: a box model
    returns ``Detections``, a mask model ``(Detections, masks [B, D, M,
    M])``, a keypoint model ``(Detections, KeypointOutput)`` whose
    keypoints are ``[B, D, K, 3]``; what a model does not predict is
    None."""
    if isinstance(out, Detections):
        return out, None, None
    det, extra = out
    if isinstance(extra, KeypointOutput):
        return det, None, extra.keypoints
    return det, extra, None


def _run_inference(project: Project, model_dir: str,
                   model_labels: Optional[List[str]],
                   threshold: float, batch_size: int, nv: bool,
                   num_workers: int = 4, device=None) -> Project:
    forward, _, model_cfg, saved_labels = load_inference_model(model_dir,
                                                               device)
    if model_labels is None:
        model_labels = saved_labels
    if nv:
        model_labels = [label + "_NV" for label in model_labels]
    for label in model_labels:
        project.add_label(None, label, None)

    project = copy.deepcopy(project)
    project.remove_labelled_images()

    # Single pass over the images: the decoded-canvas cache would only
    # burn memory here.
    dataset = DetectionDataset(project, image_size=model_cfg.image_size,
                               max_gt=model_cfg.max_gt_boxes,
                               label_names=model_labels, cache=False)
    loader = Loader(dataset, batch_size, shuffle=False,
                    num_workers=num_workers)

    out = Project()
    out.task_names = dict(project.task_names)
    for batch, batch_valid in loader:
        det, masks, kps = split_eval_output(forward(batch["image"]))
        boxes = det.boxes.float().cpu().numpy()
        scores = det.scores.float().cpu().numpy()
        labels = det.labels.cpu().numpy()
        valid = det.valid.cpu().numpy()
        if masks is not None:
            masks = masks.float().cpu().numpy()
        if kps is not None:
            kps = kps.float().cpu().numpy()
        for i, ok in enumerate(batch_valid):
            if not ok:
                continue
            meta = dataset.images[int(batch["index"][i])]
            scale = float(batch["scale"][i])
            keep = np.flatnonzero(valid[i] & (scores[i] > threshold))
            for j in keep:
                b, s = boxes[i, j] / scale, float(scores[i, j])
                label = model_labels[int(labels[i, j]) - 1]
                ann = None
                if masks is not None:
                    ann = mask_to_annotation(masks[i, j], b, label, s)
                if ann is None:
                    ann = RectangleAnnotation(
                        float(b[0]), float(b[1]), float(b[2] - b[0]),
                        float(b[3] - b[1]), label, score=s)
                if kps is not None:
                    kp = kps[i, j].copy()
                    kp[:, :2] /= scale
                    ann.keypoints = [tuple(float(v) for v in row)
                                     for row in kp]
                meta.boxes.append(ann)
            out.add_image(meta)
    return out


def mask_to_annotation(mask: np.ndarray, box_orig: np.ndarray, label: str,
                       score: float, max_grid: int = 256
                       ) -> Optional[PolygonAnnotation]:
    """A detection's ``[M, M]`` box-local mask -> a ``PolygonAnnotation``
    in original-image coordinates around its largest connected component,
    traced on a grid of about one cell per original pixel (at most
    ``max_grid`` a side); None when the mask is empty."""
    x0, y0, x1, y1 = [float(v) for v in box_orig]
    bw, bh = x1 - x0, y1 - y0
    if bw <= 0 or bh <= 0:
        return None
    gw = int(np.clip(np.ceil(bw), 2, max_grid))
    gh = int(np.clip(np.ceil(bh), 2, max_grid))
    local = paste_mask(mask, np.array([0.0, 0.0, gw, gh]), gh, gw)
    polys = mask_to_polygons(local)
    if not polys:
        return None
    poly = polys[0]
    xs = x0 + (poly[:, 0] + 0.5) * bw / gw
    ys = y0 + (poly[:, 1] + 0.5) * bh / gh
    return PolygonAnnotation(xs.tolist(), ys.tolist(), label, score=score)


def infer(project: Project,
          model_path: str,
          model_labels: Optional[List[str]] = None,
          threshold: float = 0.5,
          batch_size: int = 2,
          nv: bool = False,
          num_workers: int = 4,
          device=None) -> Project:
    """Auto-annotate the unlabelled images of ``project``.

    ``model_path`` may be the model directory or any file inside it.
    """
    return _run_inference(project, _as_model_dir(model_path), model_labels,
                          threshold, batch_size, nv, num_workers, device)


def infer_directory(input_dir: str,
                    model_path: str,
                    model_labels: Optional[List[str]] = None,
                    threshold: float = 0.5,
                    batch_size: int = 2,
                    num_workers: int = 4,
                    device=None) -> Project:
    """Auto-annotate every image file under ``input_dir`` (recursive)."""
    p = Path(input_dir)
    if not p.exists():
        raise ValueError(f"Directory does not exist: {input_dir}")
    filepaths = [path for path in sorted(p.rglob("*.*"))
                 if path.suffix.lower() in IMAGE_SUFFIXES]
    project = Project()
    for i, filepath in enumerate(filepaths):
        project.add_image(ImageMetadata(str(filepath), "/", 0, i))
    return _run_inference(project, _as_model_dir(model_path), model_labels,
                          threshold, batch_size, False, num_workers, device)


def _as_model_dir(model_path: str) -> str:
    p = Path(model_path)
    return str(p.parent) if p.suffix else str(p)
