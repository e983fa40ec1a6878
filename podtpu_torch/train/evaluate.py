"""Evaluation loop: run detections over a loader, score with COCO metrics.

Counterpart of ``podtpu/train/evaluate.py``.  Ground truth streams straight
from the fixed-shape batches; detections and gt are mapped back to original
image coordinates (divided by the per-image fit-resize scale) before
scoring.  Slots whose ``batch_valid`` is False (wrapped duplicates,
unreadable images) are skipped.  For a mask model whose batches carry gt
masks, a segm evaluator runs beside bbox: gt polygons rasterized and
predicted masks pasted at original pixels, box-bounded (the loader's
dataset at hand), else both on the gt planes' grid.  For a keypoint model
whose batches carry gt keypoints, a keypoints evaluator (OKS) runs beside
bbox on gt and predicted keypoints scaled back to original pixels.  The
cross-process merge waits for ROADMAP.md item 18.
"""
from __future__ import annotations

import time
from typing import Callable, List, Tuple

import numpy as np

from podtpu_torch.core.logging import is_main_process
from podtpu_torch.infer.inference import split_eval_output
from podtpu_torch.infer.masks import (paste_masks, paste_region_masks,
                                      rasterize_region)
from podtpu_torch.train.coco_metrics import COCOEvaluator


def evaluate(forward: Callable, loader, num_classes: int,
             verbose: bool = True) -> Tuple[COCOEvaluator, List[float]]:
    """Returns (evaluator, the 12 bbox COCO stats).  ``forward(images)``
    takes a batch's uint8 canvases and returns its ``Detections`` (with
    masks or keypoints for a mask or keypoint model).  The segm and
    keypoints evaluators and their stats, when they ran, are
    ``evaluator.segm``, ``evaluator.segm_stats``, ``evaluator.keypoints``
    and ``evaluator.keypoints_stats`` (else None)."""
    evaluator = COCOEvaluator(num_classes=num_classes)
    segm_eval = None
    kp_eval = None
    model_time = 0.0
    n_images = 0
    for batch, batch_valid in loader:
        t0 = time.time()
        det, out_masks, out_kps = split_eval_output(forward(batch["image"]))
        det_np = {"boxes": det.boxes.float().cpu().numpy(),
                  "scores": det.scores.float().cpu().numpy(),
                  "labels": det.labels.cpu().numpy(),
                  "valid": det.valid.cpu().numpy()}
        do_segm = out_masks is not None and "masks" in batch
        if do_segm:
            dt_masks = out_masks.float().cpu().numpy()  # [B, D, M, M]
            if segm_eval is None:
                segm_eval = COCOEvaluator(num_classes=num_classes,
                                          iou_type="segm")
        do_kps = out_kps is not None and "keypoints" in batch
        if do_kps:
            dt_kps = out_kps.float().cpu().numpy()  # [B, D, K, 3]
            if kp_eval is None:
                kp_eval = COCOEvaluator(num_classes=num_classes,
                                        iou_type="keypoints")
        model_time += time.time() - t0
        for i, ok in enumerate(batch_valid):
            if not ok:
                continue
            scale = float(batch["scale"][i])
            gv = batch["valid"][i]
            dv = det_np["valid"][i]
            evaluator.update(
                gt_boxes=batch["boxes"][i][gv] / scale,
                gt_labels=batch["labels"][i][gv],
                dt_boxes=det_np["boxes"][i][dv] / scale,
                dt_scores=det_np["scores"][i][dv],
                dt_labels=det_np["labels"][i][dv],
            )
            if do_segm:
                dataset = getattr(loader, "dataset", None)
                if dataset is not None:
                    oh, ow = (int(v) for v in batch["original_size"][i])
                    meta = dataset.images[int(batch["index"][i])]
                    kept = [b for b in meta.boxes
                            if b.label in dataset.label_to_index]
                    gm = [rasterize_region(b, oh, ow)
                          for b in kept[:dataset.max_gt]]
                    dm = paste_region_masks(
                        dt_masks[i][dv], det_np["boxes"][i][dv] / scale,
                        oh, ow)
                    area_scale = 1.0
                else:
                    gm = batch["masks"][i][gv] > 0.5      # [Gv, Hm, Wm]
                    hm, wm = gm.shape[-2:]
                    stride = batch["image"].shape[1] / hm
                    dm = paste_masks(dt_masks[i][dv],
                                     det_np["boxes"][i][dv] / stride,
                                     hm, wm) > 0.5
                    area_scale = (stride / scale) ** 2
                segm_eval.update(
                    gt_boxes=batch["boxes"][i][gv] / scale,
                    gt_labels=batch["labels"][i][gv],
                    dt_boxes=det_np["boxes"][i][dv] / scale,
                    dt_scores=det_np["scores"][i][dv],
                    dt_labels=det_np["labels"][i][dv],
                    gt_masks=gm, dt_masks=dm, area_scale=area_scale)
            if do_kps:
                gkp = batch["keypoints"][i][gv].astype(np.float64)
                gkp[:, :, :2] /= scale
                dkp = dt_kps[i][dv].astype(np.float64)
                dkp[:, :, :2] /= scale
                kp_eval.update(
                    gt_boxes=batch["boxes"][i][gv] / scale,
                    gt_labels=batch["labels"][i][gv],
                    dt_boxes=det_np["boxes"][i][dv] / scale,
                    dt_scores=det_np["scores"][i][dv],
                    dt_labels=det_np["labels"][i][dv],
                    gt_keypoints=gkp, dt_keypoints=dkp)
            n_images += 1
    stats = evaluator.summarize()
    evaluator.segm = segm_eval
    evaluator.segm_stats = segm_eval.summarize() if segm_eval else None
    evaluator.keypoints = kp_eval
    evaluator.keypoints_stats = kp_eval.summarize() if kp_eval else None
    if verbose and is_main_process():
        print(f"Evaluated {n_images} images "
              f"(model time {model_time:.2f}s)")
        print("IoU metric: bbox")
        print(evaluator.summary_text())
        if segm_eval is not None:
            print("IoU metric: segm")
            print(segm_eval.summary_text())
        if kp_eval is not None:
            print("IoU metric: keypoints")
            print(kp_eval.summary_text())
    return evaluator, stats
