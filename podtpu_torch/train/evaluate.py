"""Evaluation loop: run detections over a loader, score with COCO metrics.

Counterpart of ``podtpu/train/evaluate.py`` for box detectors.  Ground truth
streams straight from the fixed-shape batches; detections and gt are mapped
back to original image coordinates (divided by the per-image fit-resize
scale) before scoring.  Slots whose ``batch_valid`` is False (wrapped
duplicates, unreadable images) are skipped.  Mask and keypoint evaluation
wait for ROADMAP.md items 10 and 11; the cross-process merge waits for
item 18.
"""
from __future__ import annotations

import time
from typing import Callable, List, Tuple

from podtpu_torch.core.logging import is_main_process
from podtpu_torch.train.coco_metrics import COCOEvaluator


def evaluate(forward: Callable, loader, num_classes: int,
             verbose: bool = True) -> Tuple[COCOEvaluator, List[float]]:
    """Returns (evaluator, the 12 COCO stats).  ``forward(images)`` takes
    a batch's uint8 canvases and returns its ``Detections``."""
    evaluator = COCOEvaluator(num_classes=num_classes)
    model_time = 0.0
    n_images = 0
    for batch, batch_valid in loader:
        t0 = time.time()
        det = forward(batch["image"])
        det_np = {"boxes": det.boxes.float().cpu().numpy(),
                  "scores": det.scores.float().cpu().numpy(),
                  "labels": det.labels.cpu().numpy(),
                  "valid": det.valid.cpu().numpy()}
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
            n_images += 1
    stats = evaluator.summarize()
    if verbose and is_main_process():
        print(f"Evaluated {n_images} images "
              f"(model time {model_time:.2f}s)")
        print("IoU metric: bbox")
        print(evaluator.summary_text())
    return evaluator, stats
