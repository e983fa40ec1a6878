"""COCO detection metrics (AP/AR), implemented from scratch.

Replacement for the pycocotools ``COCOeval`` machinery the reference drives
through ``CocoEvaluator`` (`miso/object_detection/engine/coco_eval.py:13-60`,
`engine/coco_utils.py:146-195`): pycocotools is a C extension that is not
available here, and the reference's per-epoch full-dataset gt re-index is a
known perf sink (SURVEY.md §"quirks") — this evaluator keeps gt in memory and
accumulates incrementally instead.

Semantics follow the COCOeval algorithm: greedy score-ordered matching per
(class, IoU threshold, area range, maxDets), 101-point interpolated precision,
AP averaged over classes with ground truth.  The reference's modified
``maxDets=[10, 30, 300]`` (`coco_eval.py:24`) is the default here, and
``summarize()`` emits the same 12 statistics the reference writes to
``results.txt`` (`miso/object_detection/training.py:144-160`) — including its
quirk of printing "maxDets=100" in the row names while the values use the
configured maxDets.

Counterpart of ``podtpu/train/coco_metrics.py`` for ``iou_type="bbox"``,
``"segm"`` (masks as bitmaps on a common grid, or as full-resolution
:class:`~podtpu_torch.infer.masks.RegionMask` lists) and ``"keypoints"``
(OKS, :func:`keypoint_oks`): the greedy matcher runs in the native C++
host library (:mod:`podtpu_torch.core.native`) when it loads, else as a
Python loop; both give the same matches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from podtpu_torch.core import native
from podtpu_torch.infer.masks import mask_iou, region_mask_iou

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)  # 10 thresholds
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}

STAT_NAMES = [
    "Average Precision  (AP) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]",
    "Average Precision  (AP) @[ IoU=0.50      | area=   all | maxDets=100 ]",
    "Average Precision  (AP) @[ IoU=0.75      | area=   all | maxDets=100 ]",
    "Average Precision  (AP) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]",
    "Average Precision  (AP) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]",
    "Average Precision  (AP) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]",
    "Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=  1 ]",
    "Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets= 10 ]",
    "Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | maxDets=100 ]",
    "Average Recall     (AR) @[ IoU=0.50:0.95 | area= small | maxDets=100 ]",
    "Average Recall     (AR) @[ IoU=0.50:0.95 | area=medium | maxDets=100 ]",
    "Average Recall     (AR) @[ IoU=0.50:0.95 | area= large | maxDets=100 ]",
]


# pycocotools COCOeval keypoint sigmas (the 17 COCO person joints).
COCO_KP_SIGMAS = np.array([
    .026, .025, .025, .035, .035, .079, .079, .072, .072, .062, .062,
    .107, .107, .087, .087, .089, .089])


def keypoint_oks(dt_kps: np.ndarray, gt_kps: np.ndarray,
                 gt_boxes: np.ndarray,
                 sigmas: Optional[np.ndarray] = None) -> np.ndarray:
    """Object Keypoint Similarity between ``[D, K, 3]`` detections and
    ``[G, K, 3]`` ground truth -> ``[D, G]`` (pycocotools ``computeOks``).
    The gt boxes (xyxy) give each object's area; for a gt with no visible
    keypoint the distance is measured outside its box doubled, as
    pycocotools does.  ``sigmas``: the COCO-17 constants when K = 17, else
    0.05 each."""
    d, g = len(dt_kps), len(gt_kps)
    if d == 0 or g == 0:
        return np.zeros((d, g))
    k = gt_kps.shape[1]
    if sigmas is None:
        sigmas = COCO_KP_SIGMAS if k == len(COCO_KP_SIGMAS) \
            else np.full((k,), 0.05)
    var = (2.0 * sigmas) ** 2
    ious = np.zeros((d, g))
    for gi in range(g):
        xg, yg, vg = gt_kps[gi, :, 0], gt_kps[gi, :, 1], gt_kps[gi, :, 2]
        x1, y1, x2, y2 = gt_boxes[gi]
        area = max((x2 - x1) * (y2 - y1), 0.0)
        k1 = int((vg > 0).sum())
        for di in range(d):
            xd, yd = dt_kps[di, :, 0], dt_kps[di, :, 1]
            if k1 > 0:
                dx, dy = xd - xg, yd - yg
            else:
                z = np.zeros((k,))
                w2, h2 = (x2 - x1), (y2 - y1)
                dx = np.maximum(z, (x1 - w2 / 2) - xd) \
                    + np.maximum(z, xd - (x2 + w2 / 2))
                dy = np.maximum(z, (y1 - h2 / 2) - yd) \
                    + np.maximum(z, yd - (y2 + h2 / 2))
            e = (dx ** 2 + dy ** 2) / var / (area + np.spacing(1)) / 2.0
            if k1 > 0:
                e = e[vg > 0]
            ious[di, gi] = np.sum(np.exp(-e)) / e.shape[0]
    return ious


def pairwise_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between ``[N,4]`` and ``[M,4]`` xyxy boxes (numpy, host-side)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


@dataclass
class _ImageEval:
    """Per-(image, class) matching results at all IoU thresholds."""
    dt_scores: np.ndarray     # [D]
    dt_matched: np.ndarray    # [T, D] bool
    dt_ignored: np.ndarray    # [T, D] bool
    num_gt: int               # non-ignored gt count


class COCOEvaluator:
    """Streaming COCO-style AP/AR over (gt, prediction) pairs per image.

    Boxes are xyxy in original-image coordinates; labels are 1-based class
    ids (0 reserved for background, never passed here).
    """

    def __init__(self, num_classes: int,
                 max_dets: Sequence[int] = (10, 30, 300),
                 iou_type: str = "bbox"):
        if iou_type not in ("bbox", "segm", "keypoints"):
            raise ValueError(f"unknown iou_type {iou_type!r}")
        self.num_classes = num_classes  # foreground classes, labels 1..K
        self.max_dets = tuple(max_dets)
        self.iou_type = iou_type
        # evals[(class, area)] -> list of _ImageEval (one per image, at the
        # largest maxDets; smaller maxDets re-slice at accumulate time).
        self._evals: Dict[Tuple[int, str], List[_ImageEval]] = {}
        self._reset()

    def _reset(self):
        self._evals = {(k, a): [] for k in range(1, self.num_classes + 1)
                       for a in AREA_RANGES}

    def update(self, gt_boxes: np.ndarray, gt_labels: np.ndarray,
               dt_boxes: np.ndarray, dt_scores: np.ndarray,
               dt_labels: np.ndarray,
               gt_masks: Optional[np.ndarray] = None,
               dt_masks: Optional[np.ndarray] = None,
               gt_keypoints: Optional[np.ndarray] = None,
               dt_keypoints: Optional[np.ndarray] = None,
               area_scale: float = 1.0) -> None:
        """Add one image's ground truth + detections (xyxy boxes in
        original-image coordinates).

        For ``iou_type="segm"``: ``gt_masks``/``dt_masks`` are either
        ``[G|D, H, W]`` boolean bitmaps on a common grid or lists of
        ``RegionMask`` (full-resolution, box-bounded); IoU and object areas
        come from the masks, ``area_scale`` converting grid px^2 to
        original-image px^2 (COCO's area ranges are in image pixels).

        For ``iou_type="keypoints"``: ``gt_keypoints``/``dt_keypoints`` are
        ``[G|D, K, 3]`` (x, y, v) arrays; the "IoU" is the OKS, with areas
        from the gt boxes, and a gt with no labelled keypoint is ignored.
        """
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        dt_boxes = np.asarray(dt_boxes, np.float64).reshape(-1, 4)
        gt_labels = np.asarray(gt_labels).reshape(-1)
        dt_labels = np.asarray(dt_labels).reshape(-1)
        dt_scores = np.asarray(dt_scores, np.float64).reshape(-1)
        kps = self.iou_type == "keypoints"
        if kps:
            if gt_keypoints is None or dt_keypoints is None:
                raise ValueError("iou_type='keypoints' needs gt_keypoints "
                                 "and dt_keypoints")
            gt_keypoints = np.asarray(gt_keypoints, np.float64)
            dt_keypoints = np.asarray(dt_keypoints, np.float64)
        segm = self.iou_type == "segm"
        region_masks = False
        if segm:
            if gt_masks is None or dt_masks is None:
                raise ValueError("iou_type='segm' needs gt_masks and "
                                 "dt_masks")
            region_masks = isinstance(gt_masks, list)
            if region_masks:
                gt_area = np.asarray([m.area for m in gt_masks],
                                     np.float64) * area_scale
                dt_area = np.asarray([m.area for m in dt_masks],
                                     np.float64) * area_scale
            else:
                gt_masks = np.asarray(gt_masks).astype(bool)
                dt_masks = np.asarray(dt_masks).astype(bool)
                gt_area = gt_masks.sum(axis=(1, 2)) * area_scale
                dt_area = dt_masks.sum(axis=(1, 2)) * area_scale
        else:
            gt_area = (gt_boxes[:, 2] - gt_boxes[:, 0]) * \
                      (gt_boxes[:, 3] - gt_boxes[:, 1])
            dt_area = (dt_boxes[:, 2] - dt_boxes[:, 0]) * \
                      (dt_boxes[:, 3] - dt_boxes[:, 1])

        for k in range(1, self.num_classes + 1):
            g_sel = gt_labels == k
            d_sel = dt_labels == k
            g_area = gt_area[g_sel]
            d_area = dt_area[d_sel]
            d_score = dt_scores[d_sel]
            # Detections in descending score order, capped at max maxDets.
            order = np.argsort(-d_score, kind="stable")[: max(self.max_dets)]
            d_area, d_score = d_area[order], d_score[order]
            if region_masks:
                d_idx = np.flatnonzero(d_sel)[order]
                iou = region_mask_iou([dt_masks[i] for i in d_idx],
                                      [gt_masks[i]
                                       for i in np.flatnonzero(g_sel)])
            elif segm:
                iou = mask_iou(dt_masks[d_sel][order], gt_masks[g_sel])
            elif kps:
                iou = keypoint_oks(dt_keypoints[d_sel][order],
                                   gt_keypoints[g_sel], gt_boxes[g_sel])
            else:
                iou = pairwise_iou(dt_boxes[d_sel][order], gt_boxes[g_sel])
            # COCO's keypoint evaluation ignores gts with no labelled
            # keypoint (kept boolean: the matcher negates it).
            kp_ig = (gt_keypoints[g_sel][:, :, 2] > 0).sum(-1) == 0 \
                if kps else np.zeros(int(g_sel.sum()), bool)
            for aname, (lo, hi) in AREA_RANGES.items():
                g_ig = (g_area < lo) | (g_area > hi) | kp_ig
                self._evals[(k, aname)].append(
                    self._match(iou, d_score, d_area, g_ig, (lo, hi)))

    @staticmethod
    def _match(iou: np.ndarray, d_score: np.ndarray, d_area: np.ndarray,
               g_ig: np.ndarray, rng: Tuple[float, float]) -> _ImageEval:
        D, G = iou.shape
        T = len(IOU_THRS)
        # gts sorted: non-ignored first (COCOeval convention).
        g_order = np.argsort(g_ig, kind="stable")
        iou = iou[:, g_order]
        g_ig = g_ig[g_order]

        if D and G:
            res = native.coco_match(iou, g_ig, d_area, IOU_THRS, rng)
            if res is not None:
                dtm_n, dtig_n = res
                return _ImageEval(dt_scores=d_score, dt_matched=dtm_n,
                                  dt_ignored=dtig_n,
                                  num_gt=int((~g_ig).sum()))

        dtm = np.zeros((T, D), bool)
        dtig = np.zeros((T, D), bool)
        for ti, thr in enumerate(IOU_THRS):
            gt_used = np.zeros(G, bool)
            for d in range(D):
                best, best_iou = -1, thr - 1e-10
                for g in range(G):
                    if gt_used[g]:
                        continue
                    # Once matched to a non-ignored gt, never switch to an
                    # ignored one.
                    if best > -1 and not g_ig[best] and g_ig[g]:
                        break
                    if iou[d, g] < best_iou:
                        continue
                    best_iou = iou[d, g]
                    best = g
                if best == -1:
                    continue
                gt_used[best] = True
                dtm[ti, d] = True
                dtig[ti, d] = g_ig[best]
            # Unmatched detections outside the area range are ignored.
            out = (d_area < rng[0]) | (d_area > rng[1])
            dtig[ti] |= (~dtm[ti]) & out
        return _ImageEval(dt_scores=d_score, dt_matched=dtm, dt_ignored=dtig,
                          num_gt=int((~g_ig).sum()))

    def merge_from(self, other: "COCOEvaluator") -> None:
        """Fold another evaluator's per-image match results into this one
        (the cross-rank merge of the reference's distributed COCO eval,
        `engine/coco_eval.py:161-190`)."""
        assert other.num_classes == self.num_classes
        assert other.max_dets == self.max_dets
        for key, evals in other._evals.items():
            self._evals[key].extend(evals)

    def accumulate(self) -> Dict[str, np.ndarray]:
        """Compute precision/recall tables.

        Returns dict with ``precision`` [T, R, K, A, M] and ``recall``
        [T, K, A, M] (COCOeval layout; -1 where no gt).
        """
        T, R = len(IOU_THRS), len(RECALL_THRS)
        K, A, M = self.num_classes, len(AREA_RANGES), len(self.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for ki in range(K):
            for ai, aname in enumerate(AREA_RANGES):
                evals = self._evals[(ki + 1, aname)]
                if not evals:
                    continue
                npig = sum(e.num_gt for e in evals)
                if npig == 0:
                    continue
                for mi, maxd in enumerate(self.max_dets):
                    scores = np.concatenate(
                        [e.dt_scores[:maxd] for e in evals])
                    matched = np.concatenate(
                        [e.dt_matched[:, :maxd] for e in evals], axis=1)
                    ignored = np.concatenate(
                        [e.dt_ignored[:, :maxd] for e in evals], axis=1)
                    order = np.argsort(-scores, kind="mergesort")
                    matched = matched[:, order]
                    ignored = ignored[:, order]

                    tps = matched & ~ignored
                    fps = ~matched & ~ignored
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if nd else 0.0
                        # Monotone-decreasing precision envelope.
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        inds = np.searchsorted(rc, RECALL_THRS, side="left")
                        q = np.zeros(R)
                        valid = inds < nd
                        q[valid] = pr[inds[valid]]
                        precision[ti, :, ki, ai, mi] = q
        self._precision, self._recall = precision, recall
        return {"precision": precision, "recall": recall}

    # -- summaries -----------------------------------------------------------
    def _ap(self, iou: Optional[float] = None, area: str = "all",
            max_det: Optional[int] = None) -> float:
        p = self._precision
        ai = list(AREA_RANGES).index(area)
        mi = self.max_dets.index(max_det or self.max_dets[-1])
        if iou is not None:
            ti = int(np.argwhere(np.isclose(IOU_THRS, iou))[0, 0])
            p = p[ti:ti + 1]
        s = p[:, :, :, ai, mi]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    def _ar(self, area: str = "all", max_det: Optional[int] = None) -> float:
        r = self._recall
        ai = list(AREA_RANGES).index(area)
        mi = self.max_dets.index(max_det or self.max_dets[-1])
        s = r[:, :, ai, mi]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    def summarize(self) -> List[float]:
        """The 12 COCO stats in the order the reference persists them."""
        self.accumulate()
        md = self.max_dets
        return [
            self._ap(),
            self._ap(iou=0.5),
            self._ap(iou=0.75),
            self._ap(area="small"),
            self._ap(area="medium"),
            self._ap(area="large"),
            self._ar(max_det=md[0]),
            self._ar(max_det=md[1]),
            self._ar(max_det=md[2]),
            self._ar(area="small"),
            self._ar(area="medium"),
            self._ar(area="large"),
        ]

    def summary_text(self) -> str:
        stats = self.summarize()
        return "\n".join(f"{name} = {stat:.3f}"
                         for name, stat in zip(STAT_NAMES, stats))

    # -- per-class breakdown (new capability: pycocotools and the reference
    # only report the class-averaged stats) ----------------------------------
    def per_class_stats(self) -> Dict[int, List[float]]:
        """``{label: [AP, AP@0.5, AP@0.75, AR@maxDets[-1]]}`` per class,
        area="all"; classes with no ground truth are omitted (they carry
        -1 sentinels in the precision table and would poison averages)."""
        # Always re-accumulate (like summarize): update()/merge_from()
        # don't invalidate a cached table.
        self.accumulate()
        ai = list(AREA_RANGES).index("all")
        mi = len(self.max_dets) - 1
        t50 = int(np.argwhere(np.isclose(IOU_THRS, 0.5))[0, 0])
        t75 = int(np.argwhere(np.isclose(IOU_THRS, 0.75))[0, 0])

        def _mean(a: np.ndarray) -> float:
            a = a[a > -1]
            return float(np.mean(a)) if a.size else -1.0

        out: Dict[int, List[float]] = {}
        for ki in range(self.num_classes):
            p = self._precision[:, :, ki, ai, mi]
            if not (p > -1).any():
                continue
            out[ki + 1] = [
                _mean(p),
                _mean(self._precision[t50, :, ki, ai, mi]),
                _mean(self._precision[t75, :, ki, ai, mi]),
                _mean(self._recall[:, ki, ai, mi]),
            ]
        return out

    def per_class_text(self, label_names: Optional[List[str]] = None) -> str:
        """Aligned per-class table (label_names is 0-based over foreground
        classes, i.e. ``label_names[label - 1]`` names class ``label``)."""
        stats = self.per_class_stats()
        names = {
            k: (label_names[k - 1] if label_names and k - 1 < len(label_names)
                else f"class {k}") for k in stats
        }
        width = max([len(n) for n in names.values()] + [5])
        header = (f"{'class':<{width}}  {'AP':>6}  {'AP50':>6}  {'AP75':>6}  "
                  f"{'AR':>6}")
        lines = [header]
        for k in sorted(stats):
            ap, ap50, ap75, ar = stats[k]
            lines.append(f"{names[k]:<{width}}  {ap:6.3f}  {ap50:6.3f}  "
                         f"{ap75:6.3f}  {ar:6.3f}")
        return "\n".join(lines)
