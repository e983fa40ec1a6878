"""SSD300-VGG16 and SSDLite320-MobileNetV3: the single-shot detectors.

Counterpart of ``podtpu/models/ssd.py`` (``SSDHead``, ``match_ssd``,
``smooth_l1``, ``ssd_losses``, ``ssd_postprocess``, ``SSD``) in the module
layout of torchvision's ``ssd300_vgg16`` and
``ssdlite320_mobilenet_v3_large``: ``backbone`` the extractor
(``models/vgg.py::VGG16SSD`` or ``models/mobilenet_v3.py::
MobileNetV3SSDLite``), ``head.{classification,regression}_head.
module_list.{k}`` one unshared convolution a map (SSDLite's: a depthwise
3x3 with a frozen norm and ReLU6, ``.0``, then a 1x1, ``.1``; its norm
stays frozen when the trunk's train, as in both references).

The default boxes (``ops/anchors.py::default_boxes``) are a buffer built
once from the config.  Head outputs are flattened location-major,
anchor-minor, channel ``a * C + c``.  Training matches each default box to
a gt (IoU >= 0.5, and each valid gt forces its best box to itself, the last
gt winning a shared box, written as a max over gt indices), and takes
smooth-L1 on the (10, 10, 5, 5)-encoded boxes of the matched boxes and the
cross-entropy of the matched boxes and of the ``3 x`` hardest negatives
(ranks by two stable sorts on the device), both over the batch's matched
count.  The eval postprocess softmaxes, keeps the ``ssd_topk_per_class``
best boxes of each foreground class above ``score_thresh`` and runs one
NMS segment per (image, class), every segment of the batch in one kernel
launch (``ops/nms.py::class_segments_nms_keep``), then the top
``detections_per_image`` of the kept boxes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from podtpu_torch.core.config import ModelConfig
from podtpu_torch.models.fpn import PyramidDetector
from podtpu_torch.models.mobilenet import ConvNormAct
from podtpu_torch.models.mobilenet_v3 import (SSDLITE_OUT_CHANNELS,
                                              MobileNetV3SSDLite)
from podtpu_torch.models.resnet import Conv2d
from podtpu_torch.models.retinanet import DTYPES, flatten_level
from podtpu_torch.models.roi_heads import Detections
from podtpu_torch.models.vgg import OUT_CHANNELS as VGG_OUT_CHANNELS
from podtpu_torch.models.vgg import VGG16SSD
from podtpu_torch.ops import boxes as box_ops
from podtpu_torch.ops.anchors import default_boxes
from podtpu_torch.ops.matching import stable_topk
from podtpu_torch.ops.nms import (NEG_INF, class_segments_nms_keep,
                                  topk_by_score)

SSD_BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


def _score_conv(cin: int, cout: int, separable: bool,
                dt: torch.dtype) -> nn.Module:
    if not separable:
        return Conv2d(cin, cout, 3, padding=1, compute_dtype=dt)
    return nn.Sequential(ConvNormAct(cin, cin, 3, groups=cin,
                                     compute_dtype=dt),
                         Conv2d(cin, cout, 1, compute_dtype=dt))


class SSDScoringHead(nn.Module):
    """One convolution a map (``module_list.{k}``), each flattened to
    ``[B, Hk * Wk * A_k, k]``."""

    def __init__(self, channels: Sequence[int], anchors: Sequence[int],
                 k: int, separable: bool, compute_dtype: torch.dtype):
        super().__init__()
        self.k = k
        self.module_list = nn.ModuleList(
            _score_conv(c, a * k, separable, compute_dtype)
            for c, a in zip(channels, anchors))

    def forward(self, features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [flatten_level(m(f), self.k)
                for m, f in zip(self.module_list, features)]


class SSDHead(nn.Module):
    def __init__(self, channels: Sequence[int], anchors: Sequence[int],
                 num_classes: int, separable: bool,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.classification_head = SSDScoringHead(
            channels, anchors, num_classes, separable, compute_dtype)
        self.regression_head = SSDScoringHead(channels, anchors, 4,
                                              separable, compute_dtype)

    def forward(self, features):
        return self.classification_head(features), \
            self.regression_head(features)


def match_ssd(iou: torch.Tensor, gt_valid: torch.Tensor,
              iou_thresh: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """torchvision's ``SSDMatcher`` on ``[B, N, M]`` IoU and ``[B, M]``
    validity: ``(matched_idx [B, N] int64, labels [B, N])``, labels 1 where
    the best gt reaches ``iou_thresh`` and where a valid gt with a positive
    best IoU forces its best box, else 0 (0 everywhere in an image without
    gts).  Both argmaxes take the first maximum; a box forced by two gts
    goes to the later one (a max over gt indices, no scatter)."""
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    matched_val = iou.amax(2)
    matched_idx = torch.argmax(iou, 2)
    labels = (matched_val >= iou_thresh).long()
    n, m = iou.shape[1:]
    best_anchor = torch.argmax(iou, 1)                            # [B, M]
    force = ((torch.arange(n, device=iou.device)[None, :, None]
              == best_anchor[:, None, :])
             & gt_valid[:, None, :] & (iou.amax(1) > 0)[:, None, :])
    gt_index = torch.arange(m, device=iou.device)[None, None, :]
    forced_gt = torch.where(force, gt_index,
                            torch.full_like(gt_index, -1)).amax(2)
    forced = forced_gt >= 0
    matched_idx = torch.where(forced, forced_gt, matched_idx)
    labels = torch.where(forced, torch.ones_like(labels), labels)
    labels = torch.where(gt_valid.any(1)[:, None], labels,
                         torch.zeros_like(labels))
    return matched_idx, labels


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def ssd_losses(logits: torch.Tensor, deltas: torch.Tensor,
               anchors: torch.Tensor, gt: Dict,
               cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """torchvision's ``SSD.compute_loss`` over static shapes: ``logits [B,
    N, C]``, ``deltas [B, N, 4]``, ``anchors [N, 4]`` and the gt dict
    (``boxes``, ``labels``, ``valid``, optional ``image_weight``) ->
    ``classification`` and ``bbox_regression``.  Hard negatives are the
    negatives ranked below ``ssd_neg_pos_ratio`` times the image's matched
    count by cross-entropy, descending, ties in index order (the rank of
    each box by two stable sorts)."""
    gt_b = gt["boxes"].float()
    matched_idx, labels = match_ssd(box_ops.box_iou(anchors, gt_b),
                                    gt["valid"], cfg.ssd_iou_thresh)
    fg = (labels == 1).float()
    matched = torch.gather(gt_b, 1, matched_idx[..., None].expand(-1, -1, 4))
    enc = box_ops.encode_boxes(matched, anchors, weights=SSD_BOX_WEIGHTS)
    reg = smooth_l1(deltas.float() - enc).sum(-1)
    box_sums = (reg * fg).sum(-1)
    cls_tgt = torch.where(labels == 1,
                          torch.gather(gt["labels"].long(), 1, matched_idx),
                          torch.zeros_like(matched_idx))
    logp = F.log_softmax(logits.float(), -1)
    ce = -torch.gather(logp, 2, cls_tgt[..., None])[..., 0]
    num_fg = fg.sum(-1)
    neg_ce = torch.where(fg > 0, torch.full_like(ce, float("-inf")), ce)
    order = torch.argsort(-neg_ce, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    num_neg = cfg.ssd_neg_pos_ratio * num_fg
    hard_neg = (rank < num_neg[:, None]) & (fg == 0)
    cls_sums = (ce * fg).sum(-1) + torch.where(
        hard_neg, ce, torch.zeros_like(ce)).sum(-1)
    img_w = gt.get("image_weight")
    if img_w is not None:
        cls_sums, box_sums = cls_sums * img_w, box_sums * img_w
        num_fg = num_fg * img_w
    n = num_fg.sum().clamp(min=1.0)
    return {"classification": cls_sums.sum() / n,
            "bbox_regression": box_sums.sum() / n}


def class_candidates(logits: torch.Tensor, deltas: torch.Tensor,
                     anchors: torch.Tensor, cfg: ModelConfig):
    """Each foreground class's ``k = min(ssd_topk_per_class, N)`` best
    boxes above ``score_thresh``: ``(boxes [B, C-1, k, 4], scores [B,
    C-1, k], valid [B, C-1, k])``, each class's scores descending (ties to
    the lower box index), below-threshold slots at ``NEG_INF`` and
    invalid."""
    k = min(cfg.ssd_topk_per_class, anchors.shape[0])
    scores = F.softmax(logits.float(), -1)
    boxes = box_ops.clip_boxes(
        box_ops.decode_boxes(deltas.float(), anchors,
                             weights=SSD_BOX_WEIGHTS), cfg.image_size)
    sc = scores[..., 1:].transpose(1, 2)                      # [B, C-1, N]
    sc = torch.where(sc > cfg.score_thresh, sc, torch.full_like(sc, NEG_INF))
    top, idx = stable_topk(sc, k)
    b, c1 = idx.shape[:2]
    cboxes = torch.gather(boxes[:, None].expand(-1, c1, -1, -1), 2,
                          idx[..., None].expand(-1, -1, -1, 4))
    return cboxes, top, top > NEG_INF / 2


def select_detections(cboxes: torch.Tensor, cscores: torch.Tensor,
                      keep: torch.Tensor, cfg: ModelConfig) -> Detections:
    """The top ``detections_per_image`` kept candidates of ``[B, C-1, k]``
    per-class candidates, in the merged pool's class-major order (ties to
    the lower pool index), invalid slots zeroed."""
    b, c1, k = cscores.shape
    boxes = cboxes.reshape(b, c1 * k, 4)
    scores = cscores.reshape(b, c1 * k)
    labels = torch.arange(1, c1 + 1, dtype=torch.int32,
                          device=scores.device).repeat_interleave(k)
    oidx, out_valid = topk_by_score(scores, keep.reshape(b, c1 * k),
                                    cfg.detections_per_image)
    zero = scores.new_zeros(())
    return Detections(
        boxes=torch.where(out_valid[..., None],
                          torch.gather(boxes, 1,
                                       oidx[..., None].expand(-1, -1, 4)),
                          zero),
        scores=torch.where(out_valid, torch.gather(scores, 1, oidx), zero),
        labels=torch.where(out_valid, labels[oidx],
                           torch.zeros_like(labels[oidx])),
        valid=out_valid)


def ssd_postprocess(logits: torch.Tensor, deltas: torch.Tensor,
                    anchors: torch.Tensor, cfg: ModelConfig) -> Detections:
    """torchvision's ``SSD.postprocess_detections`` over static shapes:
    :func:`class_candidates`, one NMS segment per (image, class) in one
    launch with JAX's class offsets (so every flag is the merged pool's),
    then :func:`select_detections`."""
    cboxes, cscores, cvalid = class_candidates(logits, deltas, anchors, cfg)
    keep = class_segments_nms_keep(cboxes, cvalid, cfg.nms_thresh)
    return select_detections(cboxes, cscores, keep, cfg)


class SSD(PyramidDetector):
    """SSD300-VGG16 (``backbone="vgg16"``) or SSDLite320-MobileNetV3
    (``"mobilenet_v3"``, its norms trainable with
    ``backbone_norm="batch"``).  ``features`` normalises ``[B, H, W, 3]``
    images as the JAX model (uint8 to [0, 1], then mean and std) and gives
    the six maps."""

    def __init__(self, cfg: ModelConfig):
        dt = DTYPES[cfg.compute_dtype]
        stages = cfg.trainable_backbone_stages
        if cfg.backbone == "vgg16":
            backbone, channels, separable = VGG16SSD(dt, stages), \
                VGG_OUT_CHANNELS, False
        elif cfg.backbone == "mobilenet_v3":
            backbone = MobileNetV3SSDLite(dt, stages,
                                          cfg.backbone_norm == "batch")
            channels, separable = SSDLITE_OUT_CHANNELS, True
        else:
            raise ValueError(
                f"family='ssd*' does not support backbone {cfg.backbone!r}")
        super().__init__(cfg, backbone)
        anchors = tuple(2 + 2 * len(r) for r in cfg.ssd_aspect_ratios)
        self.head = SSDHead(channels, anchors, cfg.num_classes, separable,
                            dt)
        grids = default_boxes(tuple(cfg.image_size),
                              tuple(map(tuple, cfg.ssd_feature_shapes)),
                              tuple(cfg.ssd_scales),
                              tuple(map(tuple, cfg.ssd_aspect_ratios)),
                              steps=tuple(cfg.ssd_steps))
        self.register_buffer("default_boxes", torch.cat(
            [torch.as_tensor(g) for g in grids]), persistent=False)

    def forward(self, images: torch.Tensor, gt: Optional[Dict] = None,
                draws=None, generator=None):
        """Detections of ``[B, H, W, 3]`` images; with ``gt`` the losses
        ``classification`` and ``bbox_regression``.  The model draws
        nothing: ``draws`` and ``generator`` are accepted for the
        two-stage models' signature."""
        logits, deltas = self.head(self.features(images))
        logits, deltas = torch.cat(logits, 1), torch.cat(deltas, 1)
        if gt is not None:
            return ssd_losses(logits, deltas, self.default_boxes, gt,
                              self.cfg)
        return ssd_postprocess(logits, deltas, self.default_boxes, self.cfg)
