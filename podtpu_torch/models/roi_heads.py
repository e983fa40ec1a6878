"""RoI box and mask heads, RoI pooling, training targets and losses, and
detection postprocess.

Counterpart of ``podtpu/models/roi_heads.py``: ``BoxHead`` (torchvision's
TwoMLPHead + FastRCNNPredictor), ``BoxMaskHead`` (the same with the mask
head, JAX's ``MaskHead``), ``BoxKeypointHead`` (the same with the keypoint
head, JAX's ``KeypointHead``), ``sample_rois``, ``box_head_losses``,
``mask_loss`` and ``keypoint_loss`` (batched over images here, vmapped
there), the keypoint codec (``keypoints_to_heatmap``, ``expand_rois``,
``heatmaps_to_keypoints``), ``postprocess_detections`` and
``pool_rois_batched``.  Module names follow torchvision (``box_head.fc6``,
``box_predictor.cls_score``, ``mask_head.mask_fcn1``,
``mask_predictor.conv5_mask``, ``keypoint_head.0``,
``keypoint_predictor.kps_score_lowres``).  fc6 consumes the
pooled features flattened as (C, H, W), torchvision's order, so its weight
is in torchvision layout; the JAX head flattens (H, W, C) and the weight
bridge (``models/weights.py``) permutes between the two.  The v2 recipe's
box head, :class:`FastRCNNConvFCHead` (JAX's ``ConvFCBoxHead``), and its
normed mask tower (JAX's ``MaskHead(norm=True)``) carry torchvision v2's
names (``box_head.{0..3}.{0,1}``, ``box_head.5``, ``mask_head.{0..3}.{0,1}``);
the ConvFC head's Linear flattens (C, H, W) as fc6 does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from podtpu_torch.core.config import ModelConfig
from podtpu_torch.models.fpn import conv_block
from podtpu_torch.models.resnet import Conv2d
from podtpu_torch.models.rpn import smooth_l1
from podtpu_torch.ops import boxes as box_ops
from podtpu_torch.ops import matching
from podtpu_torch.ops.matching import stable_topk
from podtpu_torch.ops.nms import NEG_INF, nms_keep_segments
from podtpu_torch.ops.roi_align import (batched_roi_align,
                                       roi_align_planes_plain)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype``; float32 params."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class TwoMLPHead(nn.Module):
    def __init__(self, in_features: int, hidden: int = 1024,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc6 = Linear(in_features, hidden, compute_dtype=compute_dtype)
        self.fc7 = Linear(hidden, hidden, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.flatten(1)  # a view of contiguous pooled features
        return F.relu(self.fc7(F.relu(self.fc6(x))))


def conv_norm_relu(cin: int, cout: int,
                   compute_dtype: torch.dtype) -> nn.Sequential:
    """3x3 convolution without bias, frozen BatchNorm, ReLU (torchvision's
    ``Conv2dNormActivation``: ``.0``, ``.1``, ``.2``)."""
    return nn.Sequential(*conv_block(cin, cout, 3, True, compute_dtype),
                         nn.ReLU())


class FastRCNNConvFCHead(nn.Sequential):
    """Four ``conv_norm_relu`` blocks at ``channels``, then the features
    flattened as (C, H, W) and a Linear to ``hidden`` with a ReLU
    (torchvision's ``FastRCNNConvFCHead``: blocks 0-3, ``Flatten`` at 4,
    the Linear at 5)."""

    def __init__(self, in_channels: int, pool_size: int,
                 channels: int = 256, hidden: int = 1024,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(
            *(conv_norm_relu(in_channels if i == 0 else channels, channels,
                             compute_dtype) for i in range(4)),
            nn.Flatten(),
            Linear(channels * pool_size ** 2, hidden,
                   compute_dtype=compute_dtype),
            nn.ReLU())


class FastRCNNPredictor(nn.Module):
    def __init__(self, in_features: int, num_classes: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cls_score = Linear(in_features, num_classes,
                                compute_dtype=compute_dtype)
        self.bbox_pred = Linear(in_features, num_classes * 4,
                                compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor):
        return self.cls_score(x), self.bbox_pred(x)


class BoxHead(nn.Module):
    """The box head (``box_head_type`` "mlp": TwoMLPHead; "convfc":
    FastRCNNConvFCHead) and the predictor over ``[N, C, P, P]`` pooled
    features -> float32 class logits ``[N, classes]`` and deltas ``[N,
    classes*4]``."""

    def __init__(self, channels: int, pool_size: int, num_classes: int,
                 hidden: int = 1024,
                 compute_dtype: torch.dtype = torch.float32,
                 box_head_type: str = "mlp"):
        super().__init__()
        if box_head_type == "convfc":
            self.box_head = FastRCNNConvFCHead(channels, pool_size,
                                               channels, hidden,
                                               compute_dtype)
        else:
            self.box_head = TwoMLPHead(channels * pool_size ** 2, hidden,
                                       compute_dtype)
        self.box_predictor = FastRCNNPredictor(hidden, num_classes,
                                               compute_dtype)

    def forward(self, pooled: torch.Tensor):
        logits, deltas = self.box_predictor(self.box_head(pooled))
        return logits.float(), deltas.float()


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that computes in ``compute_dtype``; float32
    params."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt), self.stride,
                                  self.padding)


class MaskRCNNHeads(nn.Module):
    """Four 3x3 convolutions, each followed by ReLU (torchvision's
    ``MaskRCNNHeads``, ``mask_fcn1`` .. ``mask_fcn4``)."""

    def __init__(self, in_channels: int, channels: int = 256,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"mask_fcn{i}", Conv2d(
                in_channels if i == 1 else channels, channels, 3, padding=1,
                compute_dtype=compute_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 5):
            x = F.relu(getattr(self, f"mask_fcn{i}")(x))
        return x


class MaskRCNNNormHeads(nn.Sequential):
    """The v2 mask tower: four ``conv_norm_relu`` blocks (torchvision's
    ``MaskRCNNHeads`` with a norm layer, ``mask_head.{i}.{0,1}``)."""

    def __init__(self, in_channels: int, channels: int = 256,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(*(conv_norm_relu(in_channels if i == 0 else channels,
                                          channels, compute_dtype)
                           for i in range(4)))


class MaskRCNNPredictor(nn.Module):
    """2x2 stride-2 transposed convolution and ReLU, then a 1x1 convolution
    to one logit plane per class (torchvision's ``MaskRCNNPredictor``)."""

    def __init__(self, channels: int, num_classes: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv5_mask = ConvTranspose2d(channels, channels, 2, stride=2,
                                          compute_dtype=compute_dtype)
        self.mask_fcn_logits = Conv2d(channels, num_classes, 1,
                                      compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mask_fcn_logits(F.relu(self.conv5_mask(x)))


class BoxMaskHead(BoxHead):
    """The box head and Mask R-CNN's mask head (JAX's ``MaskHead``) under
    one module, so their parameters carry torchvision's ``roi_heads.*``
    names.  ``mask_logits`` maps ``[N, C, P, P]`` pooled features to float32
    logits ``[N, num_classes, 2P, 2P]`` (channel 0, background, unused)."""

    def __init__(self, channels: int, pool_size: int, num_classes: int,
                 mask_channels: int = 256, hidden: int = 1024,
                 compute_dtype: torch.dtype = torch.float32,
                 box_head_type: str = "mlp", mask_norm: bool = False):
        super().__init__(channels, pool_size, num_classes, hidden,
                         compute_dtype, box_head_type)
        self.mask_head = (MaskRCNNNormHeads if mask_norm else MaskRCNNHeads)(
            channels, mask_channels, compute_dtype)
        self.mask_predictor = MaskRCNNPredictor(mask_channels, num_classes,
                                                compute_dtype)

    def mask_logits(self, pooled: torch.Tensor) -> torch.Tensor:
        return self.mask_predictor(self.mask_head(pooled)).float()


class KeypointRCNNHeads(nn.Sequential):
    """Eight 3x3 convolutions, each followed by ReLU (torchvision's
    ``KeypointRCNNHeads``: the convolutions at indices 0, 2, .., 14)."""

    def __init__(self, in_channels: int, channels: int = 512,
                 compute_dtype: torch.dtype = torch.float32):
        layers = []
        for i in range(8):
            layers += [Conv2d(in_channels if i == 0 else channels, channels,
                              3, padding=1, compute_dtype=compute_dtype),
                       nn.ReLU()]
        super().__init__(*layers)


class KeypointRCNNPredictor(nn.Module):
    """4x4 stride-2 transposed convolution (padding 1) to one plane per
    keypoint, then a 2x bilinear upsample in float32 (torchvision's
    ``KeypointRCNNPredictor``; ``align_corners=False`` is the half-pixel
    ``jax.image.resize`` of the JAX head)."""

    def __init__(self, channels: int, num_keypoints: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kps_score_lowres = ConvTranspose2d(
            channels, num_keypoints, 4, stride=2, padding=1,
            compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _Upsample2x.apply(self.kps_score_lowres(x).float())


def _upsample2x_transpose(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The transpose of the 2x half-pixel linear upsample along ``dim``:
    output ``2i`` reads input ``i`` at 0.75 and ``i - 1`` at 0.25, output
    ``2i + 1`` reads ``i`` at 0.75 and ``i + 1`` at 0.25, the edges their
    own input at 1."""
    g = g.movedim(dim, -1)
    even, odd = g[..., 0::2], g[..., 1::2]
    x = (0.75 * even + 0.25 * F.pad(even[..., 1:], (0, 1))
         + 0.75 * odd + 0.25 * F.pad(odd[..., :-1], (1, 0)))
    x[..., 0] += 0.25 * even[..., 0]
    x[..., -1] += 0.25 * odd[..., -1]
    return x.movedim(-1, dim)


class _Upsample2x(torch.autograd.Function):
    """``F.interpolate(scale_factor=2, mode="bilinear",
    align_corners=False)`` with a backward that sums in a fixed order (the
    transpose, one axis at a time, in slices and adds): on the GPU the
    interpolation's own backward adds with atomics, so two runs of a step
    would part in their last bits."""

    @staticmethod
    def forward(ctx, x):
        return F.interpolate(x, scale_factor=2, mode="bilinear",
                             align_corners=False)

    @staticmethod
    def backward(ctx, g):
        return _upsample2x_transpose(_upsample2x_transpose(g, -1), -2)


class BoxKeypointHead(BoxHead):
    """The box head and Keypoint R-CNN's keypoint head (JAX's
    ``KeypointHead``) under one module, so their parameters carry
    torchvision's ``roi_heads.*`` names.  ``keypoint_logits`` maps ``[N, C,
    P, P]`` pooled features to float32 heatmap logits ``[N, K, 4P, 4P]``."""

    def __init__(self, channels: int, pool_size: int, num_classes: int,
                 num_keypoints: int, keypoint_channels: int = 512,
                 hidden: int = 1024,
                 compute_dtype: torch.dtype = torch.float32,
                 box_head_type: str = "mlp"):
        super().__init__(channels, pool_size, num_classes, hidden,
                         compute_dtype, box_head_type)
        self.keypoint_head = KeypointRCNNHeads(channels, keypoint_channels,
                                               compute_dtype)
        self.keypoint_predictor = KeypointRCNNPredictor(
            keypoint_channels, num_keypoints, compute_dtype)

    def keypoint_logits(self, pooled: torch.Tensor) -> torch.Tensor:
        return self.keypoint_predictor(self.keypoint_head(pooled))


class KeypointOutput(NamedTuple):
    """The keypoint model's extra eval output, typed so that
    ``split_eval_output`` tells it from masks without looking at shapes."""
    keypoints: torch.Tensor  # [B, D, K, 3] (x, y, score), canvas coords


def pick_class(mask_logits: torch.Tensor, labels: torch.Tensor):
    """``[N, M, M]``: each RoI's plane of ``[N, C, M, M]`` for its label."""
    idx = labels.long().view(-1, 1, 1, 1).expand(-1, 1,
                                                  *mask_logits.shape[2:])
    return torch.gather(mask_logits, 1, idx)[:, 0]


class Detections(NamedTuple):
    boxes: torch.Tensor   # [B, D, 4] xyxy, canvas coords
    scores: torch.Tensor  # [B, D]
    labels: torch.Tensor  # [B, D] int32, 1-based (0 = invalid slot)
    valid: torch.Tensor   # [B, D]


def postprocess_detections(logits: torch.Tensor, deltas: torch.Tensor,
                           proposals: torch.Tensor, prop_valid: torch.Tensor,
                           cfg: ModelConfig) -> Detections:
    """Batched final filtering: softmax, per-class decode and clip, score
    and size filters, per-(image, class) NMS in one launch, top
    ``detections_per_image``.  ``logits [B, P, C]``, ``deltas [B, P, 4C]``,
    ``proposals [B, P, 4]``, ``prop_valid [B, P]``."""
    b, p, c = logits.shape
    scores = torch.softmax(logits, dim=-1)
    boxes_pc = box_ops.decode_boxes(deltas.reshape(b, p, c, 4),
                                    proposals[:, :, None, :],
                                    weights=cfg.box_reg_weights)
    boxes_pc = box_ops.clip_boxes(boxes_pc, cfg.image_size)
    # Drop the background column; class-major [B, C-1, P] layout.
    cls_scores = scores[..., 1:].transpose(1, 2)
    cls_boxes = boxes_pc[:, :, 1:, :].transpose(1, 2)
    ok = ((cls_scores > cfg.score_thresh) & prop_valid[:, None, :]
          & box_ops.small_box_mask(cls_boxes, 1e-2))
    keep = nms_keep_segments(cls_boxes.reshape(b * (c - 1), p, 4),
                             cls_scores.reshape(b * (c - 1), p),
                             cfg.nms_thresh, ok.reshape(b * (c - 1), p))
    flat_ok = keep.reshape(b, -1) & ok.reshape(b, -1)
    flat_scores = cls_scores.reshape(b, -1)
    flat_scores = torch.where(flat_ok, flat_scores,
                              torch.full_like(flat_scores, NEG_INF))
    top, idx = stable_topk(flat_scores, cfg.detections_per_image)
    valid = top > NEG_INF / 2
    out_boxes = torch.gather(cls_boxes.reshape(b, -1, 4), 1,
                             idx[..., None].expand(-1, -1, 4))
    labels = (torch.div(idx, p, rounding_mode="floor") + 1).to(torch.int32)
    return Detections(
        boxes=torch.where(valid[..., None], out_boxes,
                          torch.zeros_like(out_boxes)),
        scores=torch.where(valid, top, torch.zeros_like(top)),
        labels=torch.where(valid, labels, torch.zeros_like(labels)),
        valid=valid)


class SampledRois(NamedTuple):
    boxes: torch.Tensor        # [B, S, 4]
    valid: torch.Tensor        # [B, S]
    is_pos: torch.Tensor       # [B, S]
    cls_targets: torch.Tensor  # [B, S] int64, 0 = background
    reg_targets: torch.Tensor  # [B, S, 4]
    gt_index: torch.Tensor     # [B, S] int64 matched gt (mask targets)


@torch.no_grad()
def sample_rois(proposals: torch.Tensor, prop_valid: torch.Tensor,
                gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                gt_valid: torch.Tensor, cfg: ModelConfig, u_pos: torch.Tensor,
                u_neg: torch.Tensor) -> SampledRois:
    """Training RoI subsample: the gt boxes are appended to the ``[B, P, 4]``
    proposals (every gt then has a perfectly overlapping positive), matched
    without low-quality matches, and ``box_batch_per_image`` of the
    ``P + G`` candidates sampled with the draws ``u_pos``/``u_neg
    [B, P + G]``."""
    boxes = torch.cat([proposals, gt_boxes], 1)
    valid = torch.cat([prop_valid, gt_valid], 1)
    iou = box_ops.box_iou(boxes, gt_boxes)
    m = matching.match(iou, gt_valid, cfg.box_fg_iou, cfg.box_bg_iou,
                       allow_low_quality=False)
    labels = torch.where(valid, m.labels, -1)  # padded candidates: ignored
    samp = matching.balanced_sample_gather(
        labels, valid, cfg.box_batch_per_image, cfg.box_positive_fraction,
        u_pos, u_neg)
    sboxes = torch.gather(boxes, 1, samp.idx[..., None].expand(-1, -1, 4))
    matched = torch.gather(m.matched_idx, 1, samp.idx)
    cls_t = torch.where(samp.is_pos, torch.gather(gt_labels.long(), 1,
                                                  matched), 0)
    cls_t = torch.where(samp.valid, cls_t, 0)
    matched_gt = torch.gather(gt_boxes, 1, matched[..., None].expand(-1, -1, 4))
    reg_t = box_ops.encode_boxes(matched_gt, sboxes,
                                 weights=cfg.box_reg_weights)
    return SampledRois(
        boxes=torch.where(samp.valid[..., None], sboxes,
                          torch.zeros_like(sboxes)),
        valid=samp.valid, is_pos=samp.is_pos, cls_targets=cls_t,
        reg_targets=reg_t, gt_index=matched)


def box_head_losses(logits: torch.Tensor, deltas: torch.Tensor,
                    rois: SampledRois,
                    sample_weight: Optional[torch.Tensor] = None):
    """Classification and box-regression losses over ``[N, C]`` logits and
    ``[N, 4C]`` deltas of ``N = B * S`` sampled RoIs (``rois`` fields
    flattened the same way), normalised as torchvision's ``fastrcnn_loss``:
    mean cross-entropy over the samples; box loss summed over positives,
    over the sample count.  ``sample_weight [N]`` scales each sample."""
    n, c = logits.shape
    w = rois.valid.float()
    if sample_weight is not None:
        w = w * sample_weight
    total = w.sum().clamp(min=1.0)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, 1, rois.cls_targets[:, None])[:, 0]
    cls_loss = (ce * w).sum() / total
    picked = torch.gather(deltas.reshape(n, c, 4), 1,
                          rois.cls_targets[:, None, None].expand(-1, 1, 4))
    pw = (rois.is_pos & rois.valid).float()
    if sample_weight is not None:
        pw = pw * sample_weight
    l1 = smooth_l1(picked[:, 0] - rois.reg_targets, 1.0 / 9.0).sum(-1)
    return cls_loss, (l1 * pw).sum() / total


def pool_rois_batched(pyramid: Sequence[torch.Tensor], rois: torch.Tensor,
                      cfg: ModelConfig, pool_size: Optional[int] = None,
                      channels_last: bool = False) -> torch.Tensor:
    """Multi-level RoIAlign of ``[B, K, 4]`` RoIs over the box-head levels
    (NCHW, channels_last) -> ``[B, K, C, P, P]``, contiguous in the order
    ``BoxHead`` flattens, or with ``channels_last`` a view of the kernel's
    ``[B, K, P, P, C]`` output (channels_last planes for the mask head's
    convolutions)."""
    n_lvl = len(cfg.roi_strides)
    # The NHWC view of a channels_last level is contiguous: no copy.
    levels = [f.permute(0, 2, 3, 1).contiguous() for f in pyramid[:n_lvl]]
    pooled = batched_roi_align(
        levels, rois, cfg.roi_strides,
        output_size=pool_size or cfg.roi_pool_size,
        sampling_ratio=cfg.roi_sampling_ratio,
        canonical_scale=cfg.roi_canonical_scale,
        canonical_level=cfg.roi_canonical_level,
        channels_first=not channels_last)
    return pooled.permute(0, 1, 4, 2, 3) if channels_last else pooled


@torch.no_grad()
def crop_mask_targets(masks: torch.Tensor, boxes: torch.Tensor,
                      gt_index: torch.Tensor, stride: int, out: int,
                      ratio: int = 2) -> torch.Tensor:
    """Each RoI's matched gt plane cropped to its box and resampled to
    ``[out, out]``: the ``[B, G, Hm, Wm]`` planes at ``stride`` canvas px a
    cell, ``[B, S, 4]`` boxes and ``[B, S]`` gt indices -> ``[B, S, out,
    out]`` float32.  Plain PyTorch on every device: the JAX package crops
    with XLA's ``multilevel_roi_align``, not with its kernel."""
    b, g = masks.shape[:2]
    s = boxes.shape[1]
    plane = torch.arange(b, device=boxes.device)[:, None] * g + gt_index
    return roi_align_planes_plain(
        masks.reshape(b * g, *masks.shape[2:]), boxes.reshape(-1, 4),
        plane.reshape(-1), stride, out, ratio).reshape(b, s, out, out)


def mask_loss(mask_logits: torch.Tensor, rois: SampledRois,
              gt_masks: torch.Tensor, cfg: ModelConfig,
              img_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary cross-entropy of the positive RoIs' masks (torchvision's
    ``maskrcnn_loss``) over ``[B, S, C, M, M]`` logits, the ``[B, S]``
    sampled RoIs and ``[B, G, Hm, Wm]`` gt planes: each RoI's matched gt
    plane cropped to its box (:func:`crop_mask_targets`), its class's
    logits against the target thresholded at 0.5, averaged over each
    image's positive pixels; then the mean over images or, with
    ``img_weight [B]``, the weighted mean."""
    b, s = rois.boxes.shape[:2]
    m = cfg.mask_resolution
    stride = cfg.image_size[0] // gt_masks.shape[2]
    targets = crop_mask_targets(gt_masks, rois.boxes, rois.gt_index, stride,
                                m)
    picked = pick_class(mask_logits.reshape(b * s, *mask_logits.shape[2:]),
                        rois.cls_targets.reshape(-1)).reshape(b, s, m, m)
    bce = (picked.clamp(min=0) - picked * (targets > 0.5)
           + torch.log1p(torch.exp(-picked.abs())))
    pw = (rois.is_pos & rois.valid).float()
    denom = (pw.sum(1) * m * m).clamp(min=1.0)
    losses = (bce * pw[:, :, None, None]).sum(dim=(1, 2, 3)) / denom
    if img_weight is None:
        return losses.mean()
    return (losses * img_weight).sum() / img_weight.sum().clamp(min=1.0)


def keypoints_to_heatmap(kps: torch.Tensor, rois: torch.Tensor,
                         heatmap_size: int):
    """Each ``[N, K, 3]`` keypoint's cell in its RoI's ``heatmap_size``
    square grid (torchvision's ``keypoints_to_heatmap``) -> ``(lin [N, K]
    int64, valid [N, K] bool)``: valid where visible and inside the RoI.  A
    point exactly on the RoI's right or bottom edge falls in the last
    cell."""
    x1, y1 = rois[:, 0:1], rois[:, 1:2]
    sx = heatmap_size / (rois[:, 2:3] - x1).clamp(min=1e-6)
    sy = heatmap_size / (rois[:, 3:4] - y1).clamp(min=1e-6)
    x_edge = kps[..., 0] == rois[:, 2:3]
    y_edge = kps[..., 1] == rois[:, 3:4]
    x = torch.floor((kps[..., 0] - x1) * sx).long()
    y = torch.floor((kps[..., 1] - y1) * sy).long()
    x = torch.where(x_edge, heatmap_size - 1, x)
    y = torch.where(y_edge, heatmap_size - 1, y)
    inside = (x >= 0) & (y >= 0) & (x < heatmap_size) & (y < heatmap_size)
    valid = inside & (kps[..., 2] > 0)
    lin = (y * heatmap_size + x).clamp(0, heatmap_size * heatmap_size - 1)
    return lin, valid


def keypoint_loss(kp_logits: torch.Tensor, kp_rois: torch.Tensor,
                  rois: SampledRois, gt_keypoints: torch.Tensor,
                  img_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy over the heatmap cells of each visible keypoint of
    each positive RoI (torchvision's ``keypointrcnn_loss``): ``[B, S, K, H,
    H]`` logits pooled over the ``[B, S, 4]`` boxes ``kp_rois`` (the sampled
    RoIs, expanded), ``[B, G, K, 3]`` gt keypoints in canvas coordinates;
    each image's sum over its weights, then the mean over images or, with
    ``img_weight [B]``, the weighted mean.  The log-softmax over each
    heatmap's ``H * H`` cells is taken in float32."""
    b, s, k, h = kp_logits.shape[:4]
    idx = rois.gt_index[..., None, None].expand(-1, -1, k, 3)
    kps = torch.gather(gt_keypoints, 1, idx)                  # [B, S, K, 3]
    target, valid = keypoints_to_heatmap(kps.reshape(b * s, k, 3),
                                         kp_rois.reshape(b * s, 4), h)
    w = (valid & (rois.is_pos & rois.valid).reshape(b * s, 1)).float()
    logp = torch.log_softmax(kp_logits.reshape(b * s * k, h * h), dim=1)
    ce = -torch.gather(logp, 1, target.reshape(-1, 1))[:, 0]
    w = w.reshape(b, s * k)
    losses = (ce.reshape(b, s * k) * w).sum(1) / w.sum(1).clamp(min=1.0)
    if img_weight is None:
        return losses.mean()
    return (losses * img_weight).sum() / img_weight.sum().clamp(min=1.0)


def expand_rois(rois: torch.Tensor, factor: float) -> torch.Tensor:
    """``[..., 4]`` xyxy boxes scaled by ``factor`` about their centres
    (``ModelConfig.keypoint_roi_expand``); the boxes themselves at 1.0."""
    if factor == 1.0:
        return rois
    cx = (rois[..., 0] + rois[..., 2]) * 0.5
    cy = (rois[..., 1] + rois[..., 3]) * 0.5
    hw = (rois[..., 2] - rois[..., 0]) * (0.5 * factor)
    hh = (rois[..., 3] - rois[..., 1]) * (0.5 * factor)
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


def heatmaps_to_keypoints(kp_logits: torch.Tensor,
                          rois: torch.Tensor) -> torch.Tensor:
    """``[D, K, H, H]`` heatmap logits over ``[D, 4]`` boxes -> keypoints
    ``[D, K, 3]`` (x, y, score) in the boxes' frame, as the JAX package
    decodes them: the argmax cell (the first on ties), refined by the
    vertex of the parabola through it and its two neighbours along each
    axis, clamped to half a cell (a cell on the grid's border keeps its
    centre); the score is the softmax probability at the argmax, ``1 /
    sum(exp(logit - max))``."""
    d, k, h = kp_logits.shape[:3]
    flat = kp_logits.reshape(d, k, h * h)
    top, idx = flat.max(dim=-1)
    score = 1.0 / torch.exp(flat - top[..., None]).sum(-1)
    yi = torch.div(idx, h, rounding_mode="floor")
    xi = idx - yi * h

    def val_at(yy, xx):
        lin = yy.clamp(0, h - 1) * h + xx.clamp(0, h - 1)
        return torch.gather(flat, 2, lin[..., None])[..., 0]

    def refine(lo, c, hi, at_border):
        denom = lo - 2.0 * c + hi
        off = torch.where(
            denom.abs() > 1e-12,
            0.5 * (lo - hi) / torch.where(denom == 0, torch.ones_like(denom),
                                          denom),
            torch.zeros_like(denom))
        return torch.where(at_border, torch.zeros_like(off),
                           off.clamp(-0.5, 0.5))

    v0 = val_at(yi, xi)
    dx = refine(val_at(yi, xi - 1), v0, val_at(yi, xi + 1),
                (xi <= 0) | (xi >= h - 1))
    dy = refine(val_at(yi - 1, xi), v0, val_at(yi + 1, xi),
                (yi <= 0) | (yi >= h - 1))
    xf = xi.float() + 0.5 + dx
    yf = yi.float() + 0.5 + dy
    x1, y1 = rois[:, 0:1], rois[:, 1:2]
    w = (rois[:, 2:3] - x1).clamp(min=1e-6)
    hgt = (rois[:, 3:4] - y1).clamp(min=1e-6)
    return torch.stack([x1 + xf * w / h, y1 + yf * hgt / h, score], dim=-1)
