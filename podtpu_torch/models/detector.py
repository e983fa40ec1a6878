"""Faster R-CNN, Mask R-CNN and Keypoint R-CNN: eval forward and training
losses; and ``make_detector``, which also builds the one-stage families
(``models/retinanet.py``, ``models/fcos.py``) and SSD
(``models/ssd.py``).

Counterpart of ``podtpu/models/detector.py`` (``FasterRCNN`` on the
``resnet50_fpn`` backbone with the MLP box head or, in the v2 recipe
(``core.config.fasterrcnn_v2_config``), the normed FPN, the 2-deep RPN
tower and the ConvFC box head; on the ``mobilenet_v2`` trunk, whose one
1280-channel map feeds the RPN and the RoI heads without an FPN, or the
``mobilenet_v3_fpn`` trunk and its two-level FPN; with ``with_mask`` the
mask head (normed in v2) or, with ``with_keypoints``, the keypoint head;
and ``make_detector``).
The forward takes ``[B, H, W, 3]`` images (uint8, or float in [0, 1]) like
the JAX model, normalises them in float32 (``models.fpn.PyramidDetector``;
``features`` gives P2..P6) and runs the network on NCHW tensors in
``torch.channels_last`` memory.  Capacities are static:
``rpn_post_nms_topk_*`` proposals and ``detections_per_image`` detections
per image, with validity masks.

Given ground truth, the forward returns the training losses instead of
detections (four, and ``loss_mask`` for a mask model given ``masks``,
``loss_keypoint`` for a keypoint model given ``keypoints``).  A mask
model's eval forward returns ``(Detections, masks)``, each detection's
mask probabilities ``[B, D, 28, 28]`` for its label; a keypoint model's
``(Detections, KeypointOutput)``, each detection's ``[K, 3]`` keypoints
(x, y, score) in canvas coordinates.  The keypoint head pools each box
expanded by ``keypoint_roi_expand`` about its centre, and runs on every
sampled RoI and every detection slot, as in the JAX package.  Its random
decisions (the RPN's and the RoI head's sampler draws) are the explicit
tensors of :class:`ModelDraws`, made by :func:`draw_model` from a
``torch.Generator`` or handed in by a caller.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from podtpu_torch.core.config import ModelConfig
from podtpu_torch.models import mobilenet, mobilenet_v3
from podtpu_torch.models import roi_heads as rh
from podtpu_torch.models import rpn as rpn_lib
from podtpu_torch.models.fcos import FCOS
from podtpu_torch.models.fpn import (BackboneWithFPN, FeaturePyramidNetwork,
                                     PyramidDetector)
from podtpu_torch.models.resnet import (BatchNorm2d, FrozenBatchNorm2d,
                                        ResNet, variance_scaling_)
from podtpu_torch.models.retinanet import DTYPES, PRIOR_BIAS, RetinaNet
from podtpu_torch.models.ssd import SSD
from podtpu_torch.ops.anchors import grid_anchors


# Levels of each two-stage trunk's pyramid (RPN levels).
PYRAMID_LEVELS = {"resnet50_fpn": 5, "mobilenet_v2": 1,
                  "mobilenet_v3_fpn": 3}


def make_backbone(cfg: ModelConfig, dt: torch.dtype):
    """``(backbone, channels)``: the trunk of ``cfg.backbone`` (with its FPN
    where it has one) and the width of the maps the heads read.  The mobile
    trunks' norms train with ``backbone_norm="batch"``; ResNet's stay
    frozen under either, as in the JAX package."""
    stages = cfg.trainable_backbone_stages
    batch = cfg.backbone_norm == "batch"
    if cfg.backbone == "mobilenet_v2":
        return (mobilenet.MobileNetV2(dt, stages, batch),
                mobilenet.OUT_CHANNELS)
    if cfg.backbone == "mobilenet_v3_fpn":
        body = mobilenet_v3.MobileNetV3Body(dt, stages, batch)
        fpn = FeaturePyramidNetwork(mobilenet_v3.FPN_IN_CHANNELS,
                                    cfg.fpn_channels, compute_dtype=dt)
        return BackboneWithFPN(body, fpn), cfg.fpn_channels
    return BackboneWithFPN(
        ResNet((3, 4, 6, 3), compute_dtype=dt, trainable_stages=stages),
        FeaturePyramidNetwork((256, 512, 1024, 2048), cfg.fpn_channels,
                              compute_dtype=dt, norm=cfg.fpn_norm)
    ), cfg.fpn_channels


class FasterRCNN(PyramidDetector):
    def __init__(self, cfg: ModelConfig):
        dt = DTYPES[cfg.compute_dtype]
        backbone, channels = make_backbone(cfg, dt)
        super().__init__(cfg, backbone)
        anchors = grid_anchors(tuple(cfg.image_size), tuple(cfg.strides),
                               tuple(cfg.anchor_sizes),
                               tuple(cfg.anchor_ratios))
        self.rpn = rpn_lib.RegionProposalNetwork(
            rpn_lib.RPNHead(channels, cfg.anchors_per_location,
                            compute_dtype=dt, conv_depth=cfg.rpn_conv_depth),
            anchors)
        box_kw = dict(compute_dtype=dt, box_head_type=cfg.box_head_type)
        if cfg.with_mask:
            self.roi_heads = rh.BoxMaskHead(
                channels, cfg.roi_pool_size, cfg.num_classes,
                cfg.mask_head_channels, mask_norm=cfg.mask_head_norm,
                **box_kw)
        elif cfg.with_keypoints:
            self.roi_heads = rh.BoxKeypointHead(
                channels, cfg.roi_pool_size, cfg.num_classes,
                cfg.num_keypoints, cfg.keypoint_head_channels, **box_kw)
        else:
            self.roi_heads = rh.BoxHead(channels, cfg.roi_pool_size,
                                        cfg.num_classes, **box_kw)

    def forward(self, images: torch.Tensor, gt: Optional[Dict] = None,
                draws: Optional["ModelDraws"] = None,
                generator: Optional[torch.Generator] = None):
        """Detections of ``[B, H, W, 3]`` images (with their masks or
        keypoints for a mask or keypoint model); with ``gt`` (``boxes [B,
        G, 4]``, ``labels [B, G]``, ``valid [B, G]``, optional
        ``image_weight [B]`` and, for a mask model, ``masks [B, G, Hm,
        Wm]``, for a keypoint model ``keypoints [B, G, K, 3]``) the dict of
        training losses, with
        the sampler draws ``draws`` or, if None, draws from
        ``generator``."""
        cfg = self.cfg
        pyramid = self.features(images)
        level_logits, level_deltas = self.rpn.head(pyramid)
        if gt is not None:
            if draws is None:
                draws = draw_model(generator, cfg, images.shape[0],
                                   gt["boxes"].shape[1])
            return self._losses(pyramid, level_logits, level_deltas, gt,
                                draws)
        proposals = rpn_lib.select_proposals(
            level_logits, level_deltas, self.rpn.anchors(), cfg, train=False)
        pooled = self.pool_boxes(pyramid, proposals.boxes)
        b, p = pooled.shape[:2]
        logits, deltas = self.roi_heads(pooled.reshape(b * p,
                                                       *pooled.shape[2:]))
        det = rh.postprocess_detections(
            logits.reshape(b, p, -1), deltas.reshape(b, p, -1),
            proposals.boxes, proposals.valid, cfg)
        if cfg.with_mask:
            return det, self._predict_masks(pyramid, det)
        if cfg.with_keypoints:
            return det, rh.KeypointOutput(self._predict_keypoints(pyramid,
                                                                  det))
        return det

    def pool_boxes(self, pyramid, boxes):
        """``[B, K, C, P, P]`` box-head features of ``[B, K, 4]`` boxes:
        contiguous for the MLP head's flatten, channels_last planes for the
        ConvFC head's convolutions."""
        return rh.pool_rois_batched(
            pyramid, boxes, self.cfg,
            channels_last=self.cfg.box_head_type == "convfc")

    def _mask_logits(self, pyramid, boxes):
        """``[B, K, C, M, M]`` mask logits of ``[B, K, 4]`` boxes."""
        pooled = rh.pool_rois_batched(pyramid, boxes, self.cfg,
                                      pool_size=self.cfg.mask_pool_size,
                                      channels_last=True)
        b, k = pooled.shape[:2]
        logits = self.roi_heads.mask_logits(
            pooled.reshape(b * k, *pooled.shape[2:]))
        return logits.reshape(b, k, *logits.shape[1:])

    def _predict_masks(self, pyramid, det: rh.Detections) -> torch.Tensor:
        """Sigmoid of each detection's label plane, ``[B, D, M, M]``
        (every slot, valid or not)."""
        logits = self._mask_logits(pyramid, det.boxes)
        b, d = logits.shape[:2]
        return torch.sigmoid(rh.pick_class(
            logits.reshape(b * d, *logits.shape[2:]),
            det.labels.reshape(-1)).reshape(b, d, *logits.shape[3:]))

    def _keypoint_logits(self, pyramid, boxes):
        """``(kp_rois [B, K, 4], logits [B, K, J, H, H])``: the ``[B, K,
        4]`` boxes expanded by ``keypoint_roi_expand``, and the heatmap
        logits pooled over them."""
        cfg = self.cfg
        kp_rois = rh.expand_rois(boxes, cfg.keypoint_roi_expand)
        pooled = rh.pool_rois_batched(pyramid, kp_rois, cfg,
                                      pool_size=cfg.keypoint_pool_size,
                                      channels_last=True)
        b, k = pooled.shape[:2]
        logits = self.roi_heads.keypoint_logits(
            pooled.reshape(b * k, *pooled.shape[2:]))
        return kp_rois, logits.reshape(b, k, *logits.shape[1:])

    def _predict_keypoints(self, pyramid, det: rh.Detections
                           ) -> torch.Tensor:
        """``[B, D, K, 3]`` keypoints (x, y, score) of every detection
        slot, valid or not."""
        kp_rois, logits = self._keypoint_logits(pyramid, det.boxes)
        b, d = logits.shape[:2]
        kps = rh.heatmaps_to_keypoints(
            logits.reshape(b * d, *logits.shape[2:]),
            kp_rois.reshape(b * d, 4))
        return kps.reshape(b, d, *kps.shape[1:])

    def _losses(self, pyramid, level_logits, level_deltas, gt, draws):
        cfg = self.cfg
        anchors = self.rpn.anchors()
        # Proposals carry no gradient (torchvision): none flows from the
        # RoI head through box coordinates into the RPN.
        with torch.no_grad():
            proposals = rpn_lib.select_proposals(
                level_logits, level_deltas, anchors, cfg, train=True)
        img_w = gt.get("image_weight")
        obj_loss, rpn_box_loss = rpn_lib.rpn_losses(
            level_logits, level_deltas, torch.cat(anchors), gt["boxes"],
            gt["valid"], cfg, draws.rpn_pos, draws.rpn_neg,
            img_weight=img_w)
        sampled = rh.sample_rois(proposals.boxes, proposals.valid,
                                 gt["boxes"], gt["labels"], gt["valid"], cfg,
                                 draws.roi_pos, draws.roi_neg)
        pooled = self.pool_boxes(pyramid, sampled.boxes)
        b, s = pooled.shape[:2]
        logits, deltas = self.roi_heads(pooled.reshape(b * s,
                                                       *pooled.shape[2:]))
        flat = rh.SampledRois(*(x.reshape(b * s, *x.shape[2:])
                                for x in sampled))
        sw = None if img_w is None else img_w.repeat_interleave(s)
        cls_loss, box_loss = rh.box_head_losses(logits, deltas, flat,
                                                sample_weight=sw)
        losses = {"loss_objectness": obj_loss,
                  "loss_rpn_box_reg": rpn_box_loss,
                  "loss_classifier": cls_loss,
                  "loss_box_reg": box_loss}
        if cfg.with_mask and "masks" in gt:
            losses["loss_mask"] = rh.mask_loss(
                self._mask_logits(pyramid, sampled.boxes), sampled,
                gt["masks"], cfg, img_weight=img_w)
        if cfg.with_keypoints and "keypoints" in gt:
            # Targets are binned in the frame the heatmaps were pooled over.
            kp_rois, kp_logits = self._keypoint_logits(pyramid,
                                                       sampled.boxes)
            losses["loss_keypoint"] = rh.keypoint_loss(
                kp_logits, kp_rois, sampled, gt["keypoints"],
                img_weight=img_w)
        return losses


class ModelDraws(NamedTuple):
    """Uniform draws of the two samplers, one per candidate."""
    rpn_pos: torch.Tensor  # [B, N_anchors]
    rpn_neg: torch.Tensor  # [B, N_anchors]
    roi_pos: torch.Tensor  # [B, P + G]: post-NMS proposals, then the gts
    roi_neg: torch.Tensor  # [B, P + G]


def num_anchors(cfg: ModelConfig) -> int:
    return sum(len(a) for a in grid_anchors(
        tuple(cfg.image_size), tuple(cfg.strides), tuple(cfg.anchor_sizes),
        tuple(cfg.anchor_ratios)))


ONE_STAGE = ("retinanet", "fcos")
SSD_FAMILIES = ("ssd", "ssdlite")


def draw_model(generator: Optional[torch.Generator], cfg: ModelConfig,
               batch: int, num_gt: int) -> Optional[ModelDraws]:
    """The samplers' draws for ``batch`` images with ``num_gt`` gt slots
    each, on ``generator``'s device; None for a one-stage or SSD model,
    which draws nothing."""
    if cfg.family in ONE_STAGE + SSD_FAMILIES:
        return None
    if generator is None:
        raise ValueError("training needs a torch.Generator or explicit draws")
    n = num_anchors(cfg)
    m = cfg.rpn_post_nms_topk_train + num_gt

    def u(*shape):
        return torch.rand(shape, generator=generator,
                          device=generator.device)

    return ModelDraws(rpn_pos=u(batch, n), rpn_neg=u(batch, n),
                      roi_pos=u(batch, m), roi_neg=u(batch, m))


def _unsupported(cfg: ModelConfig) -> Optional[str]:
    if cfg.family not in ("faster_rcnn",) + ONE_STAGE + SSD_FAMILIES:
        return f"family={cfg.family!r}"
    if cfg.family in SSD_FAMILIES:
        return None
    if cfg.backbone not in PYRAMID_LEVELS:
        return f"backbone={cfg.backbone!r}"
    if cfg.family == "faster_rcnn" and cfg.backbone == "resnet50_fpn" and (
            cfg.anchors_per_location != len(cfg.anchor_ratios)
            or len(cfg.strides) != 5):
        return "anchor layouts other than one size per P2..P6 level"
    if cfg.family == "faster_rcnn" and cfg.backbone != "resnet50_fpn" and (
            len(cfg.strides) != PYRAMID_LEVELS[cfg.backbone]
            or len(cfg.anchor_sizes) != len(cfg.strides)
            or any(not isinstance(s, (tuple, list))
                   or len(s) != len(cfg.anchor_sizes[0])
                   for s in cfg.anchor_sizes)):
        return (f"anchor layouts of {cfg.backbone} other than one tuple of "
                "sizes, the same for every level, per level of its pyramid")
    if cfg.family in ONE_STAGE and len(cfg.strides) != 5:
        return "one-stage pyramids other than P3..P7"
    return None


def make_detector(cfg: ModelConfig) -> nn.Module:
    """The model for ``cfg``: ``FasterRCNN``, ``RetinaNet``, ``FCOS`` or
    ``SSD``; raises ``NotImplementedError`` for a family or backbone the
    JAX package does not have either, and ``ValueError`` for a mask head
    beside a keypoint head, the v2 recipe on another backbone than
    ResNet-50-FPN, a one-stage family with a mask or keypoint head or
    another backbone, or SSD with a mask or keypoint head or another
    backbone than its own, as the JAX package does."""
    if cfg.family in ONE_STAGE and (cfg.with_mask or cfg.with_keypoints
                                    or cfg.backbone != "resnet50_fpn"):
        raise ValueError(
            f"family={cfg.family!r} supports neither with_mask/"
            "with_keypoints (no RoI stage) nor non-ResNet backbones "
            "(needs the P3-P7 FPN)")
    if cfg.family in SSD_FAMILIES and cfg.with_keypoints:
        raise ValueError(
            "with_keypoints requires family='faster_rcnn' (SSD has no "
            "RoI stage)")
    if cfg.with_mask and cfg.with_keypoints:
        raise ValueError(
            "with_mask and with_keypoints are mutually exclusive (the "
            "torchvision zoo has no combined model, and the inference "
            "output carries one extra head)")
    if (cfg.rpn_conv_depth != 1 or cfg.box_head_type != "mlp"
            or cfg.fpn_norm) and cfg.backbone != "resnet50_fpn":
        raise ValueError(
            "family='faster_rcnn_v2' requires the ResNet-50-FPN backbone "
            "(torchvision has no v2 recipe for the mobilenet extractors, "
            "and their FPN/head wiring differs)")
    if cfg.family in SSD_FAMILIES:
        if cfg.with_mask:
            raise ValueError(
                "family='ssd'/'ssdlite' supports no mask head (SSD has no "
                "RoI stage; use family='faster_rcnn' with with_mask)")
        return SSD(cfg)
    missing = _unsupported(cfg)
    if missing is not None:
        raise NotImplementedError(f"podtpu_torch does not port {missing} "
                                  "yet")
    if cfg.family == "retinanet":
        return RetinaNet(cfg)
    if cfg.family == "fcos":
        return FCOS(cfg)
    return FasterRCNN(cfg)


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise as flax does: ``lecun_normal`` convs and dense layers
    (the mobile trunks' stems, depthwise and squeeze-excitation convs too),
    ``variance_scaling(2, fan_out)`` for the ResNet stem, zero biases,
    identity frozen and trainable BatchNorm (running statistics zeros and
    ones); a one-stage head's convs ``normal(0.01)``, its
    ``cls_logits`` bias at the prior ``-log(99)`` and its GroupNorms at
    ones and zeros (SSD's head convs are plain convs).  Draws come from
    ``generator`` (a CPU generator; the model must be on the CPU)."""
    one_stage = getattr(model, "cfg", None) is not None \
        and model.cfg.family in ONE_STAGE
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Conv2d) and one_stage \
                and name.startswith("head."):
            with torch.no_grad():
                mod.weight.normal_(0.0, 0.01, generator=generator)
                if mod.bias is not None:
                    mod.bias.fill_(PRIOR_BIAS if name.endswith("cls_logits")
                                   else 0.0)
        elif isinstance(mod, nn.GroupNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.ConvTranspose2d):
            # [in, out, kH, kW]: flax's fan_in is in * kH * kW.
            variance_scaling_(mod.weight.data.transpose(0, 1), 1.0,
                              "fan_in", generator)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, (nn.Conv2d, nn.Linear)):
            stem = name.endswith("body.conv1")
            variance_scaling_(mod.weight.data, 2.0 if stem else 1.0,
                              "fan_out" if stem else "fan_in", generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, (FrozenBatchNorm2d, BatchNorm2d)):
            with torch.no_grad():
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)

