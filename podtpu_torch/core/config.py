"""Model configuration of the PyTorch port.

A field-for-field copy of ``podtpu.core.config.ModelConfig``, so that a
``config.json`` written by either package loads in the other.  The port
builds only the ``faster_rcnn`` / ``resnet50_fpn`` / ``box_head_type="mlp"``
eval path so far (``models.detector.make_detector`` refuses the rest); the
other fields are carried so that saved configurations round-trip unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Faster R-CNN ResNet-50-FPN architecture + postprocess knobs.

    Defaults mirror torchvision's ``fasterrcnn_resnet50_fpn``, with a static
    canvas and fixed proposal/detection capacities in place of dynamic sizes.
    """

    num_classes: int = 2  # including background class 0
    image_size: Tuple[int, int] = (1024, 1024)
    pixel_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    pixel_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)

    family: str = "faster_rcnn"
    backbone: str = "resnet50_fpn"
    backbone_depth: int = 50
    trainable_backbone_stages: int = 3
    backbone_norm: str = "frozen"
    fpn_channels: int = 256
    stem_space_to_depth: bool = False

    anchor_sizes: Tuple = (32, 64, 128, 256, 512)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    strides: Tuple[int, ...] = (4, 8, 16, 32, 64)

    rpn_conv_depth: int = 1
    rpn_pack_levels: bool = False
    box_head_type: str = "mlp"
    fpn_norm: bool = False
    mask_head_norm: bool = False

    # RPN
    rpn_pre_nms_topk_train: int = 2000  # per level
    rpn_pre_nms_topk_test: int = 1000
    rpn_post_nms_topk_train: int = 2000  # total
    rpn_post_nms_topk_test: int = 1000
    rpn_nms_thresh: float = 0.7
    rpn_fg_iou: float = 0.7
    rpn_bg_iou: float = 0.3
    rpn_batch_per_image: int = 256
    rpn_positive_fraction: float = 0.5
    rpn_min_size: float = 1e-3
    rpn_score_thresh: float = 0.0

    # RoI box head
    roi_pool_size: int = 7
    roi_sampling_ratio: int = 2
    roi_canonical_scale: float = 224.0
    roi_canonical_level: int = 4
    box_fg_iou: float = 0.5
    box_bg_iou: float = 0.5
    box_batch_per_image: int = 512
    box_positive_fraction: float = 0.25
    box_reg_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)

    # Detection postprocess
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_image: int = 300

    # One-stage families (not ported yet; carried for config round trips)
    retinanet_fg_iou: float = 0.5
    retinanet_bg_iou: float = 0.4
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    retinanet_topk_per_level: int = 1000
    retinanet_nms_candidates: int = 5000
    retinanet_head_norm: bool = False
    retinanet_box_loss: str = "l1"
    retinanet_p6_on_c5: bool = False
    fcos_center_radius: float = 1.5
    ssd_scales: Tuple[float, ...] = ()
    ssd_aspect_ratios: Tuple = ()
    ssd_steps: Tuple[int, ...] = ()
    ssd_feature_shapes: Tuple = ()
    ssd_iou_thresh: float = 0.5
    ssd_neg_pos_ratio: float = 3.0
    ssd_topk_per_class: int = 400

    # Mask / keypoint heads (not ported yet)
    with_mask: bool = False
    mask_pool_size: int = 14
    mask_resolution: int = 28
    mask_head_channels: int = 256
    mask_gt_stride: int = 8
    with_keypoints: bool = False
    num_keypoints: int = 17
    keypoint_pool_size: int = 14
    keypoint_resolution: int = 56
    keypoint_head_channels: int = 512
    keypoint_roi_expand: float = 1.0
    keypoint_hflip_inds: Tuple[int, ...] = ()

    # Static capacities
    max_gt_boxes: int = 100

    # Compute policy: convs and dense layers run in this dtype with float32
    # parameters.  ``approx_topk`` and ``use_pallas_roi_align`` select TPU
    # code paths; the port always takes exact top-k and its own kernels.
    compute_dtype: str = "bfloat16"
    approx_topk: bool = True
    use_pallas_roi_align: bool = True

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    @property
    def anchors_per_location(self) -> int:
        first = self.anchor_sizes[0]
        per_level = len(first) if isinstance(first, (tuple, list)) else 1
        return len(self.anchor_ratios) * per_level

    @property
    def roi_strides(self) -> Tuple[int, ...]:
        """Strides of the levels feeding the RoI heads (P2..P5 on the FPN
        model; P6 is RPN-only)."""
        if self.backbone == "resnet50_fpn":
            return tuple(self.strides[:4])
        if self.backbone == "mobilenet_v3_fpn":
            return (self.strides[0],)
        return tuple(self.strides)


def model_config_from_dict(cfg_dict: Dict) -> ModelConfig:
    """Rebuild a ModelConfig from its JSON form (lists back to tuples, nested
    per-level anchor sizes included)."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}

    def detuple(v):
        if isinstance(v, list):
            return tuple(detuple(x) for x in v)
        return v

    return ModelConfig(**{k: detuple(v) if k in fields else v
                          for k, v in cfg_dict.items()})
