"""Configuration of the PyTorch port.

Field-for-field copies of ``podtpu.core.config``'s ``ModelConfig``,
``TrainConfig``, ``DataConfig``, ``CvatConfig`` and ``Config``, so that a
configuration written by either package loads in the other.  The port
builds the ``faster_rcnn`` family on ``resnet50_fpn``, v1 and the v2
recipe (:func:`fasterrcnn_v2_config`), and on the mobile trunks
(:func:`mobilenet_config`, :func:`mobilenet_v3_fpn_config`), the one-stage
``retinanet`` (v1 and :func:`retinanet_v2_config`) and ``fcos`` families,
and ``ssd`` (:func:`ssd_config`) and ``ssdlite``
(:func:`ssdlite_config`); the other fields are carried so that saved
configurations round-trip unchanged.
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
    # "resnet50_fpn", "mobilenet_v2" (one stride-32 map of 1280 channels)
    # or "mobilenet_v3_fpn" (two stride-32 taps into a two-level FPN);
    # SSD's "vgg16" and SSDLite's "mobilenet_v3".
    backbone: str = "resnet50_fpn"
    backbone_depth: int = 50
    trainable_backbone_stages: int = 3
    # "frozen" (FrozenBatchNorm2d) or "batch" (trainable BatchNorm with
    # running statistics: the mobile trunks' from-scratch norm; a ResNet
    # trunk keeps its frozen norms under either).
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

    # One-stage families (``retinanet``, ``fcos``): IoU bands, focal loss,
    # the per-level top-k and the merged candidate pool of the single
    # class-offset NMS; the v2 recipe's GroupNorm subnets, GIoU regression
    # and P6 from C5; FCOS's centre-sampling radius.  SSD's default boxes
    # (scales, ratios, steps and the head's grids), matcher threshold,
    # hard-negative ratio and per-class candidates.
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

    # Mask and keypoint heads.  ``keypoint_roi_expand`` scales each RoI
    # about its centre before the keypoint head pools it (1.0: torchvision's
    # head); a non-identity ``keypoint_hflip_inds`` marks a chiral skeleton,
    # whose miso policy then never flips vertically.
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
        """Strides of the levels feeding the RoI heads: P2..P5 on the
        ResNet FPN (P6 is RPN-only), the first of the MobileNetV3 FPN's two
        stride-32 levels (torchvision's level mapper collapses to it), the
        one map of MobileNetV2."""
        if self.backbone == "resnet50_fpn":
            return tuple(self.strides[:4])
        if self.backbone == "mobilenet_v3_fpn":
            return (self.strides[0],)
        return tuple(self.strides)


def fasterrcnn_v2_config(cfg: "ModelConfig" = None, **kw) -> "ModelConfig":
    """``cfg`` (``ModelConfig()`` when None) with torchvision's
    ``fasterrcnn_resnet50_fpn_v2`` heads (with ``with_mask=True``,
    ``maskrcnn_resnet50_fpn_v2``'s): a 2-deep RPN tower, the
    ``FastRCNNConvFCHead`` box head, frozen norms in the FPN and in the
    mask tower; ``kw`` overrides any field."""
    fields = dict(rpn_conv_depth=2, box_head_type="convfc", fpn_norm=True,
                  mask_head_norm=True)
    fields.update(kw)
    return dataclasses.replace(cfg or ModelConfig(), **fields)


def mobilenet_config(cfg: "ModelConfig" = None, **kw) -> "ModelConfig":
    """``cfg`` (``ModelConfig()`` when None) as the reference's MobileNetV2
    Faster R-CNN: one stride-32 map, 5 sizes x 3 ratios a location, RoIs
    pooled from that map; ``kw`` overrides any field."""
    return dataclasses.replace(
        cfg or ModelConfig(), backbone="mobilenet_v2", strides=(32,),
        anchor_sizes=((32.0, 64.0, 128.0, 256.0, 512.0),),
        use_pallas_roi_align=False, **kw)


def mobilenet_v3_fpn_config(cfg: "ModelConfig" = None, low_res: bool = False,
                            **kw) -> "ModelConfig":
    """``cfg`` as torchvision's ``fasterrcnn_mobilenet_v3_large_fpn`` (with
    ``low_res``, ``..._320_fpn``): the MobileNetV3-Large trunk tapped at
    ``features[13]`` (160 channels) and its last conv (960), both at stride
    32, a two-level FPN and its stride-2 subsample as the third RPN level,
    15 anchors a location on each, RoIs pooled from the first level.  The
    320 recipe also takes a 320x320 canvas, 150 proposals before and after
    the test-time NMS and an objectness floor of 0.05; ``kw`` overrides any
    field."""
    fields = dict(backbone="mobilenet_v3_fpn", strides=(32, 32, 64),
                  anchor_sizes=((32.0, 64.0, 128.0, 256.0, 512.0),) * 3,
                  anchor_ratios=(0.5, 1.0, 2.0), use_pallas_roi_align=False)
    if low_res:
        fields.update(image_size=(320, 320), rpn_pre_nms_topk_test=150,
                      rpn_post_nms_topk_test=150, rpn_score_thresh=0.05)
    fields.update(kw)
    return dataclasses.replace(cfg or ModelConfig(), **fields)


def retinanet_config(cfg: "ModelConfig" = None, **kw) -> "ModelConfig":
    """``cfg`` (``ModelConfig()`` when None) as torchvision's
    ``retinanet_resnet50_fpn``: P3..P7 (strides 8..128), 3 octave scales x
    3 ratios = 9 anchors a location; ``kw`` overrides any field."""
    octave = (1.0, 2.0 ** (1.0 / 3.0), 2.0 ** (2.0 / 3.0))
    return dataclasses.replace(
        cfg or ModelConfig(), family="retinanet",
        strides=(8, 16, 32, 64, 128),
        anchor_sizes=tuple(
            tuple(s * o for o in octave) for s in (32, 64, 128, 256, 512)),
        **kw)


def retinanet_v2_config(cfg: "ModelConfig" = None, **kw) -> "ModelConfig":
    """``cfg`` with torchvision's ``retinanet_resnet50_fpn_v2`` recipe:
    GroupNorm(32) subnets, GIoU box regression and P6 built from C5.  A
    ``cfg`` that is already ``retinanet`` keeps its anchors and strides;
    any other first becomes :func:`retinanet_config`."""
    base = cfg if (cfg is not None and cfg.family == "retinanet") \
        else retinanet_config(cfg)
    fields = dict(retinanet_head_norm=True, retinanet_box_loss="giou",
                  retinanet_p6_on_c5=True)
    fields.update(kw)
    return dataclasses.replace(base, **fields)


def fcos_config(cfg: "ModelConfig" = None, **kw) -> "ModelConfig":
    """``cfg`` as torchvision's ``fcos_resnet50_fpn``: P3..P7, one
    stride-sized cell box a location, score threshold 0.2, NMS 0.6, 100
    detections."""
    return dataclasses.replace(
        cfg or ModelConfig(), family="fcos", strides=(8, 16, 32, 64, 128),
        anchor_sizes=(8.0, 16.0, 32.0, 64.0, 128.0), anchor_ratios=(1.0,),
        score_thresh=0.2, nms_thresh=0.6, detections_per_image=100, **kw)


def vgg_ssd_feature_shapes(image_size) -> Tuple[Tuple[int, int], ...]:
    """The six head grids of the SSD VGG16 extractor at ``image_size``:
    pools 1, 2 and 4 floor, pool 3 rounds up, then two stride-2 3x3 convs
    padded by 1 and two unpadded 3x3 convs."""
    def per_axis(s: int):
        f0 = -(-(s // 2 // 2) // 2)
        f1 = f0 // 2
        f2 = (f1 - 1) // 2 + 1
        f3 = (f2 - 1) // 2 + 1
        return (f0, f1, f2, f3, f3 - 2, f3 - 4)
    return tuple(zip(per_axis(image_size[0]), per_axis(image_size[1])))


def ssd_config(cfg: "ModelConfig" = None, **kw) -> "ModelConfig":
    """``cfg`` as torchvision's ``ssd300_vgg16``: VGG16 with its extra
    blocks, six maps, the SSD paper's scales and (at 300x300 only) steps,
    the Caffe recipe's input (mean subtracted, times 255), score 0.01, NMS
    0.45, 200 detections, on a 300x300 canvas unless ``kw`` gives
    ``image_size``; ``kw`` overrides any field."""
    image_size = kw.pop("image_size", (300, 300))
    fields = dict(
        family="ssd", backbone="vgg16", image_size=image_size,
        pixel_mean=(0.48235, 0.45882, 0.40784),
        pixel_std=(1.0 / 255.0,) * 3,
        ssd_scales=(0.07, 0.15, 0.33, 0.51, 0.69, 0.87, 1.05),
        ssd_aspect_ratios=((2.0,), (2.0, 3.0), (2.0, 3.0), (2.0, 3.0),
                           (2.0,), (2.0,)),
        ssd_steps=(8, 16, 32, 64, 100, 300) if image_size == (300, 300)
        else (),
        ssd_feature_shapes=vgg_ssd_feature_shapes(image_size),
        score_thresh=0.01, nms_thresh=0.45, detections_per_image=200)
    fields.update(kw)
    return dataclasses.replace(cfg or ModelConfig(), **fields)


def mobilenet_v3_feature_shapes(image_size) -> Tuple[Tuple[int, int], ...]:
    """The six head grids of the SSDLite MobileNetV3 extractor: the C4
    expansion tap at stride 16, then five stride-2 3x3 convs padded by 1
    (each ``(n - 1) // 2 + 1``)."""
    def per_axis(s: int):
        for _ in range(4):
            s = (s - 1) // 2 + 1
        shapes = [s]
        for _ in range(5):
            s = (s - 1) // 2 + 1
            shapes.append(s)
        return shapes
    return tuple(zip(per_axis(image_size[0]), per_axis(image_size[1])))


def ssdlite_config(cfg: "ModelConfig" = None, **kw) -> "ModelConfig":
    """``cfg`` as torchvision's ``ssdlite320_mobilenet_v3_large``:
    MobileNetV3-Large split at the C4 expansion with depthwise extras, six
    default boxes a location (scales 0.2 to 0.95 and 1.0, ratios 2 and 3 on
    every map), input in [-1, 1], score 0.001, NMS 0.55, 300 candidates a
    class and 300 detections, on a 320x320 canvas unless ``kw`` gives
    ``image_size``; ``kw`` overrides any field."""
    image_size = kw.pop("image_size", (320, 320))
    fields = dict(
        family="ssdlite", backbone="mobilenet_v3", image_size=image_size,
        pixel_mean=(0.5, 0.5, 0.5), pixel_std=(0.5, 0.5, 0.5),
        ssd_scales=tuple(0.2 + (0.95 - 0.2) * k / 5.0 for k in range(6))
        + (1.0,),
        ssd_aspect_ratios=((2.0, 3.0),) * 6, ssd_steps=(),
        ssd_feature_shapes=mobilenet_v3_feature_shapes(image_size),
        ssd_topk_per_class=300, score_thresh=0.001, nms_thresh=0.55,
        detections_per_image=300)
    fields.update(kw)
    return dataclasses.replace(cfg or ModelConfig(), **fields)


# Left/right joint swap of the COCO person-17 skeleton under horizontal
# flip (nose, then eye/ear/shoulder/elbow/wrist/hip/knee/ankle L-R pairs).
COCO_17_HFLIP_INDS = (0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13,
                      16, 15)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation and schedule.  Defaults mirror the reference trainer
    (torch SGD lr 0.005, momentum 0.9, weight decay 5e-4; Adam lr 1e-3).
    With the dataset held on the device (``DataConfig.device_data_cache``),
    ``train()`` runs full groups of ``steps_per_dispatch`` steps as one
    dispatch (one CUDA graph replay on the GPU; 1 runs every step singly)
    and each step gathers its batch there as ``cache_gather`` says
    ("take" or "slice": one ``index_select`` a field either way)."""

    batch_size: int = 2
    optimiser: str = "sgd"  # 'sgd' | 'adam' | 'adamw'
    lr: float = 0.005
    momentum: float = 0.9
    # "float32" or "bfloat16": the SGD momentum buffer's storage type; the
    # update computes in float32 either way.
    momentum_dtype: str = "float32"
    fused_sgd: bool = False
    steps_per_dispatch: int = 8
    cache_gather: str = "slice"
    weight_decay: float = 0.0005
    adam_lr: float = 0.001
    # Weight decay of normalisation parameters; None: they decay with the
    # rest.
    norm_weight_decay: object = None
    # Epoch-0 linear warmup.
    warmup_iters: int = 1000
    warmup_start_factor: float = 1.0 / 1000.0
    # ALRS early stopping.
    alrs_factor: float = 0.5
    alrs_drops: int = 4
    alrs_epochs: int = 10
    alrs_startup_factor: int = 2
    max_epochs: int = 500
    lr_schedule: str = "alrs"  # 'alrs' | 'multistep' | 'cosine'
    epochs: int = 26
    lr_steps: Tuple[int, ...] = (16, 22)
    lr_gamma: float = 0.1
    split_fraction: float = 0.2
    split_seed: int = 1
    nan_is_fatal: bool = True
    log_every: int = 10
    clip_grad_norm: object = None  # global-norm cap; None: no clipping
    calibrate_bn: object = "auto"
    zero_map_warn_epochs: int = 5
    abort_on_zero_map: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input pipeline knobs."""

    num_workers: int = 4
    prefetch: int = 2
    # 'miso' (hflip + vflip + photometric distortion), 'hflip', 'lsj'
    # (scale jitter 0.1-2.0 + hflip), 'multiscale' (0.5-1.25 + hflip),
    # 'ssd' (photometric distortion, zoom-out, IoU crop, hflip), 'ssdlite'
    # (IoU crop, hflip), 'none'.
    aug_policy: str = "miso"
    hflip_prob: float = 0.5
    vflip_prob: float = 0.5
    photometric_distort: bool = True
    device_prefetch: bool = False
    copy_paste: bool = False
    decode_cache: object = "auto"
    # Training data held on the device: "auto" (when it fits the budget of
    # podtpu_torch/data/device_cache.py; else the windowed stream), True,
    # or False (batches stream from the host through the Loader).
    device_data_cache: object = "auto"


@dataclasses.dataclass(frozen=True)
class CvatConfig:
    """CVAT server connection."""

    server: str = "http://cvat:8080"
    username: str = "admin"
    password: str = "admin"
    api: str = "v1"
    is_wsl2: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    cvat: CvatConfig = dataclasses.field(default_factory=CvatConfig)


def _detuple(v):
    if isinstance(v, list):
        return tuple(_detuple(x) for x in v)
    return v


def _from_dict(cls, cfg_dict: Dict):
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: _detuple(v) if k in fields else v
                  for k, v in cfg_dict.items()})


def model_config_from_dict(cfg_dict: Dict) -> ModelConfig:
    """Rebuild a ModelConfig from its JSON form (lists back to tuples, nested
    per-level anchor sizes included)."""
    return _from_dict(ModelConfig, cfg_dict)


def config_from_dict(cfg_dict: Dict) -> Config:
    """Rebuild a Config from ``dataclasses.asdict`` of either package's
    ``Config`` after a JSON round trip."""
    return Config(model=model_config_from_dict(cfg_dict.get("model", {})),
                  train=_from_dict(TrainConfig, cfg_dict.get("train", {})),
                  data=_from_dict(DataConfig, cfg_dict.get("data", {})),
                  cvat=_from_dict(CvatConfig, cfg_dict.get("cvat", {})))
