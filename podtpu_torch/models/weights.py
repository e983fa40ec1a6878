"""Bridge between the JAX package's parameter trees and the port's modules.

A saved model holds two flax trees of numpy arrays, ``params`` and
``frozen``.  :func:`state_dict_from_flax` turns them into the port's state
dict (torchvision names and layouts); :func:`flax_from_state_dict` is its
exact inverse.  The transforms are those of
``podtpu/models/weights.py`` read backwards:

* conv weights: flax HWIO <-> torch OIHW;
* dense weights: flax ``[in, out]`` <-> torch ``[out, in]``;
* fc6: the JAX box head flattens pooled features as (H, W, C), the port as
  (C, H, W) (torchvision), so the input axis is permuted as well;
* the mask and keypoint heads' transposed convolutions: torch ``[in, out,
  kH, kW]`` <-> flax HWIO ``[kH, kW, in, out]`` with the spatial taps
  flipped (the keypoint head's torch ``padding=1`` is flax's padding 2 on
  the dilated input: the layer computes the same either way);
* frozen BatchNorm ``weight/bias/mean/var`` <-> the buffers
  ``weight/bias/running_mean/running_var``.

The v2 recipe's tensors follow the JAX package's
``fasterrcnn_v2_key_map``: the FPN's convolutions ``inner_blocks.i.0`` with
their norms ``.1`` (flax ``fpn/lateral{i+2}`` and ``lateral{i+2}_bn``), the
RPN tower ``rpn.head.conv.{d}.0`` (``rpn_head/conv``, ``conv2``, ...), the
ConvFC box head ``box_head.{i}.{0,1}`` (``box_head/conv{i+1}``,
``bn{i+1}``) and its Linear ``box_head.5`` (``box_head/fc``, permuted as
fc6), and the normed mask tower ``mask_head.{i}.{0,1}``.

The mobile trunks follow ``mobilenet_v2_key_map`` (the port's
``backbone.{i}``, torchvision's ``features.{i}``; flax ``backbone/stem``,
``block{i}/{expand,dw,project}``, ``head`` and their ``bn_*``) and
``fasterrcnn_mobilenet_v3_key_map`` (``backbone.body.{i}.block.{j}``, the
squeeze-excitation's ``se_fc1``/``se_fc2``, the FPN's ``lateral0..1`` and
``post0..1``).  A trainable BatchNorm (``backbone_norm="batch"``) keeps
``weight``/``bias`` in flax ``params`` and ``mean``/``var`` in ``frozen``;
its ``num_batches_tracked`` has no flax counterpart: 0 on the way in,
dropped on the way out.

SSD follows ``ssd_vgg16_key_map`` (``backbone.features.{i}`` to conv4_3,
``scale_weight`` as ``l2norm_scale``, conv5_x at ``extra.0.{1,3,5}``, fc6
and fc7 at ``extra.0.7.{1,3}``, the extras ``extra.{k}.{0,2}``, the heads
``head.{classification,regression}_head.module_list.{k}`` as ``head/cls{k}``
and ``reg{k}``) and SSDLite ``ssdlite_key_map`` (block 13 split between
``backbone.features.0.13`` and ``.1.0``, the extras ``extra.{k}.{0,1,2}``
as ``extra{k+1}_1``, ``_dw``, ``_2`` with ``_bn1..3``, each head's ``dw``,
``bn`` (always frozen) and ``pw``).

The one-stage families follow ``retinanet_key_map``,
``retinanet_v2_key_map`` and ``fcos_key_map``: the FPN over C3..C5
(``fpn/lateral3..5``, ``post3..5``) with ``extra_blocks.p6``/``.p7``
(``fpn/p6``, ``fpn/p7``), RetinaNet's subnets ``head.{classification,
regression}_head.conv.{i}.0`` (``head/{cls,box}_conv{i}``) with v2's
GroupNorm at ``.1`` (``{cls,box}_gn{i}``, ``weight`` <-> ``scale``), FCOS's
``conv.{3i}`` and ``conv.{3i+1}``, ``cls_logits``, ``bbox_reg``
(``box_deltas``) and ``bbox_ctrness`` (``ctrness``).
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

from podtpu_torch.models.mobilenet import V2_SETTINGS
from podtpu_torch.models.mobilenet_v3 import V3_LARGE_SETTINGS

STAGE_SIZES = (3, 4, 6, 3)
_BN_LEAVES = (("weight", "weight"), ("bias", "bias"),
              ("running_mean", "mean"), ("running_var", "var"))


def _bn(port: str, flax: str) -> List[Tuple[str, str, str, str]]:
    return [(f"{port}.{t}", "frozen", f"{flax}/{f}", "vector")
            for t, f in _BN_LEAVES]


def _norm(port: str, flax: str,
          batch: bool) -> List[Tuple[str, str, str, str]]:
    """A mobile trunk's norm: frozen (:func:`_bn`) or, with ``batch``,
    trainable, whose step count has no flax tensor (kind "count")."""
    if not batch:
        return _bn(port, flax)
    return [(f"{port}.weight", "params", f"{flax}/weight", "vector"),
            (f"{port}.bias", "params", f"{flax}/bias", "vector"),
            (f"{port}.running_mean", "frozen", f"{flax}/mean", "vector"),
            (f"{port}.running_var", "frozen", f"{flax}/var", "vector"),
            (f"{port}.num_batches_tracked", None, None, "count")]


def _conv_norm(port: str, conv: str, norm: str,
               batch: bool) -> List[Tuple[str, str, str, str]]:
    """A ``Conv2dNormActivation``: the convolution at ``port.0``, its norm
    at ``port.1``."""
    return (_layer(f"{port}.0", conv, "conv", bias=False)
            + _norm(f"{port}.1", norm, batch))


def _mobilenet_v2(prefix: str, batch: bool) -> List[Tuple[str, str, str, str]]:
    """MobileNetV2's ``features`` at ``prefix`` (the port's ``backbone``,
    torchvision's ``features``)."""
    m = _conv_norm(f"{prefix}.0", "backbone/stem", "backbone/bn_stem", batch)
    idx = 0
    for t, _c, n, _s in V2_SETTINGS:
        for _ in range(n):
            idx += 1
            tv, op = f"{prefix}.{idx}.conv", f"backbone/block{idx}"
            j = 0
            if t != 1:
                m += _conv_norm(f"{tv}.0", f"{op}/expand", f"{op}/bn_expand",
                                batch)
                j = 1
            m += _conv_norm(f"{tv}.{j}", f"{op}/dw", f"{op}/bn_dw", batch)
            m += _layer(f"{tv}.{j + 1}", f"{op}/project", "conv", bias=False)
            m += _norm(f"{tv}.{j + 2}", f"{op}/bn_project", batch)
    return m + _conv_norm(f"{prefix}.18", "backbone/head", "backbone/bn_head",
                          batch)


def _v3_block(tv: str, op: str, has_expand: bool, se: bool,
              batch: bool) -> List[Tuple[str, str, str, str]]:
    """An inverted residual's ``block.{j}`` at ``tv``: expansion (where the
    widths differ), depthwise, squeeze-excitation, projection."""
    m, j = [], 0
    if has_expand:
        m += _conv_norm(f"{tv}.0", f"{op}/expand", f"{op}/bn_expand", batch)
        j = 1
    return m + _v3_tail(tv, op, j, se, batch)


def _v3_tail(tv: str, op: str, j: int, se: bool,
             batch: bool) -> List[Tuple[str, str, str, str]]:
    """A block's depthwise conv at ``tv.{j}``, then its squeeze-excitation
    and projection."""
    m = _conv_norm(f"{tv}.{j}", f"{op}/dw", f"{op}/bn_dw", batch)
    if se:
        j += 1
        m += _layer(f"{tv}.{j}.fc1", f"{op}/se_fc1", "conv")
        m += _layer(f"{tv}.{j}.fc2", f"{op}/se_fc2", "conv")
    return m + _conv_norm(f"{tv}.{j + 1}", f"{op}/project",
                          f"{op}/bn_project", batch)


def _mobilenet_v3(batch: bool) -> List[Tuple[str, str, str, str]]:
    """The MobileNetV3-Large body of ``fasterrcnn_mobilenet_v3_large_fpn``
    and its two-level FPN."""
    body = "backbone.body"
    m = _conv_norm(f"{body}.0", "backbone/stem", "backbone/bn_stem", batch)
    cin = 16
    for idx, (_k, e, c, se, _a, _s) in enumerate(V3_LARGE_SETTINGS,
                                                 start=1):
        m += _v3_block(f"{body}.{idx}.block", f"backbone/block{idx}",
                       e != cin, se, batch)
        cin = c
    m += _conv_norm(f"{body}.16", "backbone/head", "backbone/bn_head", batch)
    for i in range(2):
        m += _layer(f"backbone.fpn.inner_blocks.{i}", f"fpn/lateral{i}",
                    "conv")
        m += _layer(f"backbone.fpn.layer_blocks.{i}", f"fpn/post{i}", "conv")
    return m


# features.{i} of VGG16's convolutions and their flax names (conv5_x
# only in a plain ImageNet ``vgg16``; SSD holds them in ``extra.0``).
_VGG_CONVS = tuple(zip((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28),
                       ("conv1_1", "conv1_2", "conv2_1", "conv2_2",
                        "conv3_1", "conv3_2", "conv3_3", "conv4_1",
                        "conv4_2", "conv4_3", "conv5_1", "conv5_2",
                        "conv5_3")))


def _ssd_head(separable: bool) -> List[Tuple[str, str, str, str]]:
    """SSD's per-map ``module_list.{k}`` convolutions (SSDLite's: the
    depthwise ``.0`` with its always frozen norm, the 1x1 ``.1``)."""
    m = []
    for k in range(6):
        for tv, ours in (("classification_head", f"cls{k}"),
                         ("regression_head", f"reg{k}")):
            port, op = f"head.{tv}.module_list.{k}", f"head/{ours}"
            if separable:
                m += _conv_norm(f"{port}.0", f"{op}/dw", f"{op}/bn", False)
                m += _layer(f"{port}.1", f"{op}/pw", "conv")
            else:
                m += _layer(port, op, "conv")
    return m


def _ssd_vgg16(prefix: str) -> List[Tuple[str, str, str, str]]:
    """SSD300-VGG16 (``ssd_vgg16_key_map``) or, with ``prefix``
    "features", a plain ImageNet ``vgg16``'s thirteen convolutions."""
    if prefix == "features":
        return [t for i, ours in _VGG_CONVS
                for t in _layer(f"features.{i}", f"backbone/{ours}", "conv")]
    m = [t for i, ours in _VGG_CONVS[:10]
         for t in _layer(f"backbone.features.{i}", f"backbone/{ours}",
                         "conv")]
    m.append(("backbone.scale_weight", "params", "backbone/l2norm_scale",
              "vector"))
    for i, (_, ours) in zip((1, 3, 5), _VGG_CONVS[10:]):
        m += _layer(f"backbone.extra.0.{i}", f"backbone/{ours}", "conv")
    m += _layer("backbone.extra.0.7.1", "backbone/fc6", "conv")
    m += _layer("backbone.extra.0.7.3", "backbone/fc7", "conv")
    for k in range(1, 5):
        for i, sub in ((0, 1), (2, 2)):
            m += _layer(f"backbone.extra.{k}.{i}",
                        f"backbone/extra{k}_{sub}", "conv")
    return m + _ssd_head(False)


def _ssdlite(batch: bool) -> List[Tuple[str, str, str, str]]:
    """SSDLite320-MobileNetV3 (``ssdlite_key_map``): the trunk split at
    block 13's expansion (``backbone.features.0.13``, the rest of the
    block at ``features.1.0``), the extras and the separable heads; with
    ``batch`` the trunk's and the extras' norms are trainable."""
    m = _conv_norm("backbone.features.0.0", "backbone/stem",
                   "backbone/bn_stem", batch)
    cin = 16
    for idx, (_k, e, c, se, _a, _s) in enumerate(V3_LARGE_SETTINGS,
                                                 start=1):
        op = f"backbone/block{idx}"
        if idx < 13:
            m += _v3_block(f"backbone.features.0.{idx}.block", op, e != cin,
                           se, batch)
        elif idx == 13:
            m += _conv_norm("backbone.features.0.13", f"{op}/expand",
                            f"{op}/bn_expand", batch)
            m += _v3_tail("backbone.features.1.0", op, 0, se, batch)
        else:
            m += _v3_block(f"backbone.features.1.{idx - 13}.block", op,
                           e != cin, se, batch)
        cin = c
    m += _conv_norm("backbone.features.1.3", "backbone/head",
                    "backbone/bn_head", batch)
    for k in range(1, 5):
        tv, op = f"backbone.extra.{k - 1}", f"backbone/extra{k}"
        m += _conv_norm(f"{tv}.0", f"{op}_1", f"{op}_bn1", batch)
        m += _conv_norm(f"{tv}.1", f"{op}_dw", f"{op}_bn2", batch)
        m += _conv_norm(f"{tv}.2", f"{op}_2", f"{op}_bn3", batch)
    return m + _ssd_head(True)


def _layer(port: str, flax: str, kind: str,
           bias: bool = True) -> List[Tuple[str, str, str, str]]:
    out = [(f"{port}.weight", "params", f"{flax}/kernel", kind)]
    if bias:
        out.append((f"{port}.bias", "params", f"{flax}/bias", "vector"))
    return out


def _norm_layer(port: str, flax: str,
                norm: bool) -> List[Tuple[str, str, str, str]]:
    """A convolution that, with ``norm``, has no bias and a frozen BatchNorm
    after it (``port.0``, ``port.1``; flax ``flax`` and ``flax_bn``)."""
    if not norm:
        return _layer(port, flax, "conv")
    return (_layer(f"{port}.0", flax, "conv", bias=False)
            + _bn(f"{port}.1", f"{flax}_bn"))


def _group_norm(port: str, flax: str) -> List[Tuple[str, str, str, str]]:
    """A GroupNorm's affine terms: torch ``weight``/``bias``, flax
    ``scale``/``bias``, both trained."""
    return [(f"{port}.weight", "params", f"{flax}/scale", "vector"),
            (f"{port}.bias", "params", f"{flax}/bias", "vector")]


def _one_stage_head(family: str,
                    head_norm: bool) -> List[Tuple[str, str, str, str]]:
    """The RetinaNet (``head_norm``: v2's GroupNorm subnets, convs without
    bias) or FCOS head under torchvision's names."""
    m = []
    for tv, ours in (("classification_head", "cls"),
                     ("regression_head", "box")):
        for i in range(4):
            if family == "fcos":
                conv, norm = f"head.{tv}.conv.{3 * i}", \
                    f"head.{tv}.conv.{3 * i + 1}"
            else:
                conv, norm = f"head.{tv}.conv.{i}.0", f"head.{tv}.conv.{i}.1"
            m += _layer(conv, f"head/{ours}_conv{i}", "conv",
                        bias=family == "fcos" or not head_norm)
            if family == "fcos" or head_norm:
                m += _group_norm(norm, f"head/{ours}_gn{i}")
    m += _layer("head.classification_head.cls_logits", "head/cls_logits",
                "conv")
    m += _layer("head.regression_head.bbox_reg", "head/box_deltas", "conv")
    if family == "fcos":
        m += _layer("head.regression_head.bbox_ctrness", "head/ctrness",
                    "conv")
    return m


def key_map(with_mask: bool = False, with_keypoints: bool = False,
            rpn_conv_depth: int = 1, box_head_type: str = "mlp",
            fpn_norm: bool = False, mask_head_norm: bool = False,
            family: str = "faster_rcnn", retinanet_head_norm: bool = False,
            backbone: str = "resnet50_fpn", batch_norm: bool = False,
            trunk_prefix: str = "backbone"
            ) -> List[Tuple[str, str, str, str]]:
    """``(port key, flax collection, flax path, kind)`` for every tensor of
    the Faster R-CNN ResNet-50-FPN detector with the MLP box head and, with
    ``with_mask``, Mask R-CNN's mask head, with ``with_keypoints`` Keypoint
    R-CNN's keypoint head; the other arguments are the ``ModelConfig``
    fields of the v2 recipe.  ``backbone`` "mobilenet_v2" (its ``features``
    at ``trunk_prefix``) or "mobilenet_v3_fpn": that trunk in place of
    ResNet-50-FPN, its norms trainable with ``batch_norm``.  With
    ``family`` "retinanet" (v2 with ``retinanet_head_norm``) or "fcos": the
    one-stage model, its FPN over C3..C5 (``fpn/lateral3..5``,
    ``post3..5``, ``p6``, ``p7``) and its head.  With ``family`` "ssd":
    SSD300-VGG16 (with ``trunk_prefix`` "features", a plain ImageNet
    ``vgg16``'s convolutions), "ssdlite": SSDLite320-MobileNetV3, its
    trunk's norms trainable with ``batch_norm``."""
    if family == "ssd":
        return _ssd_vgg16(trunk_prefix)
    if family == "ssdlite":
        return _ssdlite(batch_norm)
    if backbone != "resnet50_fpn":
        m = (_mobilenet_v2(trunk_prefix, batch_norm)
             if backbone == "mobilenet_v2" else _mobilenet_v3(batch_norm))
        return m + _two_stage_heads(with_mask, with_keypoints,
                                    rpn_conv_depth, box_head_type,
                                    mask_head_norm)
    m = _layer("backbone.body.conv1", "backbone/conv1", "conv", bias=False)
    m += _bn("backbone.body.bn1", "backbone/bn1")
    for stage, blocks in enumerate(STAGE_SIZES, start=1):
        for b in range(blocks):
            port = f"backbone.body.layer{stage}.{b}"
            flax = f"backbone/layer{stage}_{b}"
            for i in (1, 2, 3):
                m += _layer(f"{port}.conv{i}", f"{flax}/conv{i}", "conv",
                            bias=False)
                m += _bn(f"{port}.bn{i}", f"{flax}/bn{i}")
            if b == 0:
                m += _layer(f"{port}.downsample.0", f"{flax}/conv_down",
                            "conv", bias=False)
                m += _bn(f"{port}.downsample.1", f"{flax}/bn_down")
    if family in ("retinanet", "fcos"):
        for i in range(3):
            m += _layer(f"backbone.fpn.inner_blocks.{i}",
                        f"fpn/lateral{i + 3}", "conv")
            m += _layer(f"backbone.fpn.layer_blocks.{i}", f"fpn/post{i + 3}",
                        "conv")
        for p in ("p6", "p7"):
            m += _layer(f"backbone.fpn.extra_blocks.{p}", f"fpn/{p}", "conv")
        return m + _one_stage_head(family, retinanet_head_norm)
    for i in range(4):
        m += _norm_layer(f"backbone.fpn.inner_blocks.{i}",
                         f"fpn/lateral{i + 2}", fpn_norm)
        m += _norm_layer(f"backbone.fpn.layer_blocks.{i}",
                         f"fpn/post{i + 2}", fpn_norm)
    return m + _two_stage_heads(with_mask, with_keypoints, rpn_conv_depth,
                                box_head_type, mask_head_norm)


def _two_stage_heads(with_mask: bool, with_keypoints: bool,
                     rpn_conv_depth: int, box_head_type: str,
                     mask_head_norm: bool) -> List[Tuple[str, str, str, str]]:
    """The RPN head and the RoI heads, whatever the trunk."""
    m = []
    if rpn_conv_depth == 1:
        m += _layer("rpn.head.conv", "rpn_head/conv", "conv")
    else:
        for d in range(rpn_conv_depth):
            m += _layer(f"rpn.head.conv.{d}.0",
                        "rpn_head/conv" + (str(d + 1) if d else ""), "conv")
    m += _layer("rpn.head.cls_logits", "rpn_head/objectness", "conv")
    m += _layer("rpn.head.bbox_pred", "rpn_head/deltas", "conv")
    if box_head_type == "convfc":
        for i in range(4):
            m += _layer(f"roi_heads.box_head.{i}.0", f"box_head/conv{i + 1}",
                        "conv", bias=False)
            m += _bn(f"roi_heads.box_head.{i}.1", f"box_head/bn{i + 1}")
        m += _layer("roi_heads.box_head.5", "box_head/fc", "fc6")
    else:
        m += _layer("roi_heads.box_head.fc6", "box_head/fc6", "fc6")
        m += _layer("roi_heads.box_head.fc7", "box_head/fc7", "dense")
    m += _layer("roi_heads.box_predictor.cls_score", "box_head/cls", "dense")
    m += _layer("roi_heads.box_predictor.bbox_pred", "box_head/reg", "dense")
    if with_mask:
        for i in range(1, 5):
            if mask_head_norm:
                m += _layer(f"roi_heads.mask_head.{i - 1}.0",
                            f"mask_head/conv{i}", "conv", bias=False)
                m += _bn(f"roi_heads.mask_head.{i - 1}.1", f"mask_head/bn{i}")
            else:
                m += _layer(f"roi_heads.mask_head.mask_fcn{i}",
                            f"mask_head/conv{i}", "conv")
        m += _layer("roi_heads.mask_predictor.conv5_mask", "mask_head/deconv",
                    "deconv")
        m += _layer("roi_heads.mask_predictor.mask_fcn_logits",
                    "mask_head/logits", "conv")
    if with_keypoints:
        for i in range(8):
            m += _layer(f"roi_heads.keypoint_head.{2 * i}",
                        f"keypoint_head/conv{i + 1}", "conv")
        m += _layer("roi_heads.keypoint_predictor.kps_score_lowres",
                    "keypoint_head/deconv", "deconv")
    return m


def _get(tree: Dict, path: str):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return np.asarray(node)


def _set(tree: Dict, path: str, value: np.ndarray) -> None:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _to_torch(kind: str, v: np.ndarray, pool_size: int) -> np.ndarray:
    if kind == "conv":    # HWIO -> OIHW
        return np.ascontiguousarray(np.transpose(v, (3, 2, 0, 1)))
    if kind == "deconv":  # flipped HWIO -> [in, out, kH, kW]
        return np.ascontiguousarray(np.transpose(v[::-1, ::-1], (2, 3, 0, 1)))
    if kind == "dense":   # [in, out] -> [out, in]
        return np.ascontiguousarray(v.T)
    if kind == "fc6":     # [(H, W, C), out] -> [out, (C, H, W)]
        c = v.shape[0] // (pool_size * pool_size)
        w = v.reshape(pool_size, pool_size, c, v.shape[1])
        return np.ascontiguousarray(
            np.transpose(w, (3, 2, 0, 1)).reshape(v.shape[1], -1))
    return np.ascontiguousarray(v)


def _to_flax(kind: str, v: np.ndarray, pool_size: int) -> np.ndarray:
    if kind == "conv":    # OIHW -> HWIO
        return np.ascontiguousarray(np.transpose(v, (2, 3, 1, 0)))
    if kind == "deconv":  # [in, out, kH, kW] -> flipped HWIO
        return np.ascontiguousarray(np.transpose(v, (2, 3, 0, 1))[::-1, ::-1])
    if kind == "dense":
        return np.ascontiguousarray(v.T)
    if kind == "fc6":     # [out, (C, H, W)] -> [(H, W, C), out]
        c = v.shape[1] // (pool_size * pool_size)
        w = v.reshape(v.shape[0], c, pool_size, pool_size)
        return np.ascontiguousarray(
            np.transpose(w, (2, 3, 1, 0)).reshape(-1, v.shape[0]))
    return np.ascontiguousarray(v)


def _flax_layout(params: Dict, frozen: Dict) -> Dict:
    """``key_map``'s arguments for the model whose flax trees these are."""
    trunk = params.get("backbone", {})
    if "l2norm_scale" in trunk:
        return dict(family="ssd")
    if "extra1_dw" in trunk:
        return dict(family="ssdlite", batch_norm="bn_stem" in trunk)
    if "head" in params:
        return dict(family="fcos" if "ctrness" in params["head"]
                    else "retinanet",
                    retinanet_head_norm="cls_gn0" in params["head"])
    rpn = params.get("rpn_head", {})
    return dict(backbone="mobilenet_v2" if "block17" in trunk
                else "mobilenet_v3_fpn" if "block15" in trunk
                else "resnet50_fpn",
                batch_norm="bn_stem" in trunk,
                with_mask="mask_head" in params,
                with_keypoints="keypoint_head" in params,
                rpn_conv_depth=1 + sum(re.fullmatch(r"conv\d+", k) is not None
                                       for k in rpn),
                box_head_type="convfc" if "fc" in params.get("box_head", {})
                else "mlp",
                fpn_norm="lateral2_bn" in frozen.get("fpn", {}),
                mask_head_norm="bn1" in frozen.get("mask_head", {}))


def _mobile_layout(state_dict: Dict) -> Dict:
    """``key_map``'s trunk arguments of a state dict: the port's
    MobileNetV2 (``backbone.0``), torchvision's ImageNet one (``features.0``),
    the MobileNetV3 FPN body (``backbone.body.0``) or ResNet-50-FPN."""
    for prefix, backbone, trunk in (
            ("backbone.0", "mobilenet_v2", "backbone"),
            ("features.0", "mobilenet_v2", "features"),
            ("backbone.body.0", "mobilenet_v3_fpn", "backbone")):
        if f"{prefix}.0.weight" in state_dict:
            return dict(backbone=backbone, trunk_prefix=trunk, batch_norm=(
                f"{prefix}.1.num_batches_tracked" in state_dict))
    return dict(backbone="resnet50_fpn")


def _state_dict_layout(state_dict: Dict) -> Dict:
    """``key_map``'s arguments for the model whose state dict this is."""
    if "backbone.scale_weight" in state_dict:
        return dict(family="ssd")
    if "backbone.features.0.0.0.weight" in state_dict:
        return dict(family="ssdlite", batch_norm=(
            "backbone.features.0.0.1.num_batches_tracked" in state_dict))
    if "features.0.weight" in state_dict:
        return dict(family="ssd", trunk_prefix="features")
    if "head.classification_head.cls_logits.weight" in state_dict:
        fcos = "head.regression_head.bbox_ctrness.weight" in state_dict
        return dict(family="fcos" if fcos else "retinanet",
                    retinanet_head_norm=not fcos and (
                        "head.classification_head.conv.0.1.weight"
                        in state_dict))
    depth = 1
    while f"rpn.head.conv.{depth}.0.weight" in state_dict:
        depth += 1
    return dict(
        **_mobile_layout(state_dict),
        with_mask="roi_heads.mask_predictor.conv5_mask.weight" in state_dict,
        with_keypoints=("roi_heads.keypoint_predictor.kps_score_lowres."
                        "weight" in state_dict),
        rpn_conv_depth=depth,
        box_head_type="convfc" if "roi_heads.box_head.5.weight" in state_dict
        else "mlp",
        fpn_norm="backbone.fpn.inner_blocks.0.1.weight" in state_dict,
        mask_head_norm="roi_heads.mask_head.0.1.weight" in state_dict)


def state_dict_from_flax(params: Dict, frozen: Dict,
                         pool_size: int = 7) -> Dict[str, np.ndarray]:
    """The port's state dict (numpy arrays) from flax ``params``/``frozen``
    trees (with the mask or keypoint head when ``params`` has one, and the
    v2 recipe's layers where the trees have them); raises ``KeyError``
    naming a missing tree entry."""
    trees = {"params": params, "frozen": frozen}
    sd = {}
    for key, coll, path, kind in key_map(**_flax_layout(params, frozen)):
        if kind == "count":
            sd[key] = np.zeros((), np.int64)
            continue
        try:
            value = _get(trees[coll], path)
        except KeyError:
            raise KeyError(f"{coll}/{path} (for {key}) is not in the "
                           "checkpoint") from None
        sd[key] = _to_torch(kind, value, pool_size)
    return sd


def flax_from_state_dict(state_dict: Dict,
                         pool_size: int = 7) -> Tuple[Dict, Dict]:
    """``(params, frozen)`` flax trees of numpy arrays from the port's state
    dict (tensors or arrays), with the mask or keypoint head when it has
    one, and the v2 recipe's layers where it has them."""
    trees: Dict[str, Dict] = {"params": {}, "frozen": {}}
    for key, coll, path, kind in key_map(**_state_dict_layout(state_dict)):
        if kind == "count":
            continue
        value = state_dict[key]
        if hasattr(value, "detach"):
            value = value.detach().cpu().numpy()
        _set(trees[coll], path, _to_flax(kind, np.asarray(value), pool_size))
    return trees["params"], trees["frozen"]


def _flatten(tree: Dict, prefix: Tuple[str, ...] = ()) -> Dict[Tuple, object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: Dict[Tuple, object]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


# torchvision's two spellings of one tensor: newer releases nest the FPN's,
# the RPN tower's, the mask tower's and RetinaNet's subnets' convolutions in
# a ``Conv2dNormActivation`` (``.0``); the v2 recipe's layers are always
# nested, the port's v1 two-stage layers never.
_ALIASES = (
    (r"(backbone\.fpn\.(?:inner|layer)_blocks\.\d+)\.0\.(weight|bias)",
     r"\1.\2"),
    (r"(backbone\.fpn\.(?:inner|layer)_blocks\.\d+)\.(weight|bias)",
     r"\1.0.\2"),
    (r"rpn\.head\.conv\.0\.0\.(weight|bias)", r"rpn.head.conv.\1"),
    (r"rpn\.head\.conv\.(weight|bias)", r"rpn.head.conv.0.0.\1"),
    (r"roi_heads\.mask_head\.(\d)\.0\.(weight|bias)",
     lambda m: f"roi_heads.mask_head.mask_fcn{int(m[1]) + 1}.{m[2]}"),
    (r"roi_heads\.mask_head\.mask_fcn(\d)\.(weight|bias)",
     lambda m: f"roi_heads.mask_head.{int(m[1]) - 1}.0.{m[2]}"),
    # RetinaNet v1's subnets before torchvision 0.13: a plain Sequential of
    # conv, ReLU pairs.
    (r"(head\.(?:classification|regression)_head\.conv)\.(\d*[02468])\."
     r"(weight|bias)", lambda m: f"{m[1]}.{int(m[2]) // 2}.0.{m[3]}"),
)


def _torchvision_alias(key: str, own: Dict) -> str:
    """``key`` if the model ``own`` (its state dict) has it, else the other
    torchvision spelling of the same tensor where the model has that: a v1
    model reads a v2 or newer checkpoint's nested convolutions, a v2 model
    a v1 checkpoint's, as the JAX package's key maps read them."""
    if key in own:
        return key
    for pattern, repl in _ALIASES:
        alias = re.sub(f"^{pattern}$", repl, key)
        if alias != key and alias in own:
            return alias
    return key


def _load_torchvision_by_path(model, state_dict: Dict, skip) -> int:
    """Copy ``state_dict``'s tensors into ``model`` through the flax paths
    they stand for, where the shapes agree; ``skip(key, shape, model's
    shape)`` for the others.  Returns the number copied.  The paths are
    ``key_map``'s for the checkpoint's own layout, as the JAX package picks
    its key map by the checkpoint's keys, with either torchvision spelling
    of a tensor (``_torchvision_alias``); on the model's side, its own.
    Beyond the JAX package, the reference's MobileNetV2 Faster R-CNN state
    dict (``backbone.{i}``) reads whole."""
    import torch

    own = model.state_dict()
    by_path = {(coll, path): k for k, coll, path, _ in
               key_map(**_state_dict_layout(own)) if coll is not None}
    # A checkpoint's norms read as torchvision's frozen ones, as the JAX
    # package's key maps read them: their affine terms do not reach a
    # trainable norm's parameters.
    layout = dict(_state_dict_layout(state_dict), batch_norm=False)
    paths = {k: (coll, path) for k, coll, path, _ in key_map(**layout)}
    copied = 0
    with torch.no_grad():
        for k, v in state_dict.items():
            target = paths.get(_torchvision_alias(k, paths))
            port = by_path.get(target)
            if port is not None and tuple(own[port].shape) == tuple(v.shape):
                own[port].copy_(v)
                copied += 1
            else:
                skip(k, tuple(v.shape),
                     tuple(own[port].shape) if port is not None else None)
    return copied


def load_pretrained(model, path: str, verbose: bool = True):
    """Load pretrained weights into ``model`` (in place); returns it.

    Counterpart of ``podtpu/models/weights.py::load_pretrained``.  ``path``
    is a model directory (or its ``model.msgpack``), merged leaf by leaf in
    the flax layout as the JAX package merges it: a leaf whose shape
    differs from the model's (the class-sized heads of a model trained on
    another label set) keeps the model's value, with a printed line.  Or
    ``path`` is a ``.pth``/``.pt`` state dict in torchvision's names and
    layouts (optionally under a ``"state_dict"`` key), loaded with the same
    shape rule: a Mask R-CNN checkpoint's class-sized ``mask_fcn_logits``
    loads only when the class count matches, as the box predictor's, and a
    Keypoint R-CNN checkpoint's ``kps_score_lowres`` only when the
    keypoint count does.  Each tensor goes through the flax path it stands
    for (:func:`_load_torchvision_by_path`), so a checkpoint of any family
    reads into a model of any family as the JAX package reads it: RetinaNet
    v1's ``conv.{2i}`` or ``conv.{i}.0``, v2's GroupNorm at ``conv.{i}.1``,
    FCOS's ``conv.{3i}`` and ``conv.{3i+1}``; a mis-sized ``cls_logits`` is
    skipped.  A torchvision ImageNet ``mobilenet_v2`` (``features.*``) fills
    a MobileNetV2 model's trunk, a ``fasterrcnn_mobilenet_v3_large_fpn``
    (``backbone.body.*``) a MobileNetV3 FPN model, an ``ssd300_vgg16``
    or ``ssdlite320_mobilenet_v3_large`` its own family's model and a plain
    ImageNet ``vgg16`` (``features.*``) SSD300's trunk; a checkpoint's
    norms read as frozen ones, so their affine terms do not reach a
    trainable norm's parameters, as in the JAX package.
    """
    import os

    import torch

    from podtpu_torch.shared import msgpack

    pool = model.cfg.roi_pool_size
    if os.path.isdir(path):
        path = os.path.join(path, "model.msgpack")
    copied = skipped = 0

    def skip(name, new_shape, old_shape):
        nonlocal skipped
        skipped += 1
        if verbose:
            print(f"[pretrained] skipping {name} (shape {new_shape} vs "
                  f"{old_shape})")

    if path.endswith(".msgpack"):
        with open(path, "rb") as fp:
            restored = msgpack.unpackb(fp.read())
        params, frozen = flax_from_state_dict(model.state_dict(), pool)
        flat = _flatten({"params": params, "frozen": frozen})
        for k, v in _flatten(restored).items():
            if k in flat and np.shape(flat[k]) == np.shape(v):
                flat[k] = np.asarray(v)
                copied += 1
            else:
                skip("/".join(map(str, k)), np.shape(v),
                     np.shape(flat.get(k, None)))
        merged = _unflatten(flat)
        sd = state_dict_from_flax(merged["params"], merged["frozen"], pool)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in sd.items()})
    else:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        state_dict = payload.get("state_dict", payload)
        if verbose:
            # As the JAX package recognises the layouts: a v2 Faster R-CNN
            # by its 2-deep RPN tower, a RetinaNet v2 by its GroupNorms.
            layout = _state_dict_layout(state_dict)
            if layout.get("trunk_prefix") == "features" \
                    and layout.get("family") == "ssd":
                name = "vgg16"
            elif layout.get("family"):
                name = layout["family"] + (
                    "_v2" if layout.get("retinanet_head_norm") else "")
            elif layout["backbone"] != "resnet50_fpn":
                name = layout["backbone"]
            else:
                name = "v2" if "rpn.head.conv.1.0.weight" in state_dict \
                    else "v1"
            print(f"[pretrained] torchvision {name} layout")
        copied = _load_torchvision_by_path(model, state_dict, skip)
    if verbose:
        print(f"[pretrained] {copied} tensors loaded, {skipped} skipped "
              f"from {path}")
    return model


# -- the crop classifier ------------------------------------------------------

def classifier_key_map(stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)
                       ) -> List[Tuple[str, str, str]]:
    """``(port key, flax path, kind)`` for every tensor of the crop
    classifier (``models/classifier.py``): the names are flax's in both, a
    block projects (``proj``, ``gn_proj``) where its stage starts after the
    first."""
    def gn(name):
        return [(f"{name}.weight", f"{name.replace('.', '/')}/scale",
                 "vector"),
                (f"{name}.bias", f"{name.replace('.', '/')}/bias", "vector")]

    m = [("stem.weight", "stem/kernel", "conv")] + gn("gn_stem")
    for s, blocks in enumerate(stage_sizes):
        for b in range(blocks):
            block = f"stage{s + 1}_{b}"
            convs = ("conv1", "conv2") + (("proj",) if s and not b else ())
            for conv in convs:
                m.append((f"{block}.{conv}.weight", f"{block}/{conv}/kernel",
                          "conv"))
                norm = {"conv1": "gn1", "conv2": "gn2",
                        "proj": "gn_proj"}[conv]
                m += gn(f"{block}.{norm}")
    m += [("head.weight", "head/kernel", "dense"),
          ("head.bias", "head/bias", "vector")]
    return m


def _stage_sizes(names) -> Tuple[int, ...]:
    """Blocks per stage from the ``stage{s}_{b}`` names among ``names``."""
    blocks: Dict[int, int] = {}
    for name in names:
        hit = re.match(r"stage(\d+)_(\d+)", name)
        if hit:
            s, b = int(hit[1]), int(hit[2])
            blocks[s] = max(blocks.get(s, 0), b + 1)
    return tuple(blocks[s] for s in sorted(blocks))


def classifier_state_dict_from_flax(params: Dict) -> Dict[str, np.ndarray]:
    """The crop classifier's state dict (numpy arrays) from its flax
    ``params`` tree; raises ``KeyError`` naming a tree entry that is
    missing, or one that no tensor of the model reads."""
    key_map = classifier_key_map(_stage_sizes(params))
    sd = {}
    for key, path, kind in key_map:
        try:
            value = _get(params, path)
        except KeyError:
            raise KeyError(f"params/{path} (for {key}) is not in the "
                           "checkpoint") from None
        sd[key] = _to_torch(kind, value, 0)
    extra = set("/".join(k) for k in _flatten(params)) - {p for _, p, _ in
                                                         key_map}
    if extra:
        raise KeyError(f"params/{sorted(extra)[0]} is not a tensor of the "
                       "crop classifier")
    return sd


def classifier_flax_from_state_dict(state_dict: Dict) -> Dict:
    """The crop classifier's flax ``params`` tree of numpy arrays from the
    port's state dict (tensors or arrays): the inverse of
    :func:`classifier_state_dict_from_flax`."""
    tree: Dict = {}
    stage_sizes = _stage_sizes(k.split(".")[0] for k in state_dict)
    for key, path, kind in classifier_key_map(stage_sizes):
        value = state_dict[key]
        if hasattr(value, "detach"):
            value = value.detach().cpu().numpy()
        _set(tree, path, _to_flax(kind, np.asarray(value), 0))
    return tree
