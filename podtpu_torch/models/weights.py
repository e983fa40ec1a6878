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
* frozen BatchNorm ``weight/bias/mean/var`` <-> the buffers
  ``weight/bias/running_mean/running_var``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

STAGE_SIZES = (3, 4, 6, 3)
_BN_LEAVES = (("weight", "weight"), ("bias", "bias"),
              ("running_mean", "mean"), ("running_var", "var"))


def _bn(port: str, flax: str) -> List[Tuple[str, str, str, str]]:
    return [(f"{port}.{t}", "frozen", f"{flax}/{f}", "vector")
            for t, f in _BN_LEAVES]


def _layer(port: str, flax: str, kind: str,
           bias: bool = True) -> List[Tuple[str, str, str, str]]:
    out = [(f"{port}.weight", "params", f"{flax}/kernel", kind)]
    if bias:
        out.append((f"{port}.bias", "params", f"{flax}/bias", "vector"))
    return out


def key_map() -> List[Tuple[str, str, str, str]]:
    """``(port key, flax collection, flax path, kind)`` for every tensor of
    the Faster R-CNN ResNet-50-FPN detector with the MLP box head."""
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
    for i in range(4):
        m += _layer(f"backbone.fpn.inner_blocks.{i}", f"fpn/lateral{i + 2}",
                    "conv")
        m += _layer(f"backbone.fpn.layer_blocks.{i}", f"fpn/post{i + 2}",
                    "conv")
    m += _layer("rpn.head.conv", "rpn_head/conv", "conv")
    m += _layer("rpn.head.cls_logits", "rpn_head/objectness", "conv")
    m += _layer("rpn.head.bbox_pred", "rpn_head/deltas", "conv")
    m += _layer("roi_heads.box_head.fc6", "box_head/fc6", "fc6")
    m += _layer("roi_heads.box_head.fc7", "box_head/fc7", "dense")
    m += _layer("roi_heads.box_predictor.cls_score", "box_head/cls", "dense")
    m += _layer("roi_heads.box_predictor.bbox_pred", "box_head/reg", "dense")
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
    if kind == "dense":
        return np.ascontiguousarray(v.T)
    if kind == "fc6":     # [out, (C, H, W)] -> [(H, W, C), out]
        c = v.shape[1] // (pool_size * pool_size)
        w = v.reshape(v.shape[0], c, pool_size, pool_size)
        return np.ascontiguousarray(
            np.transpose(w, (2, 3, 1, 0)).reshape(-1, v.shape[0]))
    return np.ascontiguousarray(v)


def state_dict_from_flax(params: Dict, frozen: Dict,
                         pool_size: int = 7) -> Dict[str, np.ndarray]:
    """The port's state dict (numpy arrays) from flax ``params``/``frozen``
    trees; raises ``KeyError`` naming a missing tree entry."""
    trees = {"params": params, "frozen": frozen}
    sd = {}
    for key, coll, path, kind in key_map():
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
    dict (tensors or arrays)."""
    trees: Dict[str, Dict] = {"params": {}, "frozen": {}}
    for key, coll, path, kind in key_map():
        value = state_dict[key]
        if hasattr(value, "detach"):
            value = value.detach().cpu().numpy()
        _set(trees[coll], path, _to_flax(kind, np.asarray(value), pool_size))
    return trees["params"], trees["frozen"]
