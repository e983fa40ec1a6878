"""MobileNetV3-Large trunk with the two FPN taps of torchvision's
``fasterrcnn_mobilenet_v3_large_fpn``.

Counterpart of ``podtpu/models/mobilenet_v3.py`` (``_make_divisible``,
``V3_LARGE_SETTINGS``, ``InvertedResidualV3``, ``MobileNetV3FPN``; torch's
``hardswish`` and ``hardsigmoid`` compute JAX's ``x * clip(x + 3, 0, 6) /
6`` and ``clip(x + 3, 0, 6) / 6`` in that order).  Modules are those of
torchvision's ``features`` Sequential under the extractor's
``backbone.body``: ``0`` the stem, ``{i}.block.{j}`` the inverted residuals
(expand, depthwise, squeeze-excitation ``fc1``/``fc2``, project), ``16`` the
last 1x1 conv.  The taps are ``features[13]``'s output (160 channels) and
the last conv's (960), both at stride 32.  The squeeze-excitation branch
computes in float32 (the mean, ``fc1`` and ``fc2`` with their biases); its
gate multiplies the trunk in the trunk's dtype.

``trainable_stages`` freeze units end after blocks 1, 3, 6 and 12 and after
the head conv; the taps are detached only when all five are frozen.
Frozen units keep their parameters in the optimiser, as in
``models/mobilenet.py``.

:class:`MobileNetV3SSDLite` is the extractor of torchvision's
``ssdlite320_mobilenet_v3_large`` (``MobileNetV3SSDLite`` of the JAX
package): the same trunk split at block 13's expansion, whose output is
the first of six maps (``features.0``: the stem, blocks 1-12 and that
expansion; ``features.1``: block 13's depthwise, squeeze-excitation and
projection as ``.0``, blocks 14 and 15, the head conv), then four extra
blocks (``extra.{k}``: a 1x1 reduction to half the width, a 3x3 stride-2
depthwise conv and a 1x1 conv, each normed and under ReLU6).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from podtpu_torch.models.mobilenet import ConvNormAct
from podtpu_torch.models.resnet import Conv2d


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# (kernel, expanded, out, squeeze-excitation, activation, stride):
# torchvision's mobilenet_v3_large setting at width 1.0.  Input widths are
# the previous row's outputs (16 after the stem).
V3_LARGE_SETTINGS: Tuple[Tuple[int, int, int, bool, str, int], ...] = (
    (3, 16, 16, False, "RE", 1),
    (3, 64, 24, False, "RE", 2),
    (3, 72, 24, False, "RE", 1),
    (5, 72, 40, True, "RE", 2),
    (5, 120, 40, True, "RE", 1),
    (5, 120, 40, True, "RE", 1),
    (3, 240, 80, False, "HS", 2),
    (3, 200, 80, False, "HS", 1),
    (3, 184, 80, False, "HS", 1),
    (3, 184, 80, False, "HS", 1),
    (3, 480, 112, True, "HS", 1),
    (3, 672, 112, True, "HS", 1),
    (5, 672, 160, True, "HS", 2),
    (5, 960, 160, True, "HS", 1),
    (5, 960, 160, True, "HS", 1),
)
C4_BLOCK = 13  # 1-based: the block whose output is the first tap
HEAD_CHANNELS = 960
FPN_IN_CHANNELS = (160, HEAD_CHANNELS)
V3_BOUNDARIES = {1: 0, 3: 1, 6: 2, 12: 3}
ACTIVATIONS = {"RE": nn.ReLU, "HS": nn.Hardswish}


class SqueezeExcitation(nn.Module):
    """Float32 mean over space, ``fc1`` + ReLU, ``fc2`` + hard sigmoid; the
    gate multiplies the input in its own dtype (torchvision's names)."""

    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.fc1 = Conv2d(channels, squeeze, 1)
        self.fc2 = Conv2d(squeeze, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean((2, 3), keepdim=True)
        s = F.hardsigmoid(self.fc2(F.relu(self.fc1(s))))
        return x * s.to(x.dtype)


class InvertedResidualV3(nn.Module):
    """1x1 expand (where the widths differ), kxk depthwise, optional
    squeeze-excitation, 1x1 project; the input added back at stride 1 when
    the widths agree.  ``split_expand`` also returns the expansion's output
    (the SSDLite extractor's tap)."""

    def __init__(self, cin: int, kernel: int, expanded: int, cout: int,
                 use_se: bool, act: str, stride: int, batch_norm: bool,
                 compute_dtype: torch.dtype, split_expand: bool = False):
        super().__init__()
        kw = dict(act=ACTIVATIONS[act], batch_norm=batch_norm,
                  compute_dtype=compute_dtype)
        self.has_expand = expanded != cin
        layers = [ConvNormAct(cin, expanded, 1, **kw)] \
            if self.has_expand else []
        layers.append(ConvNormAct(expanded, expanded, kernel, stride,
                                  expanded, **kw))
        if use_se:
            layers.append(SqueezeExcitation(
                expanded, _make_divisible(expanded // 4, 8)))
        layers.append(ConvNormAct(expanded, cout, 1, act=None,
                                  batch_norm=batch_norm,
                                  compute_dtype=compute_dtype))
        self.block = nn.Sequential(*layers)
        self.use_res = stride == 1 and cin == cout
        self.split_expand = split_expand

    def forward(self, x: torch.Tensor):
        y = x
        layers = list(self.block)
        if self.has_expand:
            y = layers.pop(0)(y)
        expand_out = y
        for layer in layers:
            y = layer(y)
        if self.use_res:
            y = y + x
        return (y, expand_out) if self.split_expand else y


class MobileNetV3Body(nn.Sequential):
    """``features`` of MobileNetV3-Large: ``[B, 3, H, W]`` -> the two
    stride-32 taps ``[[B, 160, H/32, W/32], [B, 960, H/32, W/32]]``."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32,
                 trainable_stages: int = 3, batch_norm: bool = False):
        kw = dict(batch_norm=batch_norm, compute_dtype=compute_dtype)
        layers: List[nn.Module] = [ConvNormAct(3, 16, 3, 2, act=nn.Hardswish,
                                               **kw)]
        cin = 16
        for k, e, c, se, a, s in V3_LARGE_SETTINGS:
            layers.append(InvertedResidualV3(cin, k, e, c, se, a, s, **kw))
            cin = c
        layers.append(ConvNormAct(cin, HEAD_CHANNELS, 1, act=nn.Hardswish,
                                  **kw))
        super().__init__(*layers)
        self.compute_dtype = compute_dtype
        self.freeze_from = 5 - trainable_stages

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = self[0](x.to(self.compute_dtype))
        c13 = None
        for idx in range(1, len(self) - 1):
            h = self[idx](h)
            if idx == C4_BLOCK:
                c13 = h
            if V3_BOUNDARIES.get(idx, 99) < self.freeze_from:
                h = h.detach()
        h = self[-1](h)
        if 4 < self.freeze_from:
            h, c13 = h.detach(), c13.detach()
        return [c13, h]


# Output widths of the SSDLite extras.
SSDLITE_EXTRAS = (512, 256, 256, 128)
SSDLITE_OUT_CHANNELS = (672, HEAD_CHANNELS) + SSDLITE_EXTRAS


class MobileNetV3SSDLite(nn.Module):
    """``[B, 3, H, W]`` -> the six maps of SSDLite's heads: block 13's
    expansion (672 channels, stride 16), the head conv (960, stride 32) and
    the four extras.  Freeze units as :class:`MobileNetV3Body`'s; the
    extras always train, and their norms are the trunk's."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32,
                 trainable_stages: int = 3, batch_norm: bool = False):
        super().__init__()
        kw = dict(batch_norm=batch_norm, compute_dtype=compute_dtype)
        part0: List[nn.Module] = [ConvNormAct(3, 16, 3, 2, act=nn.Hardswish,
                                              **kw)]
        part1: List[nn.Module] = []
        cin = 16
        for idx, (k, e, c, se, a, s) in enumerate(V3_LARGE_SETTINGS,
                                                  start=1):
            block = InvertedResidualV3(cin, k, e, c, se, a, s,
                                       split_expand=idx == C4_BLOCK, **kw)
            if idx == C4_BLOCK:
                # torchvision's split: the expansion ends part 0, the rest
                # of the block (no residual at stride 2) opens part 1.
                layers = list(block.block)
                part0.append(layers[0])
                part1.append(nn.Sequential(*layers[1:]))
            elif idx < C4_BLOCK:
                part0.append(block)
            else:
                part1.append(block)
            cin = c
        part1.append(ConvNormAct(cin, HEAD_CHANNELS, 1, act=nn.Hardswish,
                                 **kw))
        self.features = nn.ModuleList([nn.Sequential(*part0),
                                       nn.Sequential(*part1)])
        extra = []
        cin = HEAD_CHANNELS
        for out in SSDLITE_EXTRAS:
            mid = out // 2
            extra.append(nn.Sequential(
                ConvNormAct(cin, mid, 1, **kw),
                ConvNormAct(mid, mid, 3, 2, mid, **kw),
                ConvNormAct(mid, out, 1, **kw)))
            cin = out
        self.extra = nn.ModuleList(extra)
        self.compute_dtype = compute_dtype
        self.freeze_from = 5 - trainable_stages

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        part0, part1 = self.features
        h = x.to(self.compute_dtype)
        for idx, layer in enumerate(part0):
            h = layer(h)
            if V3_BOUNDARIES.get(idx, 99) < self.freeze_from:
                h = h.detach()
        c4 = h
        h = part1(h)
        if 4 < self.freeze_from:
            h, c4 = h.detach(), c4.detach()
        outs = [c4, h]
        for block in self.extra:
            outs.append(block(outs[-1]))
        return outs
