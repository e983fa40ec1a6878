"""MobileNetV2 trunk, detection flavour.

Counterpart of ``podtpu/models/mobilenet.py``: torchvision's
``mobilenet_v2().features`` (stem 3x3/s2, 17 inverted residuals, 1x1 conv to
1280 channels) returning one stride-32 map, the reference's single-map
Faster R-CNN trunk.  Modules are the ``features`` Sequential's (``0`` the
stem ``Conv2dNormActivation``, ``{i}.conv.{j}`` the blocks, ``18`` the head
conv), so a torchvision state dict maps one to one.  Depthwise convolutions
are grouped :class:`~podtpu_torch.models.resnet.Conv2d` in the compute
dtype.  The norm is frozen or trainable (:class:`BatchNorm2d`) by
``batch_norm``.

``trainable_stages`` counts the trailing freeze units that train, of [stem
and block 1, blocks 2-3, blocks 4-6, blocks 7-13, blocks 14-17 and the head
conv]; a frozen unit's output is detached, as the JAX model's
``stop_gradient``.  Its parameters keep ``requires_grad`` and stay in the
optimiser, where they get zero gradients and weight decay, as under the JAX
package's optimiser mask, whose names are ResNet's
(``train/optim.py``).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from podtpu_torch.models.resnet import Conv2d, norm_layer

# (expand ratio t, out channels c, repeats n, first stride s):
# torchvision's inverted_residual_setting.
V2_SETTINGS: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
OUT_CHANNELS = 1280
# Freeze unit ending after each of these 1-based blocks.
V2_BOUNDARIES = {1: 0, 3: 1, 6: 2, 13: 3}


class ConvNormAct(nn.Sequential):
    """Convolution without bias, norm, activation (torchvision's
    ``Conv2dNormActivation``: ``.0``, ``.1``, ``.2``; no activation module
    when ``act`` is None)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1, act=nn.ReLU6, batch_norm: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        layers = [Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2,
                         groups=groups, bias=False,
                         compute_dtype=compute_dtype),
                  norm_layer(batch_norm)(cout)]
        if act is not None:
            layers.append(act())
        super().__init__(*layers)


class InvertedResidual(nn.Module):
    """1x1 expand (t > 1), 3x3 depthwise (the stride here), 1x1 project;
    the input is added back when the stride is 1 and the widths agree."""

    def __init__(self, cin: int, cout: int, stride: int, expand: int,
                 batch_norm: bool, compute_dtype: torch.dtype):
        super().__init__()
        hidden = cin * expand
        kw = dict(batch_norm=batch_norm, compute_dtype=compute_dtype)
        layers = [ConvNormAct(cin, hidden, 1, **kw)] if expand != 1 else []
        layers += [ConvNormAct(hidden, hidden, 3, stride, hidden, **kw),
                   Conv2d(hidden, cout, 1, bias=False,
                          compute_dtype=compute_dtype),
                   norm_layer(batch_norm)(cout)]
        self.conv = nn.Sequential(*layers)
        self.use_res = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return y + x if self.use_res else y


class MobileNetV2(nn.Sequential):
    """``features`` of MobileNetV2: ``[B, 3, H, W]`` -> ``[[B, 1280, H/32,
    W/32]]``."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32,
                 trainable_stages: int = 3, batch_norm: bool = False):
        kw = dict(batch_norm=batch_norm, compute_dtype=compute_dtype)
        layers: List[nn.Module] = [ConvNormAct(3, 32, 3, 2, **kw)]
        cin = 32
        for t, c, n, s in V2_SETTINGS:
            for i in range(n):
                layers.append(InvertedResidual(cin, c, s if i == 0 else 1, t,
                                               **kw))
                cin = c
        layers.append(ConvNormAct(cin, OUT_CHANNELS, 1, **kw))
        super().__init__(*layers)
        self.compute_dtype = compute_dtype
        self.freeze_from = 5 - trainable_stages

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = self[0](x.to(self.compute_dtype))
        for idx in range(1, len(self) - 1):
            h = self[idx](h)
            if V2_BOUNDARIES.get(idx, 99) < self.freeze_from:
                h = h.detach()
        h = self[-1](h)
        if 4 < self.freeze_from:
            h = h.detach()
        return [h]
