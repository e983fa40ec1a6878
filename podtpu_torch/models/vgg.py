"""VGG16 with SSD's extra blocks: the feature extractor of ``ssd300_vgg16``.

Counterpart of ``podtpu/models/vgg.py`` (``VGG16SSD``), in the module layout
of torchvision's ``SSDFeatureExtractorVGG``, so that its state dict maps one
to one: ``features.{i}`` the VGG16 convolutions through conv4_3 (pools 1
and 2 floor, pool 3 rounds up: 75 -> 38 at 300 px), ``scale_weight`` the
L2Norm's per-channel scale (init 20), ``extra.0`` pool4, conv5_1..3
(``.1``, ``.3``, ``.5``) and ``.7`` pool5 (3x3, stride 1, padding 1) with
the dilated fc6 (``.7.1``, dilation and padding 6) and fc7 (``.7.3``), and
``extra.1..4`` each a 1x1 reduction and a 3x3 convolution (``.0``,
``.2``), stride 2 and padded in the first two, unpadded in the last two.
Every convolution has a bias and a ReLU; there is no norm layer.

The L2Norm computes as the JAX model: ``x * rsqrt(sum(x^2) + 1e-12) *
scale`` in float32 over channels, cast back to the compute dtype.  The max
pools pad with -inf where they round up, as flax's do.  Of the five conv
stages the first ``5 - trainable_stages`` have their outputs detached (the
JAX model's ``stop_gradient``); the extras always train.  Frozen stages keep
their parameters in the optimiser, as under the JAX package's mask (see
``train/optim.py``).  Returns six maps of (512, 1024, 512, 256, 256, 256)
channels.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from podtpu_torch.models.resnet import Conv2d

# VGG16 configuration "D": channels per conv, grouped into the five stages.
STAGES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
          (512, 512, 512))
OUT_CHANNELS = (512, 1024, 512, 256, 256, 256)
# features.{i} of each conv through conv4_3 (ReLUs and pools between).
FEATURE_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)
# (mid, out, stride, padding) of extra.1..4.
EXTRAS = ((256, 512, 2, 1), (128, 256, 2, 1), (128, 256, 1, 0),
          (128, 256, 1, 0))


class _Pool(nn.Module):
    def __init__(self, k: int, stride: int, padding: int = 0,
                 ceil_mode: bool = False):
        super().__init__()
        self.args = (k, stride, padding, 1, ceil_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, *self.args)


class VGG16SSD(nn.Module):
    """``[B, 3, H, W]`` -> the six maps of SSD300's heads."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32,
                 trainable_stages: int = 3):
        super().__init__()
        dt = compute_dtype

        def conv(cin, cout, k=3, **kw):
            return Conv2d(cin, cout, k, padding=kw.pop("padding", k // 2),
                          compute_dtype=dt, **kw)

        layers: List[nn.Module] = []
        cin = 3
        for s, widths in enumerate(STAGES[:4], start=1):
            for w in widths:
                layers += [conv(cin, w), nn.ReLU()]
                cin = w
            if s < 4:
                layers.append(_Pool(2, 2, ceil_mode=s == 3))
        self.features = nn.Sequential(*layers)
        self.scale_weight = nn.Parameter(torch.full((512,), 20.0))
        fc = nn.Sequential(_Pool(3, 1, 1),
                           conv(512, 1024, padding=6, dilation=6), nn.ReLU(),
                           conv(1024, 1024, 1), nn.ReLU())
        extra = [nn.Sequential(_Pool(2, 2), conv(512, 512), nn.ReLU(),
                               conv(512, 512), nn.ReLU(), conv(512, 512),
                               nn.ReLU(), fc)]
        cin = 1024
        for mid, out, stride, pad in EXTRAS:
            extra.append(nn.Sequential(
                conv(cin, mid, 1), nn.ReLU(),
                conv(mid, out, stride=stride, padding=pad), nn.ReLU()))
            cin = out
        self.extra = nn.ModuleList(extra)
        self.compute_dtype = dt
        self.freeze_from = 5 - trainable_stages

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = x.to(self.compute_dtype)
        stage = 1
        for layer in self.features:
            h = layer(h)
            if isinstance(layer, _Pool):
                if stage <= self.freeze_from:
                    h = h.detach()
                stage += 1
        if 4 <= self.freeze_from:
            h = h.detach()
        hf = h.float()
        norm = torch.rsqrt((hf * hf).sum(1, keepdim=True) + 1e-12)
        outs = [(hf * norm * self.scale_weight.view(1, -1, 1, 1)
                 ).to(self.compute_dtype)]
        stage5 = self.extra[0]
        for layer in list(stage5)[:-1]:
            h = layer(h)
        if 5 <= self.freeze_from:
            h = h.detach()
        outs.append(stage5[-1](h))
        for block in self.extra[1:]:
            outs.append(block(outs[-1]))
        return outs
