"""Feature Pyramid Network over C2..C5, plus the max-pooled P6.

Counterpart of ``podtpu/models/fpn.py`` (``extra="pool"``): 1x1 laterals,
nearest 2x top-down sums, 3x3 output convs, and P6 = a stride-2 kernel-1 max
pool of P5, which is plain subsampling.  Module names follow torchvision's
``FeaturePyramidNetwork`` (``inner_blocks.i``, ``layer_blocks.i``).  With
``norm`` (the v2 recipe, JAX's ``FPN(norm=True)``) each convolution has no
bias and a frozen BatchNorm follows it, under torchvision v2's names
``inner_blocks.i.0`` (the convolution) and ``inner_blocks.i.1`` (the norm).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from podtpu_torch.models.resnet import Conv2d, FrozenBatchNorm2d


def conv_block(cin: int, cout: int, k: int, norm: bool,
               compute_dtype: torch.dtype) -> nn.Module:
    """A ``k``x``k`` same-padded convolution; with ``norm`` one without bias
    followed by a frozen BatchNorm (torchvision's ``Conv2dNormActivation``
    without an activation: ``.0`` and ``.1``)."""
    conv = Conv2d(cin, cout, k, padding=k // 2, bias=not norm,
                  compute_dtype=compute_dtype)
    return nn.Sequential(conv, FrozenBatchNorm2d(cout)) if norm else conv


class FeaturePyramidNetwork(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 compute_dtype: torch.dtype = torch.float32,
                 norm: bool = False):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            conv_block(c, out_channels, 1, norm, compute_dtype)
            for c in in_channels)
        self.layer_blocks = nn.ModuleList(
            conv_block(out_channels, out_channels, 3, norm, compute_dtype)
            for _ in in_channels)

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [blk(c) for blk, c in zip(self.inner_blocks, inputs)]
        tops = [laterals[-1]]
        for lat in laterals[-2::-1]:
            up = tops[-1]
            if up.shape[-2:] != lat.shape[-2:]:
                up = F.interpolate(up, scale_factor=2.0, mode="nearest")
                up = up[..., :lat.shape[-2], :lat.shape[-1]]
            tops.append(lat + up)
        outs = [blk(t) for blk, t in zip(self.layer_blocks, tops[::-1])]
        return outs + [outs[-1][..., ::2, ::2]]


class BackboneWithFPN(nn.Module):
    """``body`` (ResNet C2..C5) followed by ``fpn`` -> P2..P6."""

    def __init__(self, body: nn.Module, fpn: FeaturePyramidNetwork):
        super().__init__()
        self.body = body
        self.fpn = fpn

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.fpn(self.body(x))
