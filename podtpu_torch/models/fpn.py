"""Feature Pyramid Network over C2..C5 plus the max-pooled P6, or over
C3..C5 plus P6 and P7.

Counterpart of ``podtpu/models/fpn.py``: 1x1 laterals, nearest 2x top-down
sums, 3x3 output convs, and then either (``extra="pool"``, the two-stage
models) P6 = a stride-2 kernel-1 max pool of P5, which is plain
subsampling, or (``extra="p6p7"``, the one-stage models over the last three
inputs) P6 = a stride-2 3x3 conv of P5 (of C5 with ``p6_on_c5``, the
RetinaNet v2 wiring) and P7 = a stride-2 3x3 conv of ``relu(P6)``.  Module
names follow torchvision's ``FeaturePyramidNetwork`` (``inner_blocks.i``,
``layer_blocks.i``, ``extra_blocks.p6`` and ``.p7``).  With
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


class LastLevelP6P7(nn.Module):
    """P6 = stride-2 3x3 conv of P5 (or of C5 with ``from_c5``), P7 =
    stride-2 3x3 conv of ``relu(P6)`` (torchvision's ``LastLevelP6P7``)."""

    def __init__(self, in_channels: int, out_channels: int, from_c5: bool,
                 compute_dtype: torch.dtype):
        super().__init__()
        kw = dict(stride=2, padding=1, compute_dtype=compute_dtype)
        self.p6 = Conv2d(in_channels, out_channels, 3, **kw)
        self.p7 = Conv2d(out_channels, out_channels, 3, **kw)
        self.from_c5 = from_c5

    def forward(self, outs: List[torch.Tensor],
                inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        p6 = self.p6(inputs[-1] if self.from_c5 else outs[-1])
        return [p6, self.p7(F.relu(p6))]


class FeaturePyramidNetwork(nn.Module):
    """Over the last ``len(in_channels)`` of its inputs; ``extra`` "pool"
    or "p6p7" (see the module's docstring)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 compute_dtype: torch.dtype = torch.float32,
                 norm: bool = False, extra: str = "pool",
                 p6_on_c5: bool = False):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            conv_block(c, out_channels, 1, norm, compute_dtype)
            for c in in_channels)
        self.layer_blocks = nn.ModuleList(
            conv_block(out_channels, out_channels, 3, norm, compute_dtype)
            for _ in in_channels)
        if extra == "p6p7":
            self.extra_blocks = LastLevelP6P7(
                in_channels[-1] if p6_on_c5 else out_channels, out_channels,
                p6_on_c5, compute_dtype)
        elif extra != "pool":
            raise ValueError(f"extra must be 'pool' or 'p6p7', got {extra!r}")
        else:
            self.extra_blocks = None

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        inputs = inputs[len(inputs) - len(self.inner_blocks):]
        laterals = [blk(c) for blk, c in zip(self.inner_blocks, inputs)]
        tops = [laterals[-1]]
        for lat in laterals[-2::-1]:
            up = tops[-1]
            if up.shape[-2:] != lat.shape[-2:]:
                up = F.interpolate(up, scale_factor=2.0, mode="nearest")
                up = up[..., :lat.shape[-2], :lat.shape[-1]]
            tops.append(lat + up)
        outs = [blk(t) for blk, t in zip(self.layer_blocks, tops[::-1])]
        if self.extra_blocks is not None:
            return outs + self.extra_blocks(outs, inputs)
        return outs + [outs[-1][..., ::2, ::2]]


class PyramidDetector(nn.Module):
    """Base of the port's detectors: ``cfg`` and ``backbone`` (a
    :class:`BackboneWithFPN`, or MobileNetV2's trunk, which gives its one
    map itself), whose :meth:`features` takes ``[B, H, W,
    3]`` images (uint8, or float in [0, 1]) and normalises them in float32
    by ``cfg``'s pixel mean and std, as the JAX models' ``_features``."""

    def __init__(self, cfg, backbone: nn.Module):
        super().__init__()
        self.cfg = cfg
        self.backbone = backbone
        for name in ("pixel_mean", "pixel_std"):
            self.register_buffer(
                name, torch.tensor(getattr(cfg, name)).view(1, 3, 1, 1),
                persistent=False)

    def features(self, images: torch.Tensor) -> List[torch.Tensor]:
        x = images.permute(0, 3, 1, 2)  # NHWC memory = channels_last NCHW
        if x.dtype == torch.uint8:
            x = x.to(torch.float32) / 255.0
        x = (x - self.pixel_mean) / self.pixel_std
        return self.backbone(x.contiguous(memory_format=torch.channels_last))


class BackboneWithFPN(nn.Module):
    """``body`` (ResNet C2..C5) followed by ``fpn`` -> P2..P6 (P3..P7 with
    the one-stage pyramid)."""

    def __init__(self, body: nn.Module, fpn: FeaturePyramidNetwork):
        super().__init__()
        self.body = body
        self.fpn = fpn

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.fpn(self.body(x))
