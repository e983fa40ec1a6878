"""Crop classifier: a compact ResNet over fixed-size object crops.

Counterpart of ``podtpu/models/classifier.py``: a ResNet-18-like trunk
(``stage_sizes`` basic blocks per stage, ``width`` channels doubling each
stage) with GroupNorm(32) in place of BatchNorm, so that the model does not
depend on the batch, and a global-average-pool linear head.  Module names
are the flax ones (``stem``, ``gn_stem``, ``stage{s}_{b}.conv1``, ``gn1``,
``conv2``, ``gn2``, ``proj``, ``gn_proj``, ``head``), so the weight bridge
(``models/weights.py::classifier_state_dict_from_flax``) is a renaming and
a change of layout.

As in the JAX model: inputs are ``[B, H, W, 3]`` floats in [0, 1],
normalised by the ImageNet mean and std in float32; the trunk computes in
``dtype`` (bf16 by default) with float32 parameters; GroupNorm is flax's
formula with flax's epsilon (``models/retinanet.py::GroupNorm``); the max
pool pads with -inf; the spatial mean is taken in float32 and the head
runs in float32.  Tensors are NCHW in ``torch.channels_last`` memory.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from podtpu_torch.models.resnet import Conv2d, variance_scaling_
from podtpu_torch.models.retinanet import GroupNorm

# flax.linen.GroupNorm's default epsilon (torch's is 1e-5).
GROUP_NORM_EPS = 1e-6
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _group_norm(channels: int) -> GroupNorm:
    return GroupNorm(32, channels, eps=GROUP_NORM_EPS)


class ClassifierBlock(nn.Module):
    """Two 3x3 convolutions with GroupNorm, the stride on the first, and a
    1x1 projection (with GroupNorm) when the shape changes."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        kw = dict(bias=False, compute_dtype=dtype)
        self.conv1 = Conv2d(inplanes, planes, 3, stride=stride, padding=1,
                            **kw)
        self.gn1 = _group_norm(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, **kw)
        self.gn2 = _group_norm(planes)
        self.proj = self.gn_proj = None
        if inplanes != planes or stride != 1:
            self.proj = Conv2d(inplanes, planes, 1, stride=stride, **kw)
            self.gn_proj = _group_norm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.gn1(self.conv1(x)))
        y = self.gn2(self.conv2(y))
        identity = x if self.proj is None else self.gn_proj(self.proj(x))
        return F.relu(y + identity)


class CropClassifier(nn.Module):
    """ResNet-style classifier over fixed-size crops (default 128x128):
    images ``[B, H, W, 3]`` in [0, 1] -> logits ``[B, num_classes]``
    (float32)."""

    def __init__(self, num_classes: int,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2), width: int = 64,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)
        self.stem = Conv2d(3, width, 7, stride=2, padding=3, bias=False,
                           compute_dtype=dtype)
        self.gn_stem = _group_norm(width)
        self.blocks = []
        inplanes = planes = width
        for stage, blocks in enumerate(self.stage_sizes):
            for b in range(blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                name = f"stage{stage + 1}_{b}"
                self.add_module(name, ClassifierBlock(inplanes, planes,
                                                      stride, dtype))
                self.blocks.append(name)
                inplanes = planes
            planes *= 2
        self.head = nn.Linear(inplanes, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = ((x.float() - self.mean) / self.std).to(self.dtype)
        h = h.permute(0, 3, 1, 2)  # NHWC memory: a channels_last NCHW view
        h = F.relu(self.gn_stem(self.stem(h)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        for name in self.blocks:
            h = getattr(self, name)(h)
        return self.head(h.float().mean((2, 3)))


def init_classifier(model: CropClassifier,
                    generator: torch.Generator) -> None:
    """Initialise as flax does: ``lecun_normal`` (truncated normal, fan-in)
    convolutions and head, zero head bias, GroupNorm scale 1 and bias 0.
    Draws come from ``generator`` (a CPU generator; the model must be on
    the CPU)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            variance_scaling_(mod.weight.data, 1.0, "fan_in", generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.GroupNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
