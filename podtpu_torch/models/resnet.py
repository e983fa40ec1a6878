"""ResNet-50 backbone with frozen BatchNorm, detection flavour.

Counterpart of ``podtpu/models/resnet.py``: torchvision's v1 architecture
(stride on the 3x3 conv of each bottleneck), returning C2..C5.  Module names
follow torchvision (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer1.0.downsample.0``), so a torchvision state dict maps one to one.

Parameters are float32; each conv runs in the model's compute dtype with its
input and weight cast per call, as flax's ``dtype=bf16, param_dtype=f32``
does.  Tensors are NCHW in ``torch.channels_last`` memory.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype`` (input, weight and
    bias cast per call); parameters stay float32."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with fixed statistics and affine terms (buffers only, as
    torchvision's ``FrozenBatchNorm2d``).  The four vectors fold into one
    float32 scale and shift, cast to the input's dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return (x * scale.to(x.dtype).view(1, -1, 1, 1)
                + shift.to(x.dtype).view(1, -1, 1, 1))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride here) -> 1x1 (x4), with a projection shortcut."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = planes * self.expansion
        kw = dict(bias=False, compute_dtype=compute_dtype)
        self.conv1 = Conv2d(inplanes, planes, 1, **kw)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, **kw)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = Conv2d(planes, out_ch, 1, **kw)
        self.bn3 = FrozenBatchNorm2d(out_ch)
        self.downsample: Optional[nn.Sequential] = None
        if inplanes != out_ch or stride != 1:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, out_ch, 1, stride=stride, **kw),
                FrozenBatchNorm2d(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNet(nn.Module):
    """ResNet returning C2..C5 (strides 4, 8, 16, 32)."""

    def __init__(self, stage_sizes=(3, 4, 6, 3),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            compute_dtype=compute_dtype)
        self.bn1 = FrozenBatchNorm2d(64)
        inplanes, planes = 64, 64
        for stage, blocks in enumerate(stage_sizes):
            layer = []
            for b in range(blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                layer.append(Bottleneck(inplanes, planes, stride,
                                        compute_dtype))
                inplanes = planes * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layer))
            planes *= 2
        self.num_stages = len(stage_sizes)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = F.relu(self.bn1(self.conv1(x.to(self.compute_dtype))))
        # 3x3/s2 max pool with implicit -inf padding, as flax's max_pool.
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        outs = []
        for stage in range(self.num_stages):
            h = getattr(self, f"layer{stage + 1}")(h)
            outs.append(h)
        return outs


def trunc_normal_(t: torch.Tensor, std: float,
                  generator: torch.Generator) -> torch.Tensor:
    """Normal(0, std) truncated at two standard deviations, drawn from
    ``generator`` by the inverse CDF."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    with torch.no_grad():
        t.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
        t.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)
    return t


def variance_scaling_(t: torch.Tensor, scale: float, mode: str,
                      generator: torch.Generator) -> torch.Tensor:
    """flax's ``variance_scaling(scale, mode, "truncated_normal")`` for a
    torch-layout weight (``[out, in, *kernel]``)."""
    receptive = t[0, 0].numel() if t.dim() > 2 else 1
    fan = (t.shape[1] if mode == "fan_in" else t.shape[0]) * receptive
    # 0.8796 is the std of a unit normal truncated at +-2 (flax's constant).
    std = math.sqrt(scale / fan) / 0.87962566103423978
    return trunc_normal_(t, std, generator)
