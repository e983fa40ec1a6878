"""ResNet-50 backbone with frozen BatchNorm, detection flavour.

Counterpart of ``podtpu/models/resnet.py``: torchvision's v1 architecture
(stride on the 3x3 conv of each bottleneck), returning C2..C5.  Module names
follow torchvision (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer1.0.downsample.0``), so a torchvision state dict maps one to one.

Parameters are float32; each conv runs in the model's compute dtype with its
input and weight cast per call, as flax's ``dtype=bf16, param_dtype=f32``
does, and autograd returns float32 gradients to them.  Tensors are NCHW in
``torch.channels_last`` memory.

``trainable_stages`` counts the trailing components of [stem, layer1,
layer2, layer3, layer4] that train: the others' parameters have
``requires_grad=False`` and their outputs are detached, as the JAX model's
``stop_gradient`` below frozen components.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Optional

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


class BatchNorm2d(nn.Module):
    """Trainable BatchNorm, the counterpart of the JAX package's
    ``FrozenBatchNorm(trainable=True)``: ``weight`` and ``bias`` are
    parameters; ``running_mean``, ``running_var`` and
    ``num_batches_tracked`` are buffers, so torchvision's ``BatchNorm2d``
    state dict loads.

    With ``batch_stats`` set (:func:`batch_statistics`, which the train
    step holds around its forward, as the JAX step marks the ``frozen``
    collection mutable) the norm takes the float32 mean and the variance
    (the mean of squared deviations, ``jnp.var``) of its input over batch
    and space, and moves the running averages in place by ``momentum``
    towards the mean and the unbiased variance.  Otherwise it reads the
    running averages.  Either way ``(x - m) * rsqrt(v + eps) * weight +
    bias`` is computed in float32 and cast once to the input's dtype.  The
    mode is not ``nn.Module.training``, which no entry point sets."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.batch_stats = False
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.batch_stats:
            m = xf.mean((0, 2, 3))
            d = xf - m.view(1, -1, 1, 1)
            v = (d * d).mean((0, 2, 3))
            n = xf.shape[0] * xf.shape[2] * xf.shape[3]
            with torch.no_grad():
                # In place: a captured step writes the same storage.
                mo = self.momentum
                self.running_mean.mul_(1 - mo).add_(mo * m)
                self.running_var.mul_(1 - mo).add_(
                    mo * (v * (n / max(n - 1, 1))))
                self.num_batches_tracked.add_(1)
        else:
            m, v = self.running_mean, self.running_var
            d = xf - m.view(1, -1, 1, 1)
        y = (d * torch.rsqrt(v + self.eps).view(1, -1, 1, 1)
             * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1))
        return y.to(x.dtype)


def norm_layer(batch: bool):
    """The trunk's norm: :class:`BatchNorm2d` with ``batch``, else
    :class:`FrozenBatchNorm2d`."""
    return BatchNorm2d if batch else FrozenBatchNorm2d


@contextlib.contextmanager
def batch_statistics(model: nn.Module) -> Iterator[None]:
    """Within the block, every :class:`BatchNorm2d` of ``model`` normalises
    by its batch's statistics and moves its running averages."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.batch_stats = True
    try:
        yield
    finally:
        for m in norms:
            m.batch_stats = False


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
                 compute_dtype: torch.dtype = torch.float32,
                 trainable_stages: int = 5):
        super().__init__()
        self.compute_dtype = compute_dtype
        # Components [0, freeze_from) of [stem, layer1, ...] are frozen.
        self.freeze_from = 5 - trainable_stages
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
        # The stem's norm bn1 holds buffers only.
        frozen = (["conv1"] if self.freeze_from > 0 else []) + [
            f"layer{s}" for s in range(1, self.freeze_from)]
        for name in frozen:
            getattr(self, name).requires_grad_(False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = F.relu(self.bn1(self.conv1(x.to(self.compute_dtype))))
        # 3x3/s2 max pool with implicit -inf padding, as flax's max_pool.
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        if self.freeze_from > 0:
            h = h.detach()
        outs = []
        for stage in range(self.num_stages):
            h = getattr(self, f"layer{stage + 1}")(h)
            if stage + 1 < self.freeze_from:
                h = h.detach()
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
