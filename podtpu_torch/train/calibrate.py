"""Data-dependent initialisation of FrozenBatchNorm statistics.

Counterpart of ``podtpu/train/calibrate.py``.  Training from scratch leaves
every frozen BatchNorm at its identity init, so the network is effectively
normalisation-free; a deep trunk can then attenuate its signal until the
RPN never starts.  LSUV-style calibration runs the feature extractor on one
real batch and sets each frozen BN's (mean, var) to the observed statistics
of its input, over a few passes so downstream layers see their upstream's
calibrated output.  ``train()`` runs :func:`needs_calibration` on every
from-scratch run (``TrainConfig.calibrate_bn="auto"``) and calibrates when
it says so.

The port's :class:`FrozenBatchNorm2d` keeps ``weight``, ``bias``,
``running_mean`` and ``running_var`` as buffers; this module rewrites the
last two in place.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from podtpu_torch.models.resnet import FrozenBatchNorm2d


def _features(model, images) -> list:
    with torch.inference_mode():
        return model.features(torch.as_tensor(images).to(
            next(model.parameters()).device))


def _capture_bn_stats(model, images) -> Dict[str, tuple]:
    """Per-channel mean and variance of every FrozenBN's output over one
    feature pass, float64 on the host, keyed by module name."""
    stats: Dict[str, tuple] = {}
    hooks = []
    for name, mod in model.named_modules():
        if isinstance(mod, FrozenBatchNorm2d):
            def hook(_m, _inp, out, name=name):
                # The variance as jnp.var takes it: the mean of squared
                # deviations in float32, which overflows to inf where the
                # reference's does, so the non-finite rule below skips the
                # same layers (torch.var's stays finite there).
                out = out.float()
                mean = out.mean((0, 2, 3))
                var = ((out - mean[:, None, None]) ** 2).mean((0, 2, 3))
                stats[name] = (mean, var)
            hooks.append(mod.register_forward_hook(hook))
    try:
        _features(model, images)
    finally:
        for h in hooks:
            h.remove()
    return {k: (m.double().cpu().numpy(), v.double().cpu().numpy())
            for k, (m, v) in stats.items()}


def needs_calibration(model, images, threshold: float = 1e-3) -> bool:
    """True when the feature taps are pathologically small on a sample
    batch (the "auto" criterion): the largest mean |P_i| over the pyramid
    is under ``threshold``."""
    scale = max(float(f.float().abs().mean()) for f in _features(model,
                                                                 images))
    return bool(np.isfinite(scale)) and scale < threshold


def calibrate_frozen_stats(model, images, passes: int = 12,
                           eps: float = 1e-5, max_step: float = 100.0,
                           damping: float = 1.0):
    """Set every feature-extractor FrozenBN's (mean, var) to its observed
    input statistics on ``images``; returns ``model``.

    The BN output with current stats (m, v) and affine (w, b) relates to its
    input by ``x = (o - b) * sqrt(v + eps) / w + m``, so the input
    statistics follow from the output statistics and the update composes
    across passes.  Each pass clamps the correction factor to
    ``[1/max_step, max_step]``; non-finite captures are skipped; a final
    clamp bounds every calibrated stat (dead channels never settle).
    """
    bns = {n: m for n, m in model.named_modules()
           if isinstance(m, FrozenBatchNorm2d)}
    if not bns:
        return model
    for _ in range(passes):
        stats = _capture_bn_stats(model, images)
        converged = True
        for name, (mean_o, var_o) in stats.items():
            if not (np.isfinite(mean_o).all() and np.isfinite(var_o).all()):
                continue
            bn = bns[name]
            w = bn.weight.double().cpu().numpy()
            b = bn.bias.double().cpu().numpy()
            v = bn.running_var.double().cpu().numpy()
            std = np.sqrt(v + eps)
            safe_w = np.where(np.abs(w) > 1e-12, w, 1.0)
            c = np.clip(var_o / safe_w ** 2, 1.0 / max_step,
                        max_step) ** damping
            shift = damping * np.clip((mean_o - b) / safe_w,
                                      -max_step, max_step)
            mean = (bn.running_mean.double().cpu().numpy()
                    + shift * std).astype(np.float32)
            var = np.maximum((v + eps) * c - eps, 1e-10).astype(np.float32)
            bn.running_mean.copy_(torch.from_numpy(mean))
            bn.running_var.copy_(torch.from_numpy(var))
            if np.abs(np.log(np.maximum(c, 1e-12))).max() > 0.5 \
                    or np.abs(shift).max() > 0.5:
                converged = False
        if converged:
            break
    for bn in bns.values():
        bn.running_mean.clamp_(-1e3, 1e3)
        bn.running_var.clamp_(1e-4, 1e4)
    return model
