"""Optimisers over the trainable parameters, with the learning rate injected
per step.

Counterpart of ``podtpu/train/optim.py``.  The JAX package builds optax
chains masked to the trainable parameters; the port builds PyTorch
optimisers whose updates equal those chains:

* ``sgd``: :class:`SGD`, ``torch.optim.SGD(momentum, weight_decay,
  dampening=0, nesterov=False)``'s update with the learning rate a tensor.
  Its coupled weight decay, added to the gradient before the momentum
  buffer, is optax's ``add_decayed_weights`` followed by ``trace``; its
  first buffer is the gradient itself, which is a trace started from
  zeros.  So the update is ``p += -lr * (m * buf + g + wd * p)`` in both,
  the product rounded before the sum as optax's ``scale`` then
  ``apply_updates`` round it.
* ``adam``: ``torch.optim.Adam`` is ``scale_by_adam`` (b1 0.9, b2 0.999,
  eps 1e-8 outside the square root) times ``-lr``.
* ``adamw``: ``torch.optim.AdamW`` scales the parameter by ``1 - lr * wd``
  and then subtracts ``lr`` times the Adam update, which is optax's
  ``scale_by_adam`` then ``add_decayed_weights`` then ``-lr``.

``norm_weight_decay`` becomes a second parameter group.  Frozen backbone
stages are not in the optimiser at all (they have ``requires_grad=False``),
so they get neither a gradient nor an update, as under ``optax.masked``.
``momentum_dtype="bfloat16"`` keeps the SGD buffer in bf16 and adds in
float32 (:class:`SGDBF16Momentum`).  ``fused_sgd`` is plain SGD here: its
flat parameter buffer in the JAX package is a TPU mechanism (fewer XLA
fusions), and the arithmetic is the same.  Gradient clipping by global norm
follows optax (:func:`clip_by_global_norm_`), not ``clip_grad_norm_``,
which adds 1e-6 to the norm.

The learning rate reaches the update as a 0-d float32 tensor on the
parameters' device (:func:`apply_optimizer`), so that a CUDA graph of
training steps reads each step's rate from a buffer refreshed before the
replay; nothing in an update reads the device from the host.  On the GPU
Adam and AdamW run with ``capturable=True`` (:func:`make_capturable`:
their step counter on the device); on the CPU torch's Adam reads the rate
on the host.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import torch

from podtpu_torch.core.config import ModelConfig, TrainConfig


def trainable_mask_fn(model_cfg: ModelConfig) -> Callable[[str], bool]:
    """Predicate on the port's parameter names: False for the parameters of
    frozen backbone components (stem, then layer1, ...)."""
    frozen_stages = 5 - model_cfg.trainable_backbone_stages
    prefixes = []
    if frozen_stages >= 1:
        prefixes += ["backbone.body.conv1.", "backbone.body.bn1."]
    for s in range(1, frozen_stages):
        prefixes.append(f"backbone.body.layer{s}.")

    def mask(name: str) -> bool:
        return not any(name.startswith(p) for p in prefixes)

    return mask


def norm_param_mask(name: str, norms=()) -> bool:
    """True for trainable normalisation parameters: those named in
    ``norms`` (the model's GroupNorm weights and biases, which carry
    torchvision's names), GroupNorm scale and bias of modules named ``gn*``
    or ``*_gn*``, and SSD's ``l2norm_scale``.  Frozen BatchNorm holds
    buffers, so it never reaches the optimiser."""
    return name in norms or any(
        k.startswith("gn") or "_gn" in k or k == "l2norm_scale"
        for k in name.split("."))


class SGD(torch.optim.Optimizer):
    """SGD with coupled weight decay and a float32 momentum buffer
    (``torch.optim.SGD`` with ``dampening=0, nesterov=False``, the same
    state layout): ``d = g + wd * p``; ``buf = d`` on the first update,
    then ``buf = momentum * buf + d``; ``p += buf * -lr``.  ``lr`` may be a
    float or a 0-d tensor on the parameters' device."""

    def __init__(self, params, lr: float, momentum: float,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            wd, momentum = group["weight_decay"], group["momentum"]
            d = torch._foreach_add(grads, params, alpha=wd) if wd else grads
            if momentum:
                states = [self.state[p] for p in params]
                old = [i for i, st in enumerate(states)
                       if "momentum_buffer" in st]
                if old:
                    bufs = [states[i]["momentum_buffer"] for i in old]
                    torch._foreach_mul_(bufs, momentum)
                    torch._foreach_add_(bufs, [d[i] for i in old])
                for st, x in zip(states, d):
                    if "momentum_buffer" not in st:
                        st["momentum_buffer"] = torch.clone(x).detach()
                d = [st["momentum_buffer"] for st in states]
            lr = group["lr"]
            torch._foreach_add_(params, torch._foreach_mul(d, -lr))


class SGDBF16Momentum(torch.optim.Optimizer):
    """SGD with coupled weight decay and a bfloat16 momentum buffer, as
    optax's ``trace(accumulator_dtype=bf16)`` computes it: ``m = (g + wd *
    p) + bf16(momentum * buf)``, where the product is a bf16 product (JAX
    rounds the Python-float decay to bf16 too: 0.9 becomes 0.8984375), the
    sum is float32, then ``buf = bf16(m)`` and ``p -= lr * m``.  The buffer
    starts at zero.  (The JAX package's flat ``FusedSGD`` multiplies in
    float32 instead.)"""

    def __init__(self, params, lr: float, momentum: float,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            # A fill, not a copy from the host: the decay rounded to bf16.
            decay = torch.full((), group["momentum"], dtype=torch.bfloat16,
                               device=params[0].device)
            for p in params:
                state = self.state[p]
                if not state:
                    state["momentum_buffer"] = torch.zeros_like(
                        p, dtype=torch.bfloat16)
                buf = state["momentum_buffer"]
                u = p.grad.float() + group["weight_decay"] * p
                m = u + (buf * decay).float()
                buf.copy_(m)
                p.sub_(group["lr"] * m)


def _groups(train_cfg: TrainConfig, named, norm_names=()) -> List[dict]:
    if train_cfg.norm_weight_decay is None:
        return [{"params": [p for _, p in named],
                 "weight_decay": train_cfg.weight_decay}]
    rest = [p for n, p in named if not norm_param_mask(n, norm_names)]
    norms = [p for n, p in named if norm_param_mask(n, norm_names)]
    return [g for g in (
        {"params": rest, "weight_decay": train_cfg.weight_decay},
        {"params": norms, "weight_decay": float(train_cfg.norm_weight_decay)},
    ) if g["params"]]


def make_optimizer(train_cfg: TrainConfig,
                   model: torch.nn.Module) -> torch.optim.Optimizer:
    """The optimiser of ``train_cfg`` over ``model``'s trainable parameters
    (``requires_grad`` and not in a frozen stage of ``model.cfg``)."""
    mask = trainable_mask_fn(model.cfg)
    named = [(n, p) for n, p in model.named_parameters()
             if p.requires_grad and mask(n)]
    norm_names = {f"{m}.{n}" for m, mod in model.named_modules()
                  if isinstance(mod, torch.nn.GroupNorm)
                  for n, _ in mod.named_parameters(recurse=False)}
    if train_cfg.optimiser == "sgd":
        if train_cfg.fused_sgd and train_cfg.norm_weight_decay is not None:
            raise ValueError(
                "fused_sgd supports a single weight-decay rate; unset "
                "norm_weight_decay (or fused_sgd) for the split chain")
        groups = _groups(train_cfg, named, norm_names)
        if train_cfg.momentum_dtype == "bfloat16":
            return SGDBF16Momentum(groups, lr=train_cfg.lr,
                                   momentum=train_cfg.momentum)
        return SGD(groups, lr=train_cfg.lr, momentum=train_cfg.momentum)
    if train_cfg.optimiser == "adam":
        if train_cfg.norm_weight_decay is not None:
            raise ValueError(
                "--norm-weight-decay has no effect with --optimiser adam: "
                "the plain-Adam chain applies no weight decay; use sgd or "
                "adamw")
        return torch.optim.Adam([p for _, p in named], lr=train_cfg.adam_lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.0)
    if train_cfg.optimiser == "adamw":
        return torch.optim.AdamW(_groups(train_cfg, named, norm_names),
                                 lr=train_cfg.adam_lr, betas=(0.9, 0.999),
                                 eps=1e-8)
    raise ValueError("Optimiser must be one of 'sgd', 'adam' or 'adamw'")


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Scale the gradients by ``max_norm / norm`` when their global norm is
    at least ``max_norm`` (optax's ``clip_by_global_norm``); returns the
    norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm  # decided on the device: no host sync
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def make_capturable(optimizer: torch.optim.Optimizer) -> None:
    """On the GPU, Adam and AdamW keep their step counters on the device
    and read the rate there (``capturable=True``), so that a CUDA graph
    can hold their update; counters of a loaded state move there.  Called
    once the parameters are on their device and any state is loaded
    (:func:`podtpu_torch.train.step.make_train_step`).  Other optimisers,
    and any on the CPU, are left as they are."""
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        return
    for group in optimizer.param_groups:
        if not group["params"] or group["params"][0].device.type != "cuda":
            continue
        group["capturable"] = True
        for p in group["params"]:
            step = optimizer.state.get(p, {}).get("step")
            if torch.is_tensor(step) and step.device != p.device:
                optimizer.state[p]["step"] = step.to(p.device, torch.float32)


def apply_optimizer(optimizer: torch.optim.Optimizer, lr,
                    clip_grad_norm: Optional[float] = None) -> None:
    """One update from the gradients in ``.grad``: clip (if set), inject
    ``lr`` into every parameter group, step.

    ``lr`` is a float or a 0-d float32 tensor on the parameters' device; a
    float becomes such a tensor (a fill, no copy from the host), so the
    update's arithmetic does not depend on which was given.  Inside a CUDA
    graph ``lr`` must be the tensor the graph reads.  An Adam or AdamW that
    is not capturable (:func:`make_capturable`) reads its rate on the host
    and gets it as a float."""
    if clip_grad_norm:
        clip_by_global_norm_([p for g in optimizer.param_groups
                              for p in g["params"]], float(clip_grad_norm))
    first = optimizer.param_groups[0]
    if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)) \
            and not first.get("capturable"):
        lr = float(lr)
    elif not torch.is_tensor(lr):
        lr = torch.full((), float(lr), dtype=torch.float32,
                        device=first["params"][0].device)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
