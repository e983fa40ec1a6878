"""Augmentation policies on the device, batched.

Counterpart of ``podtpu/data/presets.py``: ``miso`` (hflip + vflip +
photometric distortion, the reference pipeline's default), ``hflip`` and
``none``.  A policy maps ``(images [B, H, W, 3] in [0, 1], boxes [B, G, 4],
valid [B, G], draws)`` to the augmented ``(images, boxes, valid)``, with one
decision per image.  Its random numbers are the explicit tensors of
:class:`AugmentDraws` (:func:`draw_augment` makes them from a
``torch.Generator``).  Masks and keypoints do not ride along yet: the port
has no mask or keypoint model.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from podtpu_torch.ops import image_ops as T

AugmentFn = Callable

NOT_PORTED = ("lsj", "multiscale", "ssd", "ssdlite")


class AugmentDraws(NamedTuple):
    hflip: torch.Tensor                # [B] uniforms; flip where < prob
    vflip: torch.Tensor                # [B]
    photometric: T.PhotometricDraws


def draw_augment(generator: torch.Generator, batch: int) -> AugmentDraws:
    dev = generator.device
    hf = torch.rand(batch, generator=generator, device=dev)
    vf = torch.rand(batch, generator=generator, device=dev)
    return AugmentDraws(hflip=hf, vflip=vf,
                        photometric=T.draw_photometric(generator, batch))


def _select(do: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(do.view(-1, *([1] * (a.dim() - 1))), a, b)


def _flips(images, boxes, draws: AugmentDraws, hflip_prob=0.5,
           vflip_prob=0.5):
    h, w = images.shape[1], images.shape[2]
    fimg, fbox = T.hflip(images, boxes, float(w))
    do = draws.hflip < hflip_prob
    images, boxes = _select(do, fimg, images), _select(do, fbox, boxes)
    fimg, fbox = T.vflip(images, boxes, float(h))
    do = draws.vflip < vflip_prob
    return _select(do, fimg, images), _select(do, fbox, boxes)


def miso_policy(images, boxes, valid, draws: AugmentDraws, distort=True,
                vflip_prob=0.5):
    images, boxes = _flips(images, boxes, draws, vflip_prob=vflip_prob)
    if distort:
        images = T.photometric_distort(images, draws.photometric)
    return images, boxes, valid


def hflip_policy(images, boxes, valid, draws: AugmentDraws):
    images, boxes = _flips(images, boxes, draws, vflip_prob=0.0)
    return images, boxes, valid


def none_policy(images, boxes, valid, draws: AugmentDraws):
    return images, boxes, valid


POLICIES = {
    "miso": miso_policy,
    "hflip": hflip_policy,
    "none": none_policy,
}


def get_policy(name: str) -> AugmentFn:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"podtpu_torch does not port the {name!r} augmentation policy "
            "yet (ROADMAP.md, open item 1: the other augmentation policies "
            "and copy-paste)")
    if name not in POLICIES:
        raise ValueError(f"Unknown augmentation policy {name!r}; choose "
                         f"from {sorted(POLICIES) + list(NOT_PORTED)}")
    return POLICIES[name]


def policy_kwargs(cfg) -> dict:
    """Per-config policy arguments: the miso policy's photometric switch.
    (The JAX package also passes a keypoint flip permutation here; the port
    has no keypoint model yet.)"""
    if cfg.data.aug_policy == "miso":
        return {"distort": cfg.data.photometric_distort}
    return {}


@torch.no_grad()
def augment_batch_policy(policy: AugmentFn, images, boxes, valid,
                         draws: AugmentDraws, **kw):
    """Apply ``policy`` to a batch; returns ``(images, boxes, valid)``."""
    return policy(images, boxes, valid, draws, **kw)
