"""Augmentation policies on the device, batched.

Counterpart of ``podtpu/data/presets.py``: ``miso`` (hflip + vflip +
photometric distortion, the reference pipeline's default), ``hflip`` and
``none``.  A policy maps ``(images [B, H, W, 3] in [0, 1], boxes [B, G, 4],
valid [B, G], draws, masks=None)`` to the augmented ``(images, boxes, valid,
masks)``, with one decision per image; mask targets ``[B, G, Hm, Wm]``
follow the flips, and ``masks`` stays None when none is given.  Its random
numbers are the explicit tensors of :class:`AugmentDraws`
(:func:`draw_augment` makes them from a ``torch.Generator``).  Keypoints
wait for ROADMAP.md item 11.  The geometric policies wait for the models
whose recipes they are: ``lsj`` and ``multiscale`` for item 12 (v2
recipes), ``ssd`` and ``ssdlite`` for item 14 (SSD).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from podtpu_torch.ops import image_ops as T

AugmentFn = Callable

# Policy -> the ROADMAP.md item that brings it.
NOT_PORTED = {"lsj": "item 12: v2 recipes",
              "multiscale": "item 12: v2 recipes",
              "ssd": "item 14: SSD and the mobile trunks",
              "ssdlite": "item 14: SSD and the mobile trunks"}


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
           vflip_prob=0.5, masks=None):
    h, w = images.shape[1], images.shape[2]
    fimg, fbox = T.hflip(images, boxes, float(w))
    do = draws.hflip < hflip_prob
    images, boxes = _select(do, fimg, images), _select(do, fbox, boxes)
    if masks is not None:
        masks = _select(do, masks.flip(3), masks)
    fimg, fbox = T.vflip(images, boxes, float(h))
    do = draws.vflip < vflip_prob
    images, boxes = _select(do, fimg, images), _select(do, fbox, boxes)
    if masks is not None:
        masks = _select(do, masks.flip(2), masks)
    return images, boxes, masks


def miso_policy(images, boxes, valid, draws: AugmentDraws, masks=None,
                distort=True, vflip_prob=0.5):
    images, boxes, masks = _flips(images, boxes, draws,
                                  vflip_prob=vflip_prob, masks=masks)
    if distort:
        images = T.photometric_distort(images, draws.photometric)
    return images, boxes, valid, masks


def hflip_policy(images, boxes, valid, draws: AugmentDraws, masks=None):
    images, boxes, masks = _flips(images, boxes, draws, vflip_prob=0.0,
                                  masks=masks)
    return images, boxes, valid, masks


def none_policy(images, boxes, valid, draws: AugmentDraws, masks=None):
    return images, boxes, valid, masks


POLICIES = {
    "miso": miso_policy,
    "hflip": hflip_policy,
    "none": none_policy,
}


def get_policy(name: str) -> AugmentFn:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"podtpu_torch does not port the {name!r} augmentation policy "
            f"yet (ROADMAP.md, {NOT_PORTED[name]})")
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
                         draws: AugmentDraws, masks=None, **kw):
    """Apply ``policy`` to a batch; returns ``(images, boxes, valid,
    masks)``, ``masks`` None when not given."""
    return policy(images, boxes, valid, draws, masks=masks, **kw)
