"""Augmentation policies on the device, batched.

Counterpart of ``podtpu/data/presets.py``: ``miso`` (hflip + vflip +
photometric distortion, the reference pipeline's default), ``hflip`` and
``none``.  A policy maps ``(images [B, H, W, 3] in [0, 1], boxes [B, G, 4],
valid [B, G], draws, masks=None, keypoints=None)`` to the augmented
``(images, boxes, valid, masks, keypoints)``, with one decision per image;
mask targets ``[B, G, Hm, Wm]`` and keypoints ``[B, G, K, 3]`` follow the
flips (a horizontal flip also permutes the keypoints by ``kp_hflip_inds``,
a chiral skeleton's left/right swap), and each stays None when none is
given.  Its random numbers are the explicit tensors of
:class:`AugmentDraws` (:func:`draw_augment` makes them from a
``torch.Generator``).  The geometric policies wait for the models
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


def _flip_kps_h(kps, width, hflip_inds=None):
    out = torch.stack([width - kps[..., 0], kps[..., 1], kps[..., 2]], -1)
    if hflip_inds is not None and len(hflip_inds):
        out = out[:, :, list(hflip_inds)]
    return out


def _flip_kps_v(kps, height):
    return torch.stack([kps[..., 0], height - kps[..., 1], kps[..., 2]], -1)


def _flips(images, boxes, draws: AugmentDraws, hflip_prob=0.5,
           vflip_prob=0.5, masks=None, keypoints=None, kp_hflip_inds=None):
    h, w = images.shape[1], images.shape[2]
    fimg, fbox = T.hflip(images, boxes, float(w))
    do = draws.hflip < hflip_prob
    images, boxes = _select(do, fimg, images), _select(do, fbox, boxes)
    if masks is not None:
        masks = _select(do, masks.flip(3), masks)
    if keypoints is not None:
        keypoints = _select(
            do, _flip_kps_h(keypoints, float(w), kp_hflip_inds), keypoints)
    fimg, fbox = T.vflip(images, boxes, float(h))
    do = draws.vflip < vflip_prob
    images, boxes = _select(do, fimg, images), _select(do, fbox, boxes)
    if masks is not None:
        masks = _select(do, masks.flip(2), masks)
    if keypoints is not None:
        keypoints = _select(do, _flip_kps_v(keypoints, float(h)), keypoints)
    return images, boxes, masks, keypoints


def miso_policy(images, boxes, valid, draws: AugmentDraws, masks=None,
                keypoints=None, distort=True, kp_hflip_inds=None,
                vflip_prob=0.5):
    """``vflip_prob`` is 0 under a chiral skeleton (``policy_kwargs``): no
    vertical joint remap exists."""
    images, boxes, masks, keypoints = _flips(
        images, boxes, draws, vflip_prob=vflip_prob, masks=masks,
        keypoints=keypoints, kp_hflip_inds=kp_hflip_inds)
    if distort:
        images = T.photometric_distort(images, draws.photometric)
    return images, boxes, valid, masks, keypoints


def hflip_policy(images, boxes, valid, draws: AugmentDraws, masks=None,
                 keypoints=None, kp_hflip_inds=None):
    images, boxes, masks, keypoints = _flips(
        images, boxes, draws, vflip_prob=0.0, masks=masks,
        keypoints=keypoints, kp_hflip_inds=kp_hflip_inds)
    return images, boxes, valid, masks, keypoints


def none_policy(images, boxes, valid, draws: AugmentDraws, masks=None,
                keypoints=None, kp_hflip_inds=None):
    return images, boxes, valid, masks, keypoints


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
    """Per-config policy arguments: the miso policy's photometric switch,
    and a keypoint model's flip permutation; a non-identity one (a chiral
    skeleton) sets the miso policy's ``vflip_prob`` to 0.  The draw is made
    all the same."""
    kw = {}
    if cfg.data.aug_policy == "miso":
        kw["distort"] = cfg.data.photometric_distort
    if cfg.model.with_keypoints and cfg.model.keypoint_hflip_inds:
        inds = tuple(cfg.model.keypoint_hflip_inds)
        kw["kp_hflip_inds"] = inds
        if cfg.data.aug_policy == "miso" \
                and inds != tuple(range(len(inds))):
            kw["vflip_prob"] = 0.0
    return kw


@torch.no_grad()
def augment_batch_policy(policy: AugmentFn, images, boxes, valid,
                         draws: AugmentDraws, masks=None, keypoints=None,
                         **kw):
    """Apply ``policy`` to a batch; returns ``(images, boxes, valid, masks,
    keypoints)``, ``masks`` and ``keypoints`` None when not given."""
    return policy(images, boxes, valid, draws, masks=masks,
                  keypoints=keypoints, **kw)
