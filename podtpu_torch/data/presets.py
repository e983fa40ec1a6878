"""Augmentation policies on the device, batched.

Counterpart of ``podtpu/data/presets.py``: ``miso`` (hflip + vflip +
photometric distortion, the reference pipeline's default), ``hflip``,
``lsj`` (large-scale jitter: a resample at a scale drawn in 0.1-2.0, then
hflip), ``multiscale`` (the same in 0.5-1.25) and ``none``.  A policy
maps ``(images [B, H, W, 3] in [0, 1], boxes [B, G, 4], valid [B, G],
draws, masks=None, keypoints=None)`` to the augmented
``(images, boxes, valid, masks, keypoints)``, with one decision per image;
mask targets ``[B, G, Hm, Wm]`` and keypoints ``[B, G, K, 3]`` follow the
flips (a horizontal flip also permutes the keypoints by ``kp_hflip_inds``,
a chiral skeleton's left/right swap), and each stays None when none is
given; the jitter resamples masks and moves keypoints with the image,
and a keypoint that leaves the canvas becomes invisible.  Its random
numbers are the explicit tensors of :class:`AugmentDraws`
(:func:`draw_augment` makes them from a ``torch.Generator``).  ``ssd`` and
``ssdlite`` wait for the model whose recipe they are: item 14 (SSD).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from podtpu_torch.ops import image_ops as T

AugmentFn = Callable

# Policy -> the ROADMAP.md item that brings it.
NOT_PORTED = {"ssd": "item 14: SSD and the mobile trunks",
              "ssdlite": "item 14: SSD and the mobile trunks"}

# The scale range of each scale-jitter policy (the JAX package's
# ``T.scale_jitter`` ranges).
SCALE_RANGES = {"lsj": (0.1, 2.0), "multiscale": (0.5, 1.25)}


class AugmentDraws(NamedTuple):
    hflip: torch.Tensor                # [B] uniforms; flip where < prob
    vflip: torch.Tensor                # [B]
    photometric: T.PhotometricDraws
    # [B] scales of a scale-jitter policy (None for the others).
    scale: Optional[torch.Tensor] = None


def draw_augment(generator: torch.Generator, batch: int,
                 scale_range: Optional[Tuple[float, float]] = None
                 ) -> AugmentDraws:
    """One batch's draws on ``generator``'s device; with ``scale_range``
    also a scale per image, uniform in it, drawn last."""
    dev = generator.device
    hf = torch.rand(batch, generator=generator, device=dev)
    vf = torch.rand(batch, generator=generator, device=dev)
    photometric = T.draw_photometric(generator, batch)
    scale = None
    if scale_range is not None:
        lo, hi = scale_range
        scale = lo + torch.rand(batch, generator=generator,
                                device=dev) * (hi - lo)
    return AugmentDraws(hflip=hf, vflip=vf, photometric=photometric,
                        scale=scale)


def _select(do: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    return torch.where(do.view(-1, *([1] * (a.dim() - 1))), a, b)


def _flip_kps_h(kps, width, hflip_inds=None):
    out = torch.stack([width - kps[..., 0], kps[..., 1], kps[..., 2]], -1)
    if hflip_inds is not None and len(hflip_inds):
        # One view a joint, stacked: indexing by a list would copy the
        # indices from the host, which a CUDA graph capture refuses.
        out = torch.stack([out[:, :, i] for i in hflip_inds], 2)
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


def scale_jitter_policy(images, boxes, valid, draws: AugmentDraws,
                        masks=None, keypoints=None, kp_hflip_inds=None):
    """``lsj`` and ``multiscale``: each image resampled by its
    ``draws.scale`` (drawn in the policy's ``SCALE_RANGES``), then flipped
    horizontally; boxes narrower or lower than 1 px become invalid."""
    images, boxes, masks, keypoints = T.scale_jitter(
        images, boxes, draws.scale, masks=masks, keypoints=keypoints)
    images, boxes, masks, keypoints = _flips(
        images, boxes, draws, vflip_prob=0.0, masks=masks,
        keypoints=keypoints, kp_hflip_inds=kp_hflip_inds)
    return images, boxes, _revalidate(boxes, valid), masks, keypoints


def none_policy(images, boxes, valid, draws: AugmentDraws, masks=None,
                keypoints=None, kp_hflip_inds=None):
    return images, boxes, valid, masks, keypoints


def _revalidate(boxes, valid):
    """Valid boxes that stay wider and higher than 1 px."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return valid & (w > 1.0) & (h > 1.0)


POLICIES = {
    "miso": miso_policy,
    "hflip": hflip_policy,
    "lsj": scale_jitter_policy,
    "multiscale": scale_jitter_policy,
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
