"""Device-side augmentation on batches of ``[B, H, W, 3]`` float images.

Counterpart of ``podtpu/ops/image_ops.py`` (``hflip``, ``vflip``,
``rgb_to_hsv``, ``hsv_to_rgb``, ``photometric_distort``,
``copy_paste_batch``, ``scale_and_place`` with its mask and keypoint forms,
``scale_jitter``, ``zoom_out``, ``iou_crop``), batched with one decision
per image: each transform is computed for the whole batch and selected per
image with ``torch.where``, as the JAX package selects inside its vmap; the
resample takes each image's own scale and translation.  The random numbers
are the explicit tensors of :class:`PhotometricDraws`, copy-paste's ``[B,
G]`` uniforms, the jitter's ``[B]`` scales, :class:`ZoomDraws` and
:class:`CropDraws`; :func:`draw_photometric`, :func:`draw_zoom` and
:func:`draw_crop` make them from a ``torch.Generator``.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from podtpu_torch.ops.boxes import box_iou

# torchvision RandomPhotometricDistort ranges.
BRIGHTNESS = (0.875, 1.125)
CONTRAST = (0.5, 1.5)
SATURATION = (0.5, 1.5)
HUE = (-18 / 360.0, 18 / 360.0)


def hflip(images: torch.Tensor, boxes: torch.Tensor, width: float):
    """Horizontal flip of ``[B, H, W, C]`` images and ``[B, G, 4]`` xyxy
    boxes."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return images.flip(2), torch.stack([width - x2, y1, width - x1, y2], -1)


def vflip(images: torch.Tensor, boxes: torch.Tensor, height: float):
    """Vertical flip of ``[B, H, W, C]`` images and ``[B, G, 4]`` boxes."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return images.flip(1), torch.stack([x1, height - y2, x2, height - y1], -1)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb.unbind(-1)
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    rng = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, rng / maxc.clamp(min=1e-12), zero)
    safe = rng.clamp(min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = torch.where(rng == 0, zero, h)
    return torch.stack([h, s, maxc], -1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = (i.long() % 6)[..., None]

    def pick(*options):
        return torch.gather(torch.stack(options, -1), -1, sector)[..., 0]

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], -1)


class PhotometricDraws(NamedTuple):
    """Per image ``[B]``: the factors of each jitter, the uniforms that
    decide whether it applies (``< p``) and whether contrast comes first
    (``< 0.5``), and a channel permutation ``[B, 3]``."""
    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor
    apply_brightness: torch.Tensor
    contrast_first: torch.Tensor
    apply_contrast: torch.Tensor
    apply_saturation: torch.Tensor
    apply_hue: torch.Tensor
    permutation: torch.Tensor  # [B, 3] int64
    apply_permutation: torch.Tensor


def draw_photometric(generator: torch.Generator,
                     batch: int) -> PhotometricDraws:
    dev = generator.device

    def u(lo=0.0, hi=1.0):
        x = torch.rand(batch, generator=generator, device=dev)
        return lo + x * (hi - lo)

    fields = dict(brightness=u(*BRIGHTNESS), contrast=u(*CONTRAST),
                  saturation=u(*SATURATION), hue=u(*HUE))
    for name in ("apply_brightness", "contrast_first", "apply_contrast",
                 "apply_saturation", "apply_hue"):
        fields[name] = u()
    fields["permutation"] = torch.argsort(
        torch.rand((batch, 3), generator=generator, device=dev), -1)
    fields["apply_permutation"] = u()
    return PhotometricDraws(**fields)


def _per_image(x: torch.Tensor) -> torch.Tensor:
    return x.view(-1, 1, 1, 1)


def _grey(img: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma ``[B, H, W, 1]``."""
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])[..., None]


def photometric_distort(images: torch.Tensor, draws: PhotometricDraws,
                        p: float = 0.5) -> torch.Tensor:
    """Brightness, contrast, saturation and hue jitter and a channel
    permutation of ``[B, H, W, 3]`` images in [0, 1], each applied to an
    image with probability ``p``; contrast comes before or after
    saturation and hue with even odds.  Output in [0, 1]."""

    def contrast(img):
        grey = _grey(img).mean(dim=(1, 2, 3), keepdim=True)
        return (img - grey) * _per_image(draws.contrast) + grey

    def saturation(img):
        grey = _grey(img)
        return (img - grey) * _per_image(draws.saturation) + grey

    def hue(img):
        hsv = rgb_to_hsv(img.clamp(0.0, 1.0))
        shifted = (hsv[..., 0] + draws.hue.view(-1, 1, 1)) % 1.0
        return hsv_to_rgb(torch.stack([shifted, hsv[..., 1], hsv[..., 2]],
                                      -1))

    img = torch.where(_per_image(draws.apply_brightness < p),
                      images * _per_image(draws.brightness), images)
    first = _per_image(draws.contrast_first < 0.5)
    do_contrast = _per_image(draws.apply_contrast < p)
    img = torch.where(first & do_contrast, contrast(img), img)
    img = torch.where(_per_image(draws.apply_saturation < p),
                      saturation(img), img)
    img = torch.where(_per_image(draws.apply_hue < p), hue(img), img)
    img = torch.where(~first & do_contrast, contrast(img), img)
    perm = draws.permutation[:, None, None, :].expand(img.shape)
    img = torch.where(_per_image(draws.apply_permutation < p),
                      torch.gather(img, -1, perm), img)
    return img.clamp(0.0, 1.0)


@torch.no_grad()
def copy_paste_batch(keep_draw: torch.Tensor, images: torch.Tensor,
                     boxes: torch.Tensor, labels: torch.Tensor,
                     valid: torch.Tensor, masks=None, region_stride: int = 8):
    """Simple Copy-Paste, batch-level: each image receives the instances of
    its batch neighbour (roll by 1), each kept where its uniform of
    ``keep_draw [B, G]`` is below 0.5.

    With ``masks [B, G, Hm, Wm]`` the pasted region is the union of the kept
    instances' masks; without, the union of their boxes, on a grid of
    ``region_stride`` px cells tested at the cells' centres.  The gt merge
    keeps the originals first and the pasted ones after, compacted stably
    to the ``G`` slots; the originals' masks are clipped by the region (their
    boxes are kept).  Returns ``(images, boxes, labels, valid, masks)``."""
    b, h, w, _ = images.shape
    g = boxes.shape[1]
    src_img = images.roll(1, 0)
    src_boxes = boxes.roll(1, 0)
    src_labels = labels.roll(1, 0)
    src_masks = masks.roll(1, 0) if masks is not None else None
    keep_paste = (keep_draw < 0.5) & valid.roll(1, 0)
    if src_masks is not None:
        region = ((src_masks * keep_paste[:, :, None, None]) > 0.5).any(1)
        mh, mw = region.shape[1:]
        sy, sx = h // mh, w // mw
    else:
        mh, mw = h // region_stride, w // region_stride
        sy = sx = region_stride
        dev = images.device
        yy = (torch.arange(mh, dtype=torch.float32, device=dev) + 0.5) * sy
        xx = (torch.arange(mw, dtype=torch.float32, device=dev) + 0.5) * sx
        x1, y1, x2, y2 = (c[:, :, None, None] for c in src_boxes.unbind(-1))
        inside = ((xx[None, None, None, :] >= x1)
                  & (xx[None, None, None, :] < x2)
                  & (yy[None, None, :, None] >= y1)
                  & (yy[None, None, :, None] < y2))
        region = (inside & keep_paste[:, :, None, None]).any(1)
    full = region.repeat_interleave(sy, 1).repeat_interleave(sx, 2)
    full = full[:, :h, :w, None]
    out_images = torch.where(full, src_img, images)

    all_valid = torch.cat([valid, keep_paste], 1)
    order = torch.argsort((~all_valid).to(torch.uint8), dim=1,
                          stable=True)[:, :g]
    out_boxes = torch.gather(torch.cat([boxes, src_boxes], 1), 1,
                             order[..., None].expand(-1, -1, 4))
    out_labels = torch.gather(torch.cat([labels, src_labels], 1), 1, order)
    out_valid = torch.gather(all_valid, 1, order)
    out_masks = None
    if masks is not None:
        clipped = masks * (1.0 - region[:, None].to(masks.dtype))
        all_masks = torch.cat([clipped, src_masks], 1)
        out_masks = torch.gather(
            all_masks, 1, order[:, :, None, None].expand(
                -1, -1, *all_masks.shape[2:]))
    return out_images, out_boxes, out_labels, out_valid, out_masks


_F32_EPS = float(torch.finfo(torch.float32).eps)


def _resample_weights(n_in: int, n_out: int, scale: torch.Tensor,
                      translation: torch.Tensor) -> torch.Tensor:
    """``[B, n_in, n_out]`` float32 weights of one axis of
    ``jax.image.scale_and_translate(method="linear", antialias=False)``,
    per image's ``[B]`` scale and translation: output pixel ``o`` samples
    the input at ``(o + 0.5) / s - t / s - 0.5`` with a triangle kernel;
    each column is divided by its sum (0 where the sum is about 0), and
    columns whose sample lies outside ``[-0.5, n_in - 0.5]`` are 0."""
    dev = scale.device
    inv = (1.0 / scale)[:, None]
    sample = ((torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5)
              * inv - translation[:, None] * inv - 0.5)            # [B, out]
    x = (sample[:, None, :] - torch.arange(
        n_in, dtype=torch.float32, device=dev)[None, :, None]).abs()
    w = (1.0 - x).clamp(min=0.0)
    total = w.sum(1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


@contextlib.contextmanager
def _ieee_float32_matmul():
    """Float32 products in full precision (no TF32) inside the block."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def _scale_translate(planes: torch.Tensor, scale: torch.Tensor,
                     ty: torch.Tensor, tx: torch.Tensor) -> torch.Tensor:
    """``[B, C, H, W]`` float32 planes resampled on their own grid by each
    image's ``scale`` and translation ``(ty, tx)`` in pixels: the two
    axes' weight matrices applied as float32 products."""
    h, w = planes.shape[2:]
    wy = _resample_weights(h, h, scale, ty)                  # [B, H, H']
    wx = _resample_weights(w, w, scale, tx)                  # [B, W, W']
    with _ieee_float32_matmul():
        rows = torch.matmul(wy.transpose(1, 2)[:, None], planes)
        return torch.matmul(rows, wx[:, None])


def scale_and_place(images: torch.Tensor, boxes: torch.Tensor,
                    scale: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor):
    """``[B, H, W, C]`` float32 images resampled by each image's ``[B]``
    scale with translation ``(tx, ty)`` px on the same canvas, and their
    ``[B, G, 4]`` boxes moved alike."""
    out = _scale_translate(images.permute(0, 3, 1, 2), scale, ty, tx)
    s, x0, y0 = scale.view(-1, 1), tx.view(-1, 1), ty.view(-1, 1)
    x1, y1, x2, y2 = boxes.unbind(-1)
    return (out.permute(0, 2, 3, 1).contiguous(),
            torch.stack([x1 * s + x0, y1 * s + y0, x2 * s + x0, y2 * s + y0],
                        -1))


def scale_and_place_masks(masks: torch.Tensor, scale: torch.Tensor,
                          tx: torch.Tensor, ty: torch.Tensor, image_h: int,
                          image_w: int) -> torch.Tensor:
    """The transform of :func:`scale_and_place` on ``[B, G, Hm, Wm]`` mask
    planes, the canvas at the mask stride: the translation, in image
    pixels, is converted to grid cells."""
    hm, wm = masks.shape[2:]
    return _scale_translate(masks, scale, ty * hm / image_h,
                            tx * wm / image_w)


def scale_and_place_keypoints(kps: torch.Tensor, scale: torch.Tensor,
                              tx: torch.Tensor, ty: torch.Tensor,
                              image_h: int, image_w: int) -> torch.Tensor:
    """The transform of :func:`scale_and_place` on ``[B, G, K, 3]`` (x, y,
    v) keypoints; a point that leaves the canvas gets v = 0."""
    s, x0, y0 = (v.view(-1, 1, 1) for v in (scale, tx, ty))
    x = kps[..., 0] * s + x0
    y = kps[..., 1] * s + y0
    inside = (x >= 0) & (x < image_w) & (y >= 0) & (y < image_h)
    return torch.stack([x, y, kps[..., 2] * inside.to(kps.dtype)], -1)


def scale_jitter(images: torch.Tensor, boxes: torch.Tensor,
                 scale: torch.Tensor, masks=None, keypoints=None):
    """Large-scale jitter: each image of ``[B, H, W, C]`` resampled by its
    ``[B]`` scale on the fixed canvas, anchored at the top-left corner;
    boxes (clipped to the canvas), ``[B, G, Hm, Wm]`` masks and ``[B, G, K,
    3]`` keypoints follow.  Returns ``(images, boxes, masks,
    keypoints)``."""
    h, w = images.shape[1], images.shape[2]
    zero = torch.zeros_like(scale)
    images, boxes = scale_and_place(images, boxes, scale, zero, zero)
    x1, y1, x2, y2 = boxes.unbind(-1)
    boxes = torch.stack([x1.clamp(0, w), y1.clamp(0, h), x2.clamp(0, w),
                         y2.clamp(0, h)], -1)
    if masks is not None:
        masks = scale_and_place_masks(masks, scale, zero, zero, h, w)
    if keypoints is not None:
        keypoints = scale_and_place_keypoints(keypoints, scale, zero, zero,
                                              h, w)
    return images, boxes, masks, keypoints


class ZoomDraws(NamedTuple):
    """Per image ``[B]``: zoom out where ``apply < 0.5``, by the side
    ratio ``ratio`` in [1, 4), placed at ``(x, y)`` fractions in [0, 1) of
    the free canvas."""
    apply: torch.Tensor
    ratio: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor


def draw_zoom(generator: torch.Generator, batch: int) -> ZoomDraws:
    dev = generator.device

    def u():
        return torch.rand(batch, generator=generator, device=dev)

    return ZoomDraws(apply=u(), ratio=1.0 + u() * 3.0, x=u(), y=u())


def zoom_out(images: torch.Tensor, boxes: torch.Tensor, ratio: torch.Tensor,
             x: torch.Tensor, y: torch.Tensor, masks=None, keypoints=None):
    """Random zoom-out: each image of ``[B, H, W, C]`` shrunk by ``1 /
    ratio`` and placed at ``x * (W - W / ratio)``, ``y * (H - H / ratio)``
    on a zero canvas; boxes, ``[B, G, Hm, Wm]`` masks and ``[B, G, K, 3]``
    keypoints follow (boxes are not clipped).  Returns ``(images, boxes,
    masks, keypoints)``."""
    h, w = images.shape[1], images.shape[2]
    s = 1.0 / ratio
    tx = x * (w - w * s)
    ty = y * (h - h * s)
    images, boxes = scale_and_place(images, boxes, s, tx, ty)
    if masks is not None:
        masks = scale_and_place_masks(masks, s, tx, ty, h, w)
    if keypoints is not None:
        keypoints = scale_and_place_keypoints(keypoints, s, tx, ty, h, w)
    return images, boxes, masks, keypoints


# The IoU floors of RandomIoUCrop; -1 draws "no crop".
CROP_MIN_IOUS = (0.0, 0.1, 0.3, 0.5, 0.7, 0.9, -1.0)
CROP_TRIALS = 20


class CropDraws(NamedTuple):
    """Per image: the index ``[B]`` (int64) of the IoU floor in
    ``CROP_MIN_IOUS``, and per trial ``[B, T]`` the crop's width and
    height fractions in [0.3, 1) and its origin's fractions in [0, 1) of
    the free canvas."""
    option: torch.Tensor
    w: torch.Tensor
    h: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor


def draw_crop(generator: torch.Generator, batch: int,
              trials: int = CROP_TRIALS) -> CropDraws:
    dev = generator.device

    def u(lo=0.0, hi=1.0):
        x = torch.rand((batch, trials), generator=generator, device=dev)
        return lo + x * (hi - lo)

    option = torch.randint(len(CROP_MIN_IOUS), (batch,), generator=generator,
                           device=dev)
    return CropDraws(option=option, w=u(0.3, 1.0), h=u(0.3, 1.0), x=u(),
                     y=u())


def iou_crop(images: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
             draws: CropDraws, masks=None, keypoints=None):
    """SSD's IoU-constrained random crop, per image: of the ``T`` drawn
    crops, the first whose aspect ratio lies in [0.5, 2], which holds a
    valid box's centre and whose best IoU with a valid box reaches the
    drawn floor is resampled onto the canvas; boxes (clipped), masks and
    keypoints follow, and boxes whose centres fall outside it become
    invalid.  With no such crop, or the floor -1, the image stays (an
    identity resample).  Every decision stays on the device.  Returns
    ``(images, boxes, valid, masks, keypoints)``."""
    hh, ww = images.shape[1], images.shape[2]
    h, w = float(hh), float(ww)
    min_iou = torch.full(draws.option.shape, CROP_MIN_IOUS[-1],
                         dtype=torch.float32, device=images.device)
    for i, v in enumerate(CROP_MIN_IOUS[:-1]):
        min_iou = torch.where(draws.option == i, v, min_iou)
    cw = draws.w * w
    ch = draws.h * h
    ar = cw / ch
    ar_ok = (ar >= 0.5) & (ar <= 2.0)
    cx = draws.x * (w - cw)
    cy = draws.y * (h - ch)
    crops = torch.stack([cx, cy, cx + cw, cy + ch], -1)       # [B, T, 4]
    ious = torch.where(valid[:, None, :], box_iou(crops, boxes),
                       torch.full((), -1.0, device=images.device))
    centre_x = (boxes[..., 0] + boxes[..., 2]) / 2
    centre_y = (boxes[..., 1] + boxes[..., 3]) / 2
    inside = ((centre_x[:, None, :] >= crops[..., 0:1])
              & (centre_x[:, None, :] < crops[..., 2:3])
              & (centre_y[:, None, :] >= crops[..., 1:2])
              & (centre_y[:, None, :] < crops[..., 3:4])
              & valid[:, None, :])                             # [B, T, G]
    ok = ar_ok & inside.any(2) & (ious.amax(2) >= min_iou[:, None])
    first = torch.argmax(ok.to(torch.uint8), 1)                # [B]
    do_crop = ok.any(1) & (min_iou >= 0.0)
    crop = torch.gather(crops, 1, first[:, None, None].expand(-1, 1, 4))[:, 0]
    one = torch.ones((), device=images.device)
    scale = torch.where(do_crop, torch.minimum(h / (crop[:, 3] - crop[:, 1]),
                                               w / (crop[:, 2] - crop[:, 0])),
                        one)
    tx = torch.where(do_crop, -crop[:, 0] * scale, one - 1.0)
    ty = torch.where(do_crop, -crop[:, 1] * scale, one - 1.0)
    images, boxes = scale_and_place(images, boxes, scale, tx, ty)
    x1, y1, x2, y2 = boxes.unbind(-1)
    boxes = torch.stack([x1.clamp(0, w), y1.clamp(0, h), x2.clamp(0, w),
                         y2.clamp(0, h)], -1)
    first_inside = torch.gather(
        inside, 1, first[:, None, None].expand(-1, 1, inside.shape[2]))[:, 0]
    keep = torch.where(do_crop[:, None], first_inside, valid)
    if masks is not None:
        masks = scale_and_place_masks(masks, scale, tx, ty, hh, ww)
    if keypoints is not None:
        keypoints = scale_and_place_keypoints(keypoints, scale, tx, ty, hh,
                                              ww)
    return images, boxes, keep & valid, masks, keypoints
