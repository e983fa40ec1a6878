"""Multi-level RoIAlign forward over FPN levels.

Counterpart of ``podtpu/ops/roi_align.py`` (the semantics) and of the
Pallas kernel ``podtpu/ops/pallas/roi_align_kernel.py::_fwd_kernel`` (the
hot path).  Each RoI is assigned an FPN level with torchvision's
``LevelMapper`` rule plus the JAX package's long-side bump
(:func:`assign_levels`); each of ``out * out`` bins averages ``ratio**2``
bilinear samples with torchvision's aligned=False edge rules.

:func:`batched_roi_align` launches the hand-written kernel
(``csrc/roi_align.cu``) on CUDA tensors and runs
:func:`batched_roi_align_plain`, a plain-torch transcription that autograd
can differentiate, on CPU tensors.  The backward kernel is not ported yet.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from podtpu_torch.ops import _build

KERNEL = "roi_align_fwd"
MAX_LEVELS = 5


def assign_levels(boxes: torch.Tensor, num_levels: int,
                  canonical_scale: float = 224.0, canonical_level: int = 4,
                  min_level: int = 2, eps: float = 1e-6,
                  max_span_cells: float = 30.0,
                  base_stride: float = 4.0) -> torch.Tensor:
    """0-based FPN level of each ``[..., 4]`` box: ``floor(k0 +
    log2(sqrt(area) / s0))`` clamped to the level range, raised for a box
    whose long side would span more than ``max_span_cells`` cells at its
    level (``max_span_cells=None`` gives strict torchvision assignment)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    scale = torch.sqrt((w * h).clamp(min=0.0))
    lvl = torch.floor(canonical_level
                      + torch.log2(scale / canonical_scale + eps))
    if max_span_cells is not None:
        long_px = torch.maximum(w, h).clamp(min=eps)
        need = torch.ceil(torch.log2(
            long_px / (max_span_cells * base_stride) + eps))
        lvl = torch.maximum(lvl, min_level + need)
    lvl = lvl.clamp(min_level, min_level + num_levels - 1)
    return (lvl - min_level).to(torch.int32)


def _interp_axis(coord: torch.Tensor, size: torch.Tensor):
    """Bilinear neighbours, weights and inside flags along one axis."""
    sizef = size.to(coord.dtype)
    inside = (coord >= -1.0) & (coord <= sizef)
    c = torch.minimum(coord.clamp(min=0.0), sizef - 1.0)
    lo = torch.minimum(torch.floor(c), (sizef - 2.0).clamp(min=0.0))
    frac = c - lo
    lo_i = lo.long()
    hi_i = torch.minimum(lo_i + 1, size.long() - 1)
    return lo_i, hi_i, 1.0 - frac, frac, inside


def _roi_align_one_image(levels: Sequence[torch.Tensor], boxes: torch.Tensor,
                         level: torch.Tensor, strides: Sequence[int],
                         out: int, ratio: int) -> torch.Tensor:
    """``[K, out, out, C]`` for one image's ``[Hl, Wl, C]`` levels."""
    dev = boxes.device
    c = levels[0].shape[-1]
    flat = torch.cat([f.reshape(-1, c) for f in levels])
    sizes = [(f.shape[0], f.shape[1]) for f in levels]
    offsets, o = [], 0
    for hgt, wid in sizes:
        offsets.append(o)
        o += hgt * wid
    offset = torch.tensor(offsets, device=dev)[level.long()]
    height = torch.tensor([s[0] for s in sizes], device=dev)[level.long()]
    width = torch.tensor([s[1] for s in sizes], device=dev)[level.long()]
    scale = (1.0 / torch.tensor(strides, dtype=torch.float32,
                                device=dev))[level.long()]

    n = out * ratio
    k = torch.arange(n, dtype=torch.float32, device=dev)
    grid = torch.div(k, ratio, rounding_mode="floor") + (k % ratio + 0.5) / ratio
    x1 = boxes[:, 0] * scale
    y1 = boxes[:, 1] * scale
    roi_w = (boxes[:, 2] * scale - x1).clamp(min=1.0)
    roi_h = (boxes[:, 3] * scale - y1).clamp(min=1.0)
    ys = y1[:, None] + grid[None, :] * (roi_h / out)[:, None]   # [K, n]
    xs = x1[:, None] + grid[None, :] * (roi_w / out)[:, None]
    ylo, yhi, wy_lo, wy_hi, y_in = _interp_axis(ys, height[:, None])
    xlo, xhi, wx_lo, wx_hi, x_in = _interp_axis(xs, width[:, None])

    def gather(yi, xi):
        rows = (offset[:, None, None] + yi[:, :, None] * width[:, None, None]
                + xi[:, None, :])
        return flat[rows]                                          # [K, n, n, C]

    # float32 weights promote bf16 features to float32, as in JAX.
    wy_lo_, wy_hi_ = wy_lo[:, :, None, None], wy_hi[:, :, None, None]
    wx_lo_, wx_hi_ = wx_lo[:, None, :, None], wx_hi[:, None, :, None]
    val = (gather(ylo, xlo) * wy_lo_ * wx_lo_
           + gather(ylo, xhi) * wy_lo_ * wx_hi_
           + gather(yhi, xlo) * wy_hi_ * wx_lo_
           + gather(yhi, xhi) * wy_hi_ * wx_hi_)
    val = val * (y_in[:, :, None, None] & x_in[:, None, :, None])
    return val.reshape(-1, out, ratio, out, ratio, c).mean(dim=(2, 4))


def batched_roi_align_plain(features: Sequence[torch.Tensor],
                            boxes: torch.Tensor, strides: Sequence[int],
                            output_size: int = 7, sampling_ratio: int = 2,
                            canonical_scale: float = 224.0,
                            canonical_level: int = 4, min_level: int = 2,
                            roi_chunk: int = 256) -> torch.Tensor:
    """Plain-torch multi-level RoIAlign: ``[B, Hl, Wl, C]`` levels and
    ``[B, K, 4]`` boxes -> ``[B, K, out, out, C]`` in the levels' dtype,
    computed in float32.  RoIs are pooled ``roi_chunk`` at a time to bound
    the gathers."""
    level = assign_levels(boxes, len(strides), canonical_scale,
                          canonical_level, min_level,
                          base_stride=float(strides[0]))
    out = []
    for b in range(boxes.shape[0]):
        image_levels = [f[b] for f in features]
        parts = [
            _roi_align_one_image(image_levels, boxes[b, i:i + roi_chunk],
                                 level[b, i:i + roi_chunk], strides,
                                 output_size, sampling_ratio)
            for i in range(0, boxes.shape[1], roi_chunk)]
        out.append(torch.cat(parts))
    return torch.stack(out).to(features[0].dtype)


class _LevelTable(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p * MAX_LEVELS),
                ("height", ctypes.c_int * MAX_LEVELS),
                ("width", ctypes.c_int * MAX_LEVELS),
                ("scale", ctypes.c_float * MAX_LEVELS)]


_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def batched_roi_align(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                      strides: Sequence[int], output_size: int = 7,
                      sampling_ratio: int = 2, canonical_scale: float = 224.0,
                      canonical_level: int = 4,
                      min_level: int = 2) -> torch.Tensor:
    """Multi-level RoIAlign of ``[B, K, 4]`` xyxy image-coordinate boxes over
    ``[B, Hl, Wl, C]`` contiguous (NHWC) levels -> ``[B, K, out, out, C]``.

    CPU tensors take :func:`batched_roi_align_plain`; CUDA tensors launch the
    forward kernel (float32 or bfloat16 levels, float32 boxes).
    """
    if boxes.device.type == "cpu":
        return batched_roi_align_plain(
            features, boxes, strides, output_size, sampling_ratio,
            canonical_scale, canonical_level, min_level)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    if torch.is_grad_enabled() and (
            boxes.requires_grad or any(f.requires_grad for f in features)):
        raise NotImplementedError(
            "RoIAlign backward kernel (K3) comes with the training slice")
    n_lvl = len(features)
    if not 1 <= n_lvl <= MAX_LEVELS or len(strides) != n_lvl:
        raise ValueError(f"need 1..{MAX_LEVELS} levels with one stride each")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or boxes.dtype != torch.float32:
        raise ValueError("boxes must be a [B, K, 4] float32 tensor")
    b, k = boxes.shape[:2]
    c = features[0].shape[-1]
    dtype = features[0].dtype
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"levels must be float32 or bfloat16, got {dtype}")
    table = _LevelTable()
    for i, f in enumerate(features):
        if (f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c
                or f.dtype != dtype or f.device != boxes.device):
            raise ValueError(f"level {i}: expected [{b}, H, W, {c}] {dtype} "
                             f"on {boxes.device}, got {tuple(f.shape)} "
                             f"{f.dtype} on {f.device}")
        if not f.is_contiguous():
            raise ValueError(f"level {i} must be contiguous NHWC")
        table.data[i] = f.data_ptr()
        table.height[i] = f.shape[1]
        table.width[i] = f.shape[2]
        table.scale[i] = 1.0 / float(strides[i])
    if output_size * sampling_ratio > 64:
        raise ValueError("output_size * sampling_ratio must be <= 64")
    boxes = boxes.contiguous()
    level = assign_levels(boxes, n_lvl, canonical_scale, canonical_level,
                          min_level, base_stride=float(strides[0]))
    level = level.contiguous()
    out = torch.empty((b, k, output_size, output_size, c), dtype=dtype,
                      device=boxes.device)
    if b * k == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.podtpu_roi_align_fwd(
            ctypes.addressof(table), boxes.data_ptr(), level.data_ptr(),
            out.data_ptr(), b * k, k, c, output_size, sampling_ratio,
            _KERNEL_DTYPES[dtype], stream)
    _build.check(status, "roi_align forward kernel")
    _build.count_launch(KERNEL)
    return out
