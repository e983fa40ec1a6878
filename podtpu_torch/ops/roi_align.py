"""Multi-level RoIAlign over FPN levels, forward and backward.

Counterpart of ``podtpu/ops/roi_align.py`` (the semantics) and of the
Pallas kernels ``podtpu/ops/pallas/roi_align_kernel.py::_fwd_kernel`` and
``_bwd_kernel`` (the hot path).  Each RoI is assigned an FPN level with
torchvision's ``LevelMapper`` rule plus the JAX package's long-side bump
(:func:`assign_levels`); each of ``out * out`` bins averages ``ratio**2``
bilinear samples with torchvision's aligned=False edge rules.

:func:`batched_roi_align` runs :func:`batched_roi_align_plain`, a
plain-torch transcription that autograd differentiates, on CPU tensors.  On
CUDA tensors it launches the hand-written forward kernel
(``csrc/roi_align.cu``); when a level requires grad it does so inside an
autograd function whose backward launches the backward kernel
(:func:`batched_roi_align_backward`).  Boxes get no gradient.  The pooled
tensor is ``[B, K, out, out, C]``, the JAX package's order, or with
``channels_first=True`` ``[B, K, C, out, out]``, the order torchvision's
box head flattens; both kernels write and read either order directly.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from podtpu_torch.ops import _build

KERNEL = "roi_align_fwd"
KERNEL_BWD = "roi_align_bwd"
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
                            roi_chunk: int = 256,
                            channels_first: bool = False) -> torch.Tensor:
    """Plain-torch multi-level RoIAlign: ``[B, Hl, Wl, C]`` levels and
    ``[B, K, 4]`` boxes -> ``[B, K, out, out, C]`` (``[B, K, C, out, out]``
    with ``channels_first``) in the levels' dtype, computed in float32.
    RoIs are pooled ``roi_chunk`` at a time to bound the gathers."""
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
    pooled = torch.stack(out).to(features[0].dtype)
    if channels_first:
        pooled = pooled.permute(0, 1, 4, 2, 3).contiguous()
    return pooled


class _LevelTable(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p * MAX_LEVELS),
                ("height", ctypes.c_int * MAX_LEVELS),
                ("width", ctypes.c_int * MAX_LEVELS),
                ("scale", ctypes.c_float * MAX_LEVELS)]


_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# What the kernels take on the card (csrc/roi_align.cu): channels in whole
# 16-byte vectors of either dtype, the instantiated output sizes, the
# per-axis sample tables' length, 16-byte loads, the backward kernel's
# 13-bit cell coordinates.
CHANNEL_MULTIPLE = 8
KERNEL_OUTPUT_SIZES = (7, 14)
MAX_SAMPLES_PER_AXIS = 64
ALIGNMENT = 16
MAX_LEVEL_SIDE = 8191


def pooled_shape(b: int, k: int, c: int, output_size: int,
                 channels_first: bool):
    if channels_first:
        return (b, k, c, output_size, output_size)
    return (b, k, output_size, output_size, c)


def _check_inputs(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                  strides: Sequence[int], output_size: int,
                  sampling_ratio: int) -> None:
    """Raise, naming the argument, on what the kernels do not take."""
    n_lvl = len(features)
    if not 1 <= n_lvl <= MAX_LEVELS or len(strides) != n_lvl:
        raise ValueError(f"features/strides: need 1..{MAX_LEVELS} levels "
                         f"with one stride each, got {n_lvl} levels and "
                         f"{len(strides)} strides")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or boxes.dtype != torch.float32:
        raise ValueError("boxes must be a [B, K, 4] float32 tensor, got "
                         f"{tuple(boxes.shape)} {boxes.dtype}")
    b = boxes.shape[0]
    c = features[0].shape[-1]
    dtype = features[0].dtype
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"features must be float32 or bfloat16, got {dtype}")
    if c % CHANNEL_MULTIPLE:
        raise ValueError(f"features: the channel count must be a multiple "
                         f"of {CHANNEL_MULTIPLE} on a CUDA device, got {c}")
    for i, f in enumerate(features):
        if (f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c
                or f.dtype != dtype or f.device != boxes.device):
            raise ValueError(f"features[{i}]: expected [{b}, H, W, {c}] "
                             f"{dtype} on {boxes.device}, got "
                             f"{tuple(f.shape)} {f.dtype} on {f.device}")
        if not f.is_contiguous():
            raise ValueError(f"features[{i}] must be contiguous NHWC")
        if max(f.shape[1], f.shape[2]) > MAX_LEVEL_SIDE:
            raise ValueError(f"features[{i}]: at most {MAX_LEVEL_SIDE} cells "
                             f"a side, got {tuple(f.shape[1:3])}")
        if f.data_ptr() % ALIGNMENT:
            raise ValueError(f"features[{i}] must be {ALIGNMENT}-byte "
                             "aligned (a view at an odd offset is not)")
    if output_size not in KERNEL_OUTPUT_SIZES:
        raise ValueError(f"output_size must be one of {KERNEL_OUTPUT_SIZES} "
                         f"on a CUDA device, got {output_size}")
    if sampling_ratio < 1 \
            or output_size * sampling_ratio > MAX_SAMPLES_PER_AXIS:
        raise ValueError("sampling_ratio must be positive with output_size "
                         f"* sampling_ratio <= {MAX_SAMPLES_PER_AXIS}, got "
                         f"{sampling_ratio}")


def _level_table(levels: Sequence[torch.Tensor],
                 strides: Sequence[int]) -> _LevelTable:
    table = _LevelTable()
    for i, f in enumerate(levels):
        table.data[i] = f.data_ptr()
        table.height[i] = f.shape[1]
        table.width[i] = f.shape[2]
        table.scale[i] = 1.0 / float(strides[i])
    return table


def _check_status(lib, status: int, what: str) -> None:
    """Raise on a refusal of an entry point (negative, named by the
    library) or a CUDA error."""
    if status < 0:
        raise ValueError(f"{what} refused its arguments: "
                         f"{lib.podtpu_roi_align_refusal(status).decode()}")
    _build.check(status, what)


def _assign_levels_kernel(boxes, num_levels, canonical_scale, canonical_level,
                          min_level, base_stride, eps=1e-6,
                          max_span_cells=30.0):
    """:func:`assign_levels` of contiguous CUDA ``[B, K, 4]`` float32 boxes
    in one launch (``csrc/roi_align.cu::roi_level_kernel`` repeats PyTorch's
    CUDA arithmetic operation for operation)."""
    level = torch.empty(boxes.shape[:-1], dtype=torch.int32,
                        device=boxes.device)
    lib = _build.library()
    with torch.cuda.device(boxes.device):
        status = lib.podtpu_roi_levels(
            boxes.data_ptr(), level.data_ptr(), level.numel(), num_levels,
            canonical_scale, canonical_level, min_level, eps,
            max_span_cells * base_stride,
            torch.cuda.current_stream().cuda_stream)
    _check_status(lib, status, "roi level kernel")
    return level


def _forward_kernel(features, boxes, level, strides, output_size,
                    sampling_ratio, channels_first):
    b, k = boxes.shape[:2]
    c = features[0].shape[-1]
    dtype = features[0].dtype
    out = torch.empty(pooled_shape(b, k, c, output_size, channels_first),
                      dtype=dtype, device=boxes.device)
    if b * k == 0:
        return out
    table = _level_table(features, strides)
    lib = _build.library()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.podtpu_roi_align_fwd(
            ctypes.addressof(table), len(features), boxes.data_ptr(),
            level.data_ptr(), out.data_ptr(), b * k, k, c, output_size,
            sampling_ratio, _KERNEL_DTYPES[dtype], int(channels_first),
            stream)
    _check_status(lib, status, "roi_align forward kernel")
    _build.count_launch(KERNEL)
    return out


def _backward_kernel(grad_out, shapes, dtype, boxes, level, strides,
                     output_size, sampling_ratio, channels_first):
    """Level gradients ``[B, Hl, Wl, C]`` in ``dtype``.  The kernel writes
    every cell once, so the buffers start uninitialised.  Its scratch is
    each RoI's sample table and cell rectangle (232 bytes a RoI at output
    size 7, ratio 2) and the float32 partial tiles of the coarse levels
    whose tiles it splits over several blocks."""
    b, k = boxes.shape[:2]
    c = shapes[0][-1]
    dev = boxes.device
    if b * k == 0:
        return [torch.zeros(s, dtype=dtype, device=dev) for s in shapes]
    grads = [torch.empty(s, dtype=dtype, device=dev) for s in shapes]
    table = _level_table(grads, strides)
    lib = _build.library()
    nbytes = lib.podtpu_roi_align_bwd_scratch_bytes(
        ctypes.addressof(table), len(grads), b * k, k, c, output_size,
        sampling_ratio)
    _check_status(lib, min(nbytes, 0), "roi_align backward kernel")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    g = grad_out.to(dtype).contiguous()
    if g.data_ptr() % ALIGNMENT:
        g = g.clone()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.podtpu_roi_align_bwd(
            ctypes.addressof(table), len(grads), boxes.data_ptr(),
            level.data_ptr(), scratch.data_ptr(), g.data_ptr(), b * k, k, c,
            output_size, sampling_ratio, _KERNEL_DTYPES[dtype],
            int(channels_first), stream)
    _check_status(lib, status, "roi_align backward kernel")
    _build.count_launch(KERNEL_BWD)
    return grads


class _RoIAlignFunction(torch.autograd.Function):
    """Forward kernel K2 and backward kernel K3 as one differentiable op
    over ``(boxes, level, *features)``; only the features get gradients."""

    @staticmethod
    def forward(ctx, boxes, level, strides, output_size, sampling_ratio,
                channels_first, *features):
        ctx.save_for_backward(boxes, level)
        ctx.meta = ([tuple(f.shape) for f in features], features[0].dtype,
                    strides, output_size, sampling_ratio, channels_first)
        return _forward_kernel(features, boxes, level, strides, output_size,
                               sampling_ratio, channels_first)

    @staticmethod
    def backward(ctx, grad_out):
        boxes, level = ctx.saved_tensors
        shapes, dtype, strides, output_size, ratio, channels_first = ctx.meta
        grads = _backward_kernel(grad_out, shapes, dtype, boxes, level,
                                 strides, output_size, ratio, channels_first)
        grads = [g if need else None
                 for g, need in zip(grads, ctx.needs_input_grad[6:])]
        return (None, None, None, None, None, None, *grads)


def batched_roi_align(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                      strides: Sequence[int], output_size: int = 7,
                      sampling_ratio: int = 2, canonical_scale: float = 224.0,
                      canonical_level: int = 4, min_level: int = 2,
                      channels_first: bool = False) -> torch.Tensor:
    """Multi-level RoIAlign of ``[B, K, 4]`` xyxy image-coordinate boxes over
    ``[B, Hl, Wl, C]`` contiguous (NHWC) levels -> ``[B, K, out, out, C]``
    or, with ``channels_first``, ``[B, K, C, out, out]`` (the order the box
    head flattens).

    CPU tensors take :func:`batched_roi_align_plain`; CUDA tensors launch the
    forward kernel (float32 or bfloat16 levels with a channel count that is
    a multiple of 8, float32 boxes, ``output_size`` 7 or 14) and, when a
    level requires grad, the backward kernel in the backward pass.
    """
    if boxes.device.type == "cpu":
        return batched_roi_align_plain(
            features, boxes, strides, output_size, sampling_ratio,
            canonical_scale, canonical_level, min_level,
            channels_first=channels_first)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    _check_inputs(features, boxes, strides, output_size, sampling_ratio)
    boxes = boxes.detach().contiguous()
    level = _assign_levels_kernel(boxes, len(features), canonical_scale,
                                  canonical_level, min_level,
                                  float(strides[0]))
    strides = tuple(int(s) for s in strides)
    if torch.is_grad_enabled() and any(f.requires_grad for f in features):
        return _RoIAlignFunction.apply(boxes, level, strides, output_size,
                                       sampling_ratio, channels_first,
                                       *features)
    return _forward_kernel(features, boxes, level, strides, output_size,
                           sampling_ratio, channels_first)


def batched_roi_align_backward_plain(
        grad_out: torch.Tensor, features: Sequence[torch.Tensor],
        boxes: torch.Tensor, strides: Sequence[int], output_size: int = 7,
        sampling_ratio: int = 2, canonical_scale: float = 224.0,
        canonical_level: int = 4, min_level: int = 2,
        channels_first: bool = False):
    """Level gradients of :func:`batched_roi_align_plain` for the upstream
    gradient ``grad_out [B, K, out, out, C]`` (``[B, K, C, out, out]`` with
    ``channels_first``), by autograd, computed in float32 and returned in
    the levels' dtype.  The map is linear in the features, so only their
    shapes matter."""
    zeros = [torch.zeros(f.shape, dtype=torch.float32, device=f.device,
                         requires_grad=True) for f in features]
    with torch.enable_grad():
        out = batched_roi_align_plain(zeros, boxes.detach(), strides,
                                      output_size, sampling_ratio,
                                      canonical_scale, canonical_level,
                                      min_level,
                                      channels_first=channels_first)
        grads = torch.autograd.grad(out, zeros, grad_out.float(),
                                    allow_unused=True)
    return [torch.zeros_like(z) if g is None else g.to(f.dtype)
            for g, z, f in zip(grads, zeros, features)]


def batched_roi_align_backward(
        grad_out: torch.Tensor, features: Sequence[torch.Tensor],
        boxes: torch.Tensor, strides: Sequence[int], output_size: int = 7,
        sampling_ratio: int = 2, canonical_scale: float = 224.0,
        canonical_level: int = 4, min_level: int = 2,
        channels_first: bool = False):
    """Level gradients ``[B, Hl, Wl, C]`` (in the levels' dtype) of
    :func:`batched_roi_align` for the upstream gradient ``grad_out``, laid
    out as that function's output.

    CPU tensors take :func:`batched_roi_align_backward_plain`; CUDA tensors
    launch the backward kernel, which gathers each tile of each level in
    float32 in a fixed order (two runs give the same bits) and writes it
    once in the levels' dtype.
    """
    if boxes.device.type == "cpu":
        return batched_roi_align_backward_plain(
            grad_out, features, boxes, strides, output_size, sampling_ratio,
            canonical_scale, canonical_level, min_level,
            channels_first=channels_first)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    _check_inputs(features, boxes, strides, output_size, sampling_ratio)
    b, k = boxes.shape[:2]
    c = features[0].shape[-1]
    want = pooled_shape(b, k, c, output_size, channels_first)
    if tuple(grad_out.shape) != want or grad_out.device != boxes.device:
        raise ValueError(f"grad_out must be {list(want)} on {boxes.device}, "
                         f"got {list(grad_out.shape)} on {grad_out.device}")
    boxes = boxes.detach().contiguous()
    level = _assign_levels_kernel(boxes, len(features), canonical_scale,
                                  canonical_level, min_level,
                                  float(strides[0]))
    return _backward_kernel(grad_out, [tuple(f.shape) for f in features],
                            features[0].dtype, boxes, level, strides,
                            output_size, sampling_ratio, channels_first)
