"""ctypes bindings to the native (C++) host library: image decode and the
COCO matcher.

Counterpart of ``podtpu/core/native.py``.  The source is the port's own copy,
``podtpu_torch/csrc/host/podtpu_native.cpp``, built at first use with ``g++``
and ``native/Makefile``'s flags into
``build/podtpu_torch/libpodtpu_torch_native.so`` at the repository root
(rebuilt when the source, the flags or the host CPU change: ``-march=native``
code built on one CPU may not run on another).  It exposes:

* :func:`decode_resize_batch`: threaded JPEG/PNG/TIFF decode + aspect-
  preserving resize (area filter down, bilinear up) into zero-padded uint8
  canvases;
* :func:`coco_match`: the COCO greedy matching inner loop.

Host code: nothing here touches the GPU.  If the library cannot be built or
loaded, or ``PODTPU_DISABLE_NATIVE`` is set, every function returns None and
the callers fall back to their Python paths, as the JAX package's do.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "host" \
    / "podtpu_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "podtpu_torch"
LIB_PATH = BUILD_DIR / "libpodtpu_torch_native.so"
LOG_PATH = BUILD_DIR / "native.log"
# native/Makefile's flags: without -march=native the bilinear resize is not
# contracted into FMAs and its bytes differ from the JAX package's library.
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native"]
LDLIBS = ["-ljpeg", "-lpng", "-ltiff", "-lpthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _host_cpu() -> str:
    """The CPU's model name and feature flags, which ``-march=native``
    compiles for."""
    try:
        with open("/proc/cpuinfo") as fp:
            lines = fp.read().split("\n\n")[0].splitlines()
    except OSError:
        return platform.processor()
    return "\n".join(ln for ln in lines
                     if ln.startswith(("model name", "flags")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS + LDLIBS).encode())
    h.update(_host_cpu().encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the library if it is missing or stale; returns its path.
    Raises ``RuntimeError`` with the compiler's output when it fails (also
    kept in ``build/podtpu_torch/native.log``).  Several processes may build
    at once: each writes its own temporary file and renames it into place,
    so none loads a half-written library."""
    stamp = BUILD_DIR / "native.sha256"
    digest = _digest()
    if LIB_PATH.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_PATH.name}.{os.getpid()}.tmp"
    cmd = ["g++", *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE),
           *LDLIBS]
    try:
        out = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        LOG_PATH.write_text(f"{' '.join(cmd)}\n{exc}\n")
        raise RuntimeError(f"native library build failed: {exc}") from exc
    LOG_PATH.write_text(f"{' '.join(cmd)}\n(exit {out.returncode})\n"
                        f"{out.stdout}")
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("native library build failed:\n" + out.stdout)
    os.replace(tmp, LIB_PATH)
    stamp_tmp = BUILD_DIR / f"native.sha256.{os.getpid()}.tmp"
    stamp_tmp.write_text(digest)
    os.replace(stamp_tmp, stamp)
    return LIB_PATH


def _declare(lib: ctypes.CDLL) -> None:
    lib.podtpu_decode_resize_batch_u8.restype = ctypes.c_int
    lib.podtpu_decode_resize_batch_u8.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    lib.podtpu_coco_match.restype = None
    lib.podtpu_coco_match.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
    ]


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None if it is disabled or cannot be
    built or loaded (tried once per process)."""
    global _lib, _tried
    if os.environ.get("PODTPU_DISABLE_NATIVE"):
        return None
    with _lock:
        if not _tried:
            _tried = True
            try:
                lib = ctypes.CDLL(str(build()))
            except (RuntimeError, OSError):
                return None
            _declare(lib)
            _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def decode_resize_batch(
    paths: List[str], canvas_hw: Tuple[int, int], num_threads: int = 4
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Decode ``paths`` into ``[N, H, W, 3]`` uint8 canvases.

    Returns (canvases, scales [N], orig_hw [N, 2]) or None if the native
    library is unavailable or ANY image failed to decode (the caller falls
    back).
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    ch, cw = canvas_hw
    canvases = np.zeros((n, ch, cw, 3), np.uint8)
    scales = np.zeros((n,), np.float32)
    orig_hw = np.zeros((n, 2), np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    failures = lib.podtpu_decode_resize_batch_u8(
        arr, n,
        canvases.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ch, cw,
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        orig_hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), num_threads)
    if failures:
        return None
    return canvases, scales, orig_hw


def coco_match(iou: np.ndarray, gt_ig: np.ndarray, det_area: np.ndarray,
               thrs: np.ndarray, area_range: Tuple[float, float]
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Greedy COCO matching; returns (dtm [T, D], dtig [T, D]) bool arrays
    or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    d, g = iou.shape
    t = len(thrs)
    iou = np.ascontiguousarray(iou, np.float64)
    gt_ig_u8 = np.ascontiguousarray(gt_ig, np.uint8)
    det_area = np.ascontiguousarray(det_area, np.float64)
    thrs = np.ascontiguousarray(thrs, np.float64)
    if gt_ig_u8.shape != (g,) or det_area.shape != (d,):
        raise ValueError(f"coco_match: iou {iou.shape}, gt_ig "
                         f"{gt_ig_u8.shape}, det_area {det_area.shape}")
    dtm = np.zeros((t, d), np.uint8)
    dtig = np.zeros((t, d), np.uint8)
    lib.podtpu_coco_match(
        iou.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        gt_ig_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        det_area.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        thrs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        d, g, t, float(area_range[0]), float(area_range[1]),
        dtm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        dtig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return dtm.astype(bool), dtig.astype(bool)
