"""Build and load the port's CUDA kernels; count their launches.

Every ``podtpu_torch/csrc/*.cu`` source is compiled with ``nvcc`` for
``sm_90a`` (one ``nvcc -c`` per source, or per part of a source listed in
``PARTS``, all started together) and linked
into ``build/podtpu_torch/libpodtpu_torch_kernels.so`` at the repository
root, on first use.  The library exports plain C entry points that return a
``cudaError_t``; it is loaded with ``ctypes``.  A stamp file holds a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is not.

Nothing here runs when a module is imported: the CPU tests import every
module of the port on a machine with neither ``nvcc`` nor a GPU.

``launches`` counts kernel launches by kernel name.  Each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.  A CUDA graph capture calls the
wrappers but launches nothing, and a replay launches without calling them:
the graph's runner records what a capture counted
(:func:`captured_launches`) and adds it again on every replay
(:func:`add_launches`), so ``launches`` counts the launches the card ran.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "podtpu_torch"
LIB_NAME = "libpodtpu_torch_kernels.so"
# No --use_fast_math: the NMS keep mask must match its plain version bit for
# bit, which needs IEEE division, and RoIAlign's sample positions must equal
# the plain version's.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Sources compiled once per part, each with -D<macro>=<part>, so that the
# parts build in parallel.
PARTS = {"roi_align.cu": ("PODTPU_ROI_ALIGN_PART", (1, 2))}

launches: Dict[str, int] = collections.Counter()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    launches.clear()


def count_launch(name: str) -> None:
    launches[name] += 1


def add_launches(counts: Dict[str, int]) -> None:
    """Count ``counts`` more launches (a graph replay's)."""
    for name, n in counts.items():
        launches[name] += n


@contextlib.contextmanager
def captured_launches():
    """Hold apart what the wrappers count inside the block (a graph
    capture, which launches nothing): yields a dict that afterwards holds
    those counts by kernel name, and leaves ``launches`` as it was."""
    before = dict(launches)
    delta: Dict[str, int] = {}
    try:
        yield delta
    finally:
        for name in list(launches):
            n = launches[name] - before.get(name, 0)
            if n:
                delta[name] = n
                launches[name] -= n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def _sources_digest(sources) -> str:
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + repr(PARTS)).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the kernels if the library is missing or stale; returns its
    path.  The compiler's output (registers, spills) goes to
    ``build/podtpu_torch/nvcc.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "sources.sha256"
    digest = _sources_digest(sources)
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sources:
        macro, parts = PARTS.get(src.name, (None, (None,)))
        for part in parts:
            name = src.name if part is None else f"{src.name} part {part}"
            obj = BUILD_DIR / (src.stem + ("" if part is None
                                           else f".{part}") + ".o")
            define = [] if part is None else [f"-D{macro}={part}"]
            cmd = [nvcc, *NVCC_FLAGS, *define, "-c", str(src), "-o",
                   str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    log, failed = [], []
    for name, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {name} (exit {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    if not failed:
        tmp = BUILD_DIR / (LIB_NAME + ".tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(tmp), *[str(obj) for _, obj, _ in procs]]
        link = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (exit {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
        else:
            os.replace(tmp, lib)
            stamp.write_text(digest)
    (BUILD_DIR / "nvcc.log").write_text("\n".join(log))
    if failed:
        print("\n".join(log))
        raise RuntimeError(f"kernel build failed: {', '.join(failed)}")
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.podtpu_nms_keep.argtypes = [vp, vp, vp, vp, vp, i32, i32, f32, i32,
                                    vp]
    lib.podtpu_nms_keep.restype = i32
    lib.podtpu_nms_scratch_words.argtypes = [i32]
    lib.podtpu_nms_scratch_words.restype = ctypes.c_longlong
    lib.podtpu_roi_levels.argtypes = [vp, vp, i32, i32, f32, f32, f32, f32,
                                      f32, vp]
    lib.podtpu_roi_levels.restype = i32
    lib.podtpu_roi_align_fwd.argtypes = [vp, i32, vp, vp, vp, i32, i32, i32,
                                         i32, i32, i32, i32, vp]
    lib.podtpu_roi_align_fwd.restype = i32
    lib.podtpu_roi_align_bwd.argtypes = [vp, i32, vp, vp, vp, vp, i32, i32,
                                         i32, i32, i32, i32, i32, vp]
    lib.podtpu_roi_align_bwd.restype = i32
    lib.podtpu_roi_align_bwd_scratch_bytes.argtypes = [vp, i32, i32, i32,
                                                      i32, i32, i32]
    lib.podtpu_roi_align_bwd_scratch_bytes.restype = ctypes.c_longlong
    lib.podtpu_roi_align_refusal.argtypes = [i32]
    lib.podtpu_roi_align_refusal.restype = ctypes.c_char_p
    lib.podtpu_error_string.argtypes = [i32]
    lib.podtpu_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def check(status: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if status != 0:
        msg = library().podtpu_error_string(status).decode()
        raise RuntimeError(f"{what} failed: CUDA error {status} ({msg})")
