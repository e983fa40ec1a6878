"""Where the port's entry points run: the GPU unless the caller asks for
another device.  Imports only torch, so that code which must not load the
model code (``infer/export.py::ExportedModel``) can use it."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the GPU and raises
    when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the "
                "CPU (plain versions of the kernels)")
        return torch.device("cuda")
    return torch.device(device)
