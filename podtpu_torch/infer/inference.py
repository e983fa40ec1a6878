"""Model loading for inference.

Counterpart of ``podtpu/infer/inference.py::load_inference_model`` and
``podtpu/train/step.py::make_eval_step``/``split_eval_output``.  Entry
points run on the GPU unless the caller passes ``device="cpu"``; with no
GPU and no explicit device they raise rather than fall back to the CPU.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from podtpu_torch.models.detector import make_detector
from podtpu_torch.models.roi_heads import Detections
from podtpu_torch.models.weights import state_dict_from_flax
from podtpu_torch.train.checkpoints import load_model


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


def load_inference_model(model_dir: str, device=None
                         ) -> Tuple[Callable, torch.nn.Module, object, list]:
    """Load a saved model directory -> ``(forward, model, cfg, labels)``.

    ``forward(images)`` takes ``[B, H, W, 3]`` uint8 canvases (numpy or
    torch) and returns :class:`Detections` on the model's device.
    """
    dev = resolve_device(device)
    params, frozen, cfg, labels = load_model(model_dir)
    model = make_detector(cfg)
    sd = state_dict_from_flax(params, frozen, cfg.roi_pool_size)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model = model.to(dev).to(memory_format=torch.channels_last).eval()

    def forward(images) -> Detections:
        with torch.inference_mode():
            return model(torch.as_tensor(images).to(dev))

    return forward, model, cfg, labels


def split_eval_output(out: Detections) -> Tuple[
        Detections, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(Detections, masks, keypoints)`` of an eval forward.  The models
    ported so far have box heads only, so masks and keypoints are None."""
    return out, None, None
