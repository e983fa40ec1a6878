"""Model export: the eval forward as a self-contained ``torch.export``
program.

Counterpart of ``podtpu/infer/export.py``.  The artifact is a
``torch.export`` archive (``torch.export.save``; JAX's is serialized
StableHLO, and neither package reads the other's) holding the weights and
the whole eval forward (backbone, RPN, RoIAlign, NMS, postprocess) as one
graph.  The kernels appear in it as their registered operators
(``podtpu::nms_keep``, ``podtpu::roi_align_fwd``), so :class:`ExportedModel`
replays it without this package's model code: it imports only the modules
that register those operators, which launch the hand-written kernels on
the card and run their plain versions on the CPU.

One platform per artifact: ``cuda`` (the default, exported on the GPU) or
``cpu``, and the artifact runs on that device only.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# Imported for their operators, which a loaded program calls.
import podtpu_torch.ops.nms  # noqa: F401
import podtpu_torch.ops.roi_align  # noqa: F401
from podtpu_torch.core.device import resolve_device

EXPORT_NAME = "model.pt2"
META_NAME = "export.json"
PLATFORMS = ("cpu", "cuda")


class _EvalOutputs(torch.nn.Module):
    """A detector's eval forward as JAX's export returns it: uint8
    ``[B, H, W, 3]`` canvases -> ``boxes``, ``scores``, ``labels``,
    ``valid``, and ``masks`` or ``keypoints`` where the model has them."""

    def __init__(self, model: torch.nn.Module, split_eval_output):
        super().__init__()
        self.model = model
        self.split_eval_output = split_eval_output

    def forward(self, images: torch.Tensor):
        det, masks, kps = self.split_eval_output(self.model(images))
        outs = {"boxes": det.boxes, "scores": det.scores,
                "labels": det.labels, "valid": det.valid}
        if masks is not None:
            outs["masks"] = masks
        if kps is not None:
            outs["keypoints"] = kps
        return outs


def _platform(platforms: Optional[Sequence[str]]) -> str:
    if platforms is None:
        return "cuda"
    platforms = list(platforms)
    if len(platforms) != 1:
        raise ValueError(
            f"platforms: one platform per artifact, got {platforms} (a "
            "torch.export program holds one device's tensors)")
    if platforms[0] not in PLATFORMS:
        raise ValueError(f"platforms: {platforms[0]!r} is not one of "
                         f"{PLATFORMS}")
    return platforms[0]


def export_model(model_dir: str, batch_size: int = 1,
                 platforms: Optional[Sequence[str]] = None,
                 out_path: Optional[str] = None) -> str:
    """Export ``model_dir``'s eval forward; returns the artifact path.

    The exported program maps uint8 canvases ``[batch, H, W, 3]`` (the
    model's fixed ``image_size``) to a dict of ``boxes [B, D, 4]`` (xyxy,
    canvas coordinates), ``scores [B, D]``, ``labels [B, D]`` (1-based),
    ``valid [B, D]``, plus ``masks [B, D, M, M]`` or ``keypoints [B, D, K,
    3]`` for those heads.  ``platforms``: ``("cuda",)`` when None (raises
    without a GPU) or ``("cpu",)``.  ``export.json`` beside the artifact
    holds the labels, canvas, batch size, platform and output names.
    """
    from podtpu_torch.infer.inference import (build_inference_model,
                                              split_eval_output)
    from podtpu_torch.train.checkpoints import load_model

    platform = _platform(platforms)
    dev = resolve_device(None if platform == "cuda" else platform)
    params, frozen, cfg, labels = load_model(model_dir)
    _, model = build_inference_model(params, frozen, cfg, dev)
    h, w = cfg.image_size
    images = torch.zeros((batch_size, h, w, 3), dtype=torch.uint8,
                         device=dev)
    with torch.no_grad():
        program = torch.export.export(
            _EvalOutputs(model, split_eval_output), (images,), strict=False)

    out_path = out_path or os.path.join(model_dir, EXPORT_NAME)
    with warnings.catch_warnings():
        # channels_last weights are not "complete" tensors to the writer,
        # which then writes each one's whole storage: right on any device.
        warnings.filterwarnings("ignore", "No complete tensor found")
        torch.export.save(program, out_path)
    meta = {
        "labels": labels,
        "image_size": [h, w],
        "batch_size": batch_size,
        "platforms": [platform],
        "outputs": sorted(
            ["boxes", "scores", "labels", "valid"]
            + (["masks"] if cfg.with_mask else [])
            + (["keypoints"] if cfg.with_keypoints else [])),
    }
    with open(os.path.join(os.path.dirname(out_path), META_NAME), "w") as fp:
        json.dump(meta, fp, indent=1)
    return out_path


def _input_shape(program) -> Tuple[int, ...]:
    """Shape of the program's one user input, the canvases."""
    (name,) = program.graph_signature.user_inputs
    (node,) = [n for n in program.graph.nodes
               if n.op == "placeholder" and n.name == name]
    return tuple(int(d) for d in node.meta["val"].shape)


def _program_platform(program) -> str:
    """The device type of the program's weights."""
    tensors = list(program.state_dict.values()) \
        + [c for c in program.constants.values() if torch.is_tensor(c)]
    return tensors[0].device.type


class ExportedModel:
    """Load and call an exported artifact; no model code involved.

    ``device``: where it runs, the GPU when None (raises without one); it
    must be the platform the artifact was exported for.  Batch size and
    canvas come from the program's input; where ``export.json`` sits
    beside the artifact its shapes must agree, and its labels are kept
    (``labels`` is None for a bare artifact).  ``__call__`` accepts uint8
    images ``[B, H, W, 3]`` with the exported batch size and returns the
    output dict as numpy arrays.
    """

    def __init__(self, path: str, device=None):
        self.device = resolve_device(device)
        program = torch.export.load(path)
        platform = _program_platform(program)
        if platform != self.device.type:
            raise ValueError(f"{path} was exported for {platform}; it runs "
                             f"there only, not on {self.device}")
        shape = _input_shape(program)
        self.batch_size = shape[0]
        self.image_size: Tuple[int, int] = (shape[1], shape[2])
        self.labels = None
        meta_path = os.path.join(os.path.dirname(path), META_NAME)
        if os.path.exists(meta_path):
            with open(meta_path) as fp:
                meta = json.load(fp)
            if (int(meta["batch_size"]) != self.batch_size
                    or tuple(meta["image_size"]) != self.image_size):
                raise ValueError(
                    f"{meta_path}: batch size {meta['batch_size']} and "
                    f"canvas {meta['image_size']} disagree with {path}'s "
                    f"input {list(shape)}")
            self.labels = meta["labels"]
        self.module = program.module()

    def __call__(self, images: np.ndarray):
        images = np.asarray(images)
        if images.dtype != np.uint8:
            # A silent value-cast would truncate float [0,1] canvases
            # (valid on the live model) to all-zero uint8.
            raise TypeError(
                f"exported model takes uint8 canvases, got {images.dtype}; "
                "scale floats to [0, 255] and cast explicitly")
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        with torch.no_grad():
            out = self.module(x)
        return {k: v.cpu().numpy() for k, v in out.items()}
