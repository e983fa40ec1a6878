"""Every family of the port's zoo through ``podtpu_torch/infer/export.py``
on the CPU.

For each model class (Faster R-CNN with a mask head and with a keypoint
head, the v2 recipe, RetinaNet, FCOS, the MobileNetV3-Large FPN trunk,
SSD300, SSDLite320) a seeded model directory at
``tests/conftest.py::tiny_config`` sizes (SSD on its smallest canvas, 268²,
SSDLite at 160²) is exported for the CPU at batch 2, saved, reloaded and
replayed: every output equals the eager model's bits on the same canvases,
and the program's graph names the kernels' operators as often as the eager
forward calls them: K1 (``podtpu::nms_keep``) twice and K2
(``podtpu::roi_align_fwd``) once for a two-stage model, one more K2 for a
mask or keypoint head, K1 once for a one-stage model or SSD.  A one-stage
model's scores are lifted over its thresholds (random heads score every
class near the prior 0.01).
"""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from podtpu_torch.core import config
from podtpu_torch.infer import export
from podtpu_torch.models.detector import init_parameters, make_detector
from podtpu_torch.train.checkpoints import save_model
from tests.conftest import tiny_config
from tests.test_torch_mask import torch_threads  # noqa: F401

TINY = {k: v for k, v in dataclasses.asdict(tiny_config().model).items()
        if k in ("image_size", "rpn_pre_nms_topk_test",
                 "rpn_post_nms_topk_test", "detections_per_image",
                 "compute_dtype")}
MODELS = {
    "mask": lambda m: dataclasses.replace(m, with_mask=True),
    "keypoint": lambda m: dataclasses.replace(
        m, with_keypoints=True,
        keypoint_hflip_inds=config.COCO_17_HFLIP_INDS),
    "faster_v2": config.fasterrcnn_v2_config,
    "retinanet": config.retinanet_config,
    "fcos": config.fcos_config,
    "mobilenet_v3_fpn": config.mobilenet_v3_fpn_config,
    "ssd": lambda m: config.ssd_config(m, image_size=(268, 268)),
    "ssdlite": lambda m: config.ssdlite_config(m, image_size=(160, 160)),
}
TWO_STAGE_HEAD = ("mask", "keypoint")
ONE_STAGE = ("retinanet", "fcos")


def lift(net):
    """Scores spread around 0.5: class-logit bias 0, and behind RetinaNet's
    tower without GroupNorm the class kernel times 100; FCOS's distances
    get bias 1."""
    head = net.head
    with torch.no_grad():
        head.classification_head.cls_logits.bias.zero_()
        if not any(isinstance(m, torch.nn.GroupNorm)
                   for m in head.classification_head.modules()):
            head.classification_head.cls_logits.weight.mul_(100.0)
        if hasattr(head.regression_head, "bbox_ctrness"):
            head.regression_head.bbox_reg.bias.fill_(1.0)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_exported_program_equals_eager(model, tmp_path):
    cfg = MODELS[model](config.ModelConfig(**TINY, num_classes=3))
    net = make_detector(cfg)
    init_parameters(net, torch.Generator().manual_seed(0))
    if model in ONE_STAGE:
        lift(net)
    model_dir = str(tmp_path / "model")
    save_model(model_dir, net, cfg, ["a", "b"])
    net = net.to(memory_format=torch.channels_last).eval()
    try:
        path = export.export_model(model_dir, batch_size=2,
                                   platforms=("cpu",))
        loaded = export.ExportedModel(path, "cpu")
        images = np.random.default_rng(4).integers(
            0, 256, (2,) + cfg.image_size + (3,), dtype=np.uint8)
        got = loaded(images)
        with torch.inference_mode():
            out = net(torch.from_numpy(images))
        det, extra = (out, None) if model not in TWO_STAGE_HEAD else out
        want = {"boxes": det.boxes, "scores": det.scores,
                "labels": det.labels, "valid": det.valid}
        if model == "mask":
            want["masks"] = extra
        if model == "keypoint":
            want["keypoints"] = extra.keypoints
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
        assert got["valid"].any()
        ops = sorted(str(n.target) for n in loaded.module.graph.nodes
                     if str(n.target).startswith("podtpu."))
        k1 = 1 if model in ONE_STAGE + ("ssd", "ssdlite") else 2
        k2 = 0 if k1 == 1 else 2 if model in TWO_STAGE_HEAD else 1
        assert ops == (["podtpu.nms_keep.default"] * k1
                       + ["podtpu.roi_align_fwd.default"] * k2)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
