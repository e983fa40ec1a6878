"""FCOS in podtpu_torch against podtpu (CPU).

As ``tests/test_torch_retinanet.py``, whose helpers this file uses, for
``fcos_config`` at ``tests/conftest.py::tiny_config`` sizes (128x128,
float32, 4 classes).  The eval tests lift the scores the same way
(``cls_logits`` bias 0; ``sqrt(sigmoid(cls) * sigmoid(ctrness))`` then
sits near 0.5, over FCOS's 0.2) and the distances' bias to 1.  Held
here:

* ``fcos_match`` exactly: centre sampling, the per-level scale ranges, the
  smallest-area tie-break in float32, invalid gts, an image without gt;
  the level constants;
* the pyramid, the GroupNorm towers, the ReLU'd distances and the
  centre-ness logits on JAX's pyramid; the eval forward (valid slots and
  labels equal, boxes 1e-3, scores 1e-4, at least half the slots valid)
  and its single class-offset NMS an image;
* one train step with ``image_weight``: the three losses to rtol 1e-5,
  gradients to 2e-3 of each tensor's largest, parameters to 1e-6;
* the bridge against ``fcos_key_map``, ``load_pretrained`` of a synthetic
  torchvision ``fcos_resnet50_fpn`` checkpoint (and one with another
  class count) against JAX's;
* ``train(family="fcos")`` for one epoch, then ``infer``,
  ``evaluate_model`` and ``DetectionServer`` on a JAX-saved model
  directory against JAX's.
"""
import copy
import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from podtpu.core.config import fcos_config as jax_fcos_config
from podtpu.infer import inference as jax_inference
from podtpu.models import fcos as jax_fcos
from podtpu.models import weights as jax_weights
from podtpu.train import checkpoints as jax_ckpt
from podtpu.train import train as jax_train
from podtpu_torch.core.config import (config_from_dict,
                                      model_config_from_dict)
from podtpu_torch.infer import inference
from podtpu_torch.infer.server import DetectionServer
from podtpu_torch.models import fcos, retinanet
from podtpu_torch.models.weights import (flax_from_state_dict, key_map,
                                         load_pretrained,
                                         state_dict_from_flax)
from podtpu_torch.ops.anchors import grid_anchors
from podtpu_torch.train import train as port_train
from tests.conftest import tiny_config
from tests.synthetic import make_project
from tests.test_torch_data import port_project
from tests.test_torch_infer import assert_same_annotations
from tests.test_torch_mask import torch_threads  # noqa: F401
from tests.test_torch_retinanet import (B, LABELS, cached_eval_step,
                                        check_detections, check_single_nms,
                                        check_train_step, close_to_largest,
                                        eval_outputs, images, lift, nchw,
                                        port_model, setup_family, t,
                                        torchvision_state_dict, train_step)
from tests.test_torch_retinanet import one_jax_eval_step  # noqa: F401

PRESETS = {"fcos": jax_fcos_config}


def fcos_lift(variables):
    """``lift``, and the distances' bias at 1 (boxes about two strides
    wide), as a trained model's."""
    v = lift(variables)
    head = v["params"]["head"]
    head["box_deltas"]["bias"] = np.ones_like(head["box_deltas"]["bias"])
    return v


@pytest.fixture(scope="module")
def family():
    fam = setup_family("fcos", PRESETS, fcos_lift)
    fam.update(eval_outputs(fam, images(3)))
    return fam


# -- matching ------------------------------------------------------------------

def level_tensors(cfg):
    grids = grid_anchors(tuple(cfg.image_size), tuple(cfg.strides),
                         tuple(cfg.anchor_sizes), tuple(cfg.anchor_ratios))
    return grids, fcos.level_constants(cfg, grids)


def match_cases(rng):
    """``[4, 12, 4]`` gt boxes: random sizes over the levels' ranges, two
    nested boxes sharing a centre (ties by area), two boxes of equal area
    (ties by index), an invalid slot over a valid one, an image without
    gt."""
    n = 12
    xy = rng.uniform(0, 100, (4, n, 2))
    wh = np.exp(rng.uniform(np.log(4), np.log(128), (4, n, 2)))
    boxes = np.concatenate([xy, np.minimum(xy + wh, 128)], -1)
    boxes[0, 1] = [30, 30, 70, 70]
    boxes[0, 2] = [40, 40, 60, 60]          # inside box 1, same centre
    boxes[1, 3] = [10, 10, 50, 30]
    boxes[1, 4] = [20, 0, 40, 40]           # same area and centre as 3
    valid = rng.uniform(size=(4, n)) > 0.2
    valid[0, :3] = valid[1, 3:5] = True
    valid[2, 5] = False
    boxes[2, 5] = boxes[2, 6]
    valid[3] = False
    return boxes.astype(np.float32), valid


def test_fcos_match(family):
    mcfg = family["cfg"].model
    grids, (sizes, lower, upper) = level_tensors(mcfg)
    jsizes, jlower, jupper = jax_fcos.FCOS(
        cfg=family["jcfg"].model)._level_constants()
    for mine, theirs in ((sizes, jsizes), (lower, jlower), (upper, jupper)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    anchors = np.concatenate(grids)
    boxes, valid = match_cases(np.random.default_rng(4))
    got = fcos.fcos_match(t(anchors), sizes, lower, upper, t(boxes),
                          t(valid), mcfg.fcos_center_radius)
    for i in range(len(boxes)):
        want = jax_fcos.fcos_match(
            jnp.asarray(anchors), jsizes, jlower, jupper,
            jnp.asarray(boxes[i]), jnp.asarray(valid[i]),
            mcfg.fcos_center_radius)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    got = got.numpy()
    assert (got[3] == -1).all()                    # no gt
    assert not (got[2] == 5).any()                 # the invalid slot
    assert (got[0] == 2).any() and (got[0] == 1).any()
    hit = got[1][np.isin(got[1], (3, 4))]
    assert len(hit) and (hit == 3).all()            # equal areas: first
    assert (got >= 0).sum() > 20


# -- pyramid, heads, eval forward -------------------------------------------

def test_pyramid(family):
    with torch.inference_mode():
        got = family["model"].features(t(images(3)))
    for i, (g, w) in enumerate(zip(got, family["pyramid"])):
        close_to_largest(g.permute(0, 2, 3, 1).numpy(), w, 1e-5, f"P{i + 3}")
    assert family["model"].backbone.fpn.extra_blocks.p6.in_channels == 256


def test_heads(family):
    head = family["model"].head
    with torch.inference_mode():
        got = head([nchw(p) for p in family["pyramid"]])
    for part, (g_lv, w_lv) in enumerate(zip(got, family["head"])):
        for g, w in zip(g_lv, w_lv):
            assert tuple(g.shape) == w.shape
            close_to_largest(g.numpy(), w, 1e-5, f"output {part}")
            if part == 1:
                assert (g >= 0).all()
    tower = head.classification_head.conv
    assert isinstance(tower[1], retinanet.GroupNorm)
    assert tower[0].bias is not None and len(tower) == 12


def test_eval_forward(family):
    check_detections(family["got"], family["want"])
    assert family["got"].boxes.shape == (B, 100, 4)


def test_single_class_offset_nms(family):
    s, n = check_single_nms(family, retinanet, images(3))[:2]
    # FCOS at 128^2: 16^2, 8^2, 4^2, 2^2 and 1 locations, 3 classes each.
    assert (s, n) == (B, 3 * (256 + 64 + 16 + 4 + 1))


# -- one train step -------------------------------------------------------------

def test_train_step(family):
    one = train_step(family)
    checked = check_train_step(
        family, one, ("classification", "bbox_regression", "bbox_ctrness"))
    grads = {n for n, p in one["model"].named_parameters()
             if p.grad is not None}
    for name in ("head.regression_head.bbox_ctrness.weight",
                 "head.regression_head.conv.1.weight",
                 "head.classification_head.conv.10.bias"):
        assert name in grads, name
    assert checked > 60


# -- the weight bridge -------------------------------------------------------

def test_bridge_keys(family):
    sd = family["model"].state_dict()
    jmap = jax_weights.fcos_key_map()
    mine = key_map(family="fcos")
    assert {k for k, *_ in mine} == set(sd)
    for k, coll, path, _ in mine:
        assert jmap[k][:2] == (coll, path), k
    params, frozen = flax_from_state_dict(sd)
    for tree, want in ((params, family["variables"]["params"]),
                       (frozen, family["variables"]["frozen"])):
        leaves = dict(jax.tree_util.tree_leaves_with_path(want))
        got = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert set(got) == set(leaves)
        for k, x in leaves.items():
            np.testing.assert_array_equal(got[k], x)


@pytest.mark.parametrize("classes", [4, 91])
def test_load_pretrained_torchvision(family, tmp_path, capsys, classes):
    path = str(tmp_path / "fcos.pth")
    torch.save(torchvision_state_dict(family, "nested", classes), path)
    v = family["variables"]
    want = jax_weights.load_pretrained(
        {"params": v["params"], "frozen": v["frozen"]}, path, verbose=False)
    model = port_model(family["cfg"].model, v)
    load_pretrained(model, path)
    assert "torchvision fcos layout" in capsys.readouterr().out
    want = state_dict_from_flax(jax.tree.map(np.asarray, want["params"]),
                                jax.tree.map(np.asarray, want["frozen"]))
    before = family["model"].state_dict()
    got = model.state_dict()
    changed = 0
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        changed += not np.array_equal(before[k].numpy(), w)
    assert changed > 250
    logits = "head.classification_head.cls_logits.weight"
    assert np.array_equal(got[logits].numpy(), before[logits].numpy()) \
        == (classes != 4)


# -- the driver, inference and serving --------------------------------------

def test_train_epoch_then_infer_evaluate_and_serve(family, tmp_path):
    """``train(family="fcos")`` for one epoch stores the FCOS preset; then
    a JAX-saved lifted FCOS directory through the port's ``infer``,
    ``evaluate_model`` and ``DetectionServer`` against JAX's."""
    jcfg = tiny_config()
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    project = make_project(str(tmp_path / "images"), num_images=5,
                           labels=LABELS, seed=1)
    trained = port_train.train(
        port_project(project), output_dir=str(tmp_path / "models"),
        name="fcos", batch_size=2, max_epochs=1, alrs_epochs=2,
        alrs_startup_factor=1, config=cfg, num_workers=2, seed=0,
        family="fcos", device="cpu")
    _, model, mcfg, _ = inference.load_inference_model(trained, device="cpu")
    assert mcfg == model_config_from_dict(dataclasses.asdict(
        jax_fcos_config(dataclasses.replace(
            jcfg.model, num_classes=mcfg.num_classes,
            trainable_backbone_stages=5))))
    assert "head.regression_head.bbox_ctrness.weight" in model.state_dict()

    model_dir = str(tmp_path / "jax_model")
    jax_ckpt.save_model(model_dir, family["variables"]["params"],
                        family["variables"]["frozen"], family["jcfg"].model,
                        LABELS)
    jax_ckpt.save_labels(model_dir, LABELS)
    jp = copy.deepcopy(project)
    for k in list(jp.image_dict)[2:]:
        jp.image_dict[k].boxes = []
    want = jax_inference.infer(jp, model_dir, threshold=0.55, batch_size=2,
                               num_workers=2)
    got = inference.infer(port_project(jp), model_dir, threshold=0.55,
                          batch_size=2, num_workers=2, device="cpu")
    assert assert_same_annotations(got, want) > 0
    np.testing.assert_allclose(
        port_train.evaluate_model(port_project(project), model_dir,
                                  batch_size=2, num_workers=2,
                                  device="cpu"),
        jax_train.evaluate_model(project, model_dir, batch_size=2,
                                 num_workers=2), rtol=0, atol=1e-3)
    server = DetectionServer(model_dir, batch_size=2, device="cpu")
    try:
        img = images(9, 1)[0]
        out = server.detect_array(img, 0.55)
    finally:
        server.close()
    v = family["variables"]
    det = cached_eval_step(family["jmodel"])(
        v["params"], v["frozen"], jnp.asarray(
            np.stack([img, np.zeros_like(img)])))
    keep = np.asarray(det.valid[0]) & (np.asarray(det.scores[0]) > 0.55)
    assert len(out["detections"]) == int(keep.sum()) > 0
    for d, box in zip(out["detections"], np.asarray(det.boxes[0])[keep]):
        np.testing.assert_allclose(d["box"], box, rtol=0, atol=1e-3)
    assert os.path.exists(os.path.join(trained, "results.txt"))
