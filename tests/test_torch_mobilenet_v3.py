"""The MobileNetV3-Large-FPN Faster R-CNN (and its 320 recipe) in
podtpu_torch against podtpu (CPU, ``tests/conftest.py::tiny_config``
sizes, float32, 4 classes).

* The weight bridge against ``fasterrcnn_mobilenet_v3_key_map``: the
  port's keys are the map's own spellings, which the JAX package's
  converter reads back exactly; a torchvision checkpoint in the nested
  spelling (``inner_blocks.i.0``, ``rpn.head.conv.0.0``) goes through
  ``load_pretrained`` into a frozen-norm and a trainable-norm model as the
  JAX package's ``load_pretrained`` reads it.
* The eval forward with trainable norms (their running averages):
  features 1e-5 of their largest, boxes 1e-3, scores 1e-4; the 320
  recipe's (a 320² canvas, 150 proposals, objectness floor 0.05) is held
  the same way on the model directories below.
* One training step with trainable norms, every unit training, teacher
  forced norm by norm as in ``tests/test_torch_mobilenet.py`` (its 46
  norms, the squeeze-excitation in float32): losses rtol 1e-5, gradients
  2e-3, parameters 1e-6, running statistics 1e-6; then the eval forward on
  the new state.  ``evaluate`` between two steps moves no running
  statistic; the resume checkpoint carries the statistics.
* ``needs_calibration`` and ``calibrate_frozen_stats`` on the frozen-norm
  trunk: both packages find its taps vanishing; in each of the 12 passes,
  from JAX's state before it, every norm's captured output mean and
  variance are within 1e-3 of their largest (the mean's scale at least
  the layer's largest standard deviation), as
  ``tests/test_torch_calibrate.py`` holds a pass, and the same layers
  overflow; the port's 12 passes end with taps that no longer vanish.
* ``train-object-detector --backbone mobilenet_v3_320_fpn`` through the
  port's CLI from scratch on the fake CVAT server: JAX's switch line to
  trainable BatchNorm, a 320x320 model directory with
  ``backbone_norm: "batch"`` whose trees JAX's ``load_inference_model``
  reads bit for bit as the port's model holds them (one epoch leaves its
  scores within 1e-4 of each other, so detections are compared on seeded
  weights), its trunk giving the port's features in float32; and a
  JAX-saved directory of that config in float32 served by the port's
  ``load_inference_model`` and ``DetectionServer`` as by JAX.
"""
import contextlib
import copy
import dataclasses
import io
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from podtpu.core.config import mobilenet_v3_fpn_config as jax_v3_config
from podtpu.infer import inference as jax_inference
from podtpu.models import weights as jax_weights
from podtpu.models.detector import make_detector as jax_make_detector
from podtpu.train import calibrate as jax_calibrate
from podtpu.train import checkpoints as jax_ckpt
import podtpu_torch.cli as port_cli
from podtpu_torch.data import imageio
from podtpu_torch.data.dataset import DetectionDataset, fit_resize
from podtpu_torch.data.loader import Loader
from podtpu_torch.infer import inference
from podtpu_torch.infer.server import DetectionServer
from podtpu_torch.models.resnet import BatchNorm2d, batch_statistics
from podtpu_torch.models.weights import (flax_from_state_dict, key_map,
                                         load_pretrained,
                                         state_dict_from_flax)
from podtpu_torch.train import calibrate
from podtpu_torch.train.evaluate import evaluate
from podtpu_torch.train.optim import make_optimizer
from podtpu_torch.train.step import make_train_step
from tests.synthetic import make_project
from tests.test_torch_cli import cvat_env, server_args  # noqa: F401
from tests.test_torch_data import port_project
from tests.test_torch_mask import torch_threads  # noqa: F401
from tests.test_torch_mobilenet import eval_steps  # noqa: F401
from tests.test_torch_mobilenet import (LR, as_batch_norm, check_eval,
                                        check_step, jax_config, make_batch,
                                        port_config, port_model, run_step,
                                        start_variables, t, tree_equal)


def v3(low_res=False):
    def mobile(mcfg):
        return jax_v3_config(mcfg, low_res=low_res, image_size=(128, 128))
    return mobile


@pytest.fixture(scope="module")
def frozen_vars():
    return start_variables(jax_config(v3()), 1)


@pytest.fixture(scope="module")
def batch_cfg():
    return jax_config(v3(), backbone_norm="batch",
                      trainable_backbone_stages=5)


@pytest.fixture(scope="module")
def batch_vars(frozen_vars):
    return as_batch_norm(frozen_vars)


def images(seed):
    return np.random.default_rng(seed).integers(0, 256, (2, 128, 128, 3),
                                                dtype=np.uint8)


# -- anchors, the bridge and load_pretrained -----------------------------------------

@pytest.mark.parametrize("mobile", ["v2", "v3", "v3_320"])
def test_anchors_match_jax(mobile):
    """15 anchors a location on every level, ratio-major as torchvision's
    ``cell_anchors`` orders them, equal to JAX's grids."""
    from podtpu.core.config import mobilenet_config as jax_v2_config
    from podtpu.ops.anchors import grid_anchors as jax_grid_anchors
    from podtpu_torch.models.detector import num_anchors
    from podtpu_torch.ops.anchors import grid_anchors

    jcfg = jax_config(jax_v2_config if mobile == "v2"
                      else v3(low_res=mobile == "v3_320")).model
    args = (tuple(jcfg.image_size), tuple(jcfg.strides),
            tuple(jcfg.anchor_sizes), tuple(jcfg.anchor_ratios))
    got, want = grid_anchors(*args), jax_grid_anchors(*args)
    assert len(got) == len(want) == len(jcfg.strides)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert port_config(jax_config(jax_v2_config)).model.anchors_per_location \
        == 15
    assert num_anchors(port_config(jax_config(v3())).model) == 15 * (
        16 + 16 + 4)


def test_bridge_against_the_v3_key_map(frozen_vars):
    jcfg = jax_config(v3())
    sd = port_model(jcfg, frozen_vars).state_dict()
    tv_map = jax_weights.fasterrcnn_mobilenet_v3_key_map()
    # The map lists both torchvision spellings of the FPN's and the RPN's
    # convolutions; the port carries the unnested one.
    assert set(sd) <= set(tv_map)
    assert {k for k in set(tv_map) - set(sd)} == {
        k for k in tv_map if re.search(r"_blocks\.\d\.0\.|conv\.0\.0\.", k)}
    assert sd["backbone.body.13.block.2.fc1.weight"].shape == (168, 672, 1,
                                                               1)
    back, (loaded, skipped) = jax_weights.convert_torchvision_state_dict(
        sd, frozen_vars, key_map=tv_map, return_stats=True)
    assert not skipped and loaded == len(sd)
    assert tree_equal(back, frozen_vars)


def test_load_pretrained_v3_checkpoint(frozen_vars, tmp_path):
    """torchvision's ``fasterrcnn_mobilenet_v3_large_fpn`` layout (nested
    FPN and RPN convolutions, ``num_batches_tracked``, a 91-class
    predictor) into either norm, as the JAX package loads it."""
    rng = np.random.default_rng(7)
    sd = {}
    for k, v in port_model(jax_config(v3()), frozen_vars).state_dict(
    ).items():
        k = re.sub(r"(_blocks\.\d)\.", r"\1.0.", k)
        k = k.replace("rpn.head.conv.", "rpn.head.conv.0.0.")
        if "box_predictor" in k:
            v = torch.zeros((91 * (4 if "bbox" in k else 1),)
                            + tuple(v.shape[1:]))
        sd[k] = t(rng.normal(0, 0.1, v.shape).astype(np.float32))
        if k.endswith("running_var"):
            sd[k] = sd[k].abs() + 0.5
            sd[k.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(9)
    path = str(tmp_path / "fasterrcnn_mobilenet_v3_large_fpn.pth")
    torch.save(sd, path)
    for norm in ("frozen", "batch"):
        jcfg = jax_config(v3(), backbone_norm=norm)
        start = frozen_vars if norm == "frozen" else as_batch_norm(
            frozen_vars)
        got = load_pretrained(port_model(jcfg, start), path, verbose=False)
        want = jax_weights.load_pretrained(copy.deepcopy(start), path,
                                           verbose=False)
        params, frozen = flax_from_state_dict(got.state_dict())
        assert tree_equal({"params": params, "frozen": frozen}, want), norm
        assert torch.equal(got.backbone.fpn.inner_blocks[1].weight,
                           sd["backbone.fpn.inner_blocks.1.0.weight"])
        stem = got.backbone.body[0][1]
        assert torch.equal(stem.running_mean,
                           sd["backbone.body.0.1.running_mean"])
        assert torch.equal(stem.weight, sd["backbone.body.0.1.weight"]) == (
            norm == "frozen")


# -- the eval forward and a step ---------------------------------------------------

def test_eval_forward(batch_cfg, batch_vars, eval_steps):
    model = check_eval(batch_cfg, batch_vars, eval_steps, images(40))
    assert len(model.features(t(images(40)))) == 3


@pytest.fixture(scope="module")
def one_step(batch_cfg, batch_vars):
    return run_step(batch_cfg, batch_vars, 8)


def test_train_step(one_step):
    check_step(one_step)


def test_eval_after_step(batch_cfg, one_step, eval_steps):
    want = one_step["want"]
    check_eval(batch_cfg, {"params": want["params"],
                           "frozen": want["frozen"]},
               eval_steps, images(42), model=one_step["model"])


def test_resume_checkpoint_carries_running_statistics(batch_cfg, one_step,
                                                     tmp_path):
    """``checkpoint.pt`` keeps the trainable norms' running statistics and
    step counts: a model resumed from it is the stepped one."""
    from podtpu_torch.train import checkpoints

    model = one_step["model"]
    cfg = port_config(batch_cfg)
    checkpoints.save_train_checkpoint(
        str(tmp_path), model, make_optimizer(cfg.train, model), 1, 0, {},
        model_cfg=cfg.model)
    restored = checkpoints.load_train_checkpoint(str(tmp_path))
    resumed = port_model(batch_cfg, as_batch_norm(start_variables(
        jax_config(v3()), 5)))
    resumed.load_state_dict(restored["model"])
    stats = [k for k in restored["model"] if k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    assert len(stats) == 3 * 46
    state = model.state_dict()
    for k, v in resumed.state_dict().items():
        assert torch.equal(v, state[k]), k
    assert int(restored["model"]["backbone.body.0.1.num_batches_tracked"]) \
        == 1


def test_evaluate_between_steps(batch_cfg, batch_vars, tmp_path):
    """The driver's per-epoch ``evaluate`` reads the running statistics and
    moves none of them: two steps end bit for bit where they end without
    it, and the steps move them."""
    cfg = port_config(batch_cfg)
    project = make_project(str(tmp_path / "images"), num_images=3, seed=5)
    ds = DetectionDataset(port_project(project), image_size=(128, 128),
                          max_gt=8, label_names=["particle"])
    loader = Loader(ds, 2, shuffle=False, num_workers=1)
    batches = [{k: t(v) for k, v in make_batch(s).items()} for s in (1, 2)]
    ends = []
    for with_eval in (True, False):
        model = port_model(batch_cfg, batch_vars)
        start = {k: v.clone() for k, v in model.state_dict().items()}
        step = make_train_step(model, make_optimizer(cfg.train, model), cfg,
                               device="cpu")
        gen = torch.Generator().manual_seed(3)
        step(batches[0], LR, generator=gen)
        if with_eval:
            before = {k: v.clone() for k, v in model.state_dict().items()}

            def forward(imgs):
                with torch.inference_mode():
                    return model(torch.as_tensor(imgs))

            evaluate(forward, loader, num_classes=1)
            after = model.state_dict()
            assert all(torch.equal(before[k], after[k]) for k in before)
        step(batches[1], LR, generator=gen)
        ends.append(model.state_dict())
    assert all(torch.equal(ends[0][k], ends[1][k]) for k in ends[0])
    moved = [k for k in start if k.endswith("running_var")
             and not torch.equal(start[k], ends[0][k])]
    assert len(moved) == sum(isinstance(m, BatchNorm2d)
                             for m in model.modules()) == 46
    assert int(ends[0]["backbone.body.0.1.num_batches_tracked"]) == 2
    # Outside the step's forward a norm reads its running statistics.
    norm = model.backbone.body[0][1]
    x = torch.randn(2, 16, 4, 4)
    with torch.no_grad():
        plain = norm(x)
        with batch_statistics(model):
            batch = norm(x)
    assert not torch.equal(plain, batch) and not norm.batch_stats


# -- calibration of the frozen trunk -----------------------------------------------

def norm_keys():
    """flax path tuple of each trunk norm -> the port's module name."""
    return {tuple(flax.split("/")[:-1]): port.rsplit(".", 1)[0]
            for port, tree, flax, _ in key_map(backbone="mobilenet_v3_fpn")
            if tree == "frozen" and flax.endswith("/mean")}


def running_stats(variables):
    sd = state_dict_from_flax(variables["params"], variables["frozen"])
    return {k: np.array(v) for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def test_calibration_of_the_frozen_trunk():
    """Identity-initialised frozen norms: the taps vanish in both packages;
    in each of the 12 passes, from JAX's state before it, every norm's
    captured output statistics agree, and the same layers are skipped.
    (The update's clip at ``max_step`` makes the statistics after a pass
    jump where a channel sits at the clip, so the captures are held.)"""
    jcfg = jax_config(v3())
    variables = jax.tree.map(np.asarray, start_variables(jcfg, 2))
    identity = jax.tree_util.tree_map_with_path(
        lambda p, x: np.ones_like(x) if p[-1].key in ("weight", "var")
        else np.zeros_like(x), variables["frozen"])
    variables = {"params": variables["params"], "frozen": identity}
    imgs = images(0)
    jmodel = jax_make_detector(jcfg.model)
    before, captures = [], []
    make_capture = jax_calibrate._make_bn_capture

    def recording_capture(model, x):
        capture = make_capture(model, x)

        def run(v):
            before.append(running_stats(v))
            captures.append(capture(v))
            return captures[-1]
        return run

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_calibrate, "_make_bn_capture", recording_capture)
    try:
        needs = jax_calibrate.needs_calibration(jmodel, variables, imgs)
        jax_calibrate.calibrate_frozen_stats(jmodel, variables, imgs)
    finally:
        mp.undo()
    model = port_model(jcfg, variables).eval()
    assert needs is calibrate.needs_calibration(model, imgs) is True
    assert len(before) == 12
    names = norm_keys()
    assert len(names) == 46
    for k, (state, want) in enumerate(zip(before, captures)):
        sd = model.state_dict()
        for name, v in state.items():
            sd[name].copy_(t(v))
        got = calibrate._capture_bn_stats(model, imgs)
        assert set(got) == set(names.values())
        for path, (mean, var) in want.items():
            g_mean, g_var = got[names[path]]
            # Means on the scale of the layer's spread: calibrated
            # outputs are centred, their means near 0.
            spread = float(np.sqrt(np.abs(np.asarray(var, np.float64))).max())
            for g, w, scale in ((g_mean, mean, spread), (g_var, var, 0.0)):
                w = np.asarray(w, np.float64)
                assert np.isfinite(g).all() == np.isfinite(w).all(), path
                if np.isfinite(w).all():
                    np.testing.assert_allclose(
                        g, w, rtol=0,
                        atol=1e-3 * max(np.abs(w).max(), scale),
                        err_msg=f"pass {k}: {names[path]}")
    calibrate.calibrate_frozen_stats(model, imgs)
    assert not calibrate.needs_calibration(model, imgs)


# -- the CLI from scratch and model directories both ways --------------------------

@pytest.fixture(scope="module")
def cli_model(cvat_env, tmp_path_factory):
    out = tmp_path_factory.mktemp("v3_320_cli")
    argv = ["train-object-detector", "-t", "7", *server_args(cvat_env),
            "-o", str(out), "-m", "m320", "--backbone",
            "mobilenet_v3_320_fpn", "--max-epochs", "1", "--batch-size", "2"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_cli.main(argv, device="cpu")
    return dict(path=str(out / "m320"), log=buf.getvalue(),
                images=str(cvat_env["raw"]))


def test_cli_320_from_scratch(cli_model):
    assert ("No pretrained weights: mobile trunk uses trainable BatchNorm "
            "(torchvision's from-scratch norm rule)") in cli_model["log"]
    with open(os.path.join(cli_model["path"], "config.json")) as fp:
        mcfg = json.load(fp)["model"]
    assert mcfg["backbone"] == "mobilenet_v3_fpn"
    assert mcfg["backbone_norm"] == "batch"
    assert mcfg["image_size"] == [320, 320]
    assert (mcfg["rpn_post_nms_topk_test"], mcfg["rpn_score_thresh"]) == \
        (150, 0.05)


def canvases(path, n=2):
    names = sorted(os.listdir(path))[:n]
    return np.stack([fit_resize(imageio.read_rgb(os.path.join(path, f)),
                                (320, 320))[0] for f in names])


def test_model_directories_both_ways(cli_model, eval_steps, tmp_path):
    """The port's directory: JAX's loader reads the trees the port's model
    holds, bit for bit, and its trunk gives the port's features.  A
    JAX-saved directory of that config in float32 (seeded weights with
    random norm values): the port's ``load_inference_model`` and
    ``DetectionServer`` give JAX's detections."""
    imgs = canvases(cli_model["images"])
    _, params, frozen, mcfg, labels = jax_inference.load_inference_model(
        cli_model["path"])
    _, model, port_cfg, _ = inference.load_inference_model(cli_model["path"],
                                                           device="cpu")
    assert isinstance(model.backbone.body[0][1], BatchNorm2d)
    got_params, got_frozen = flax_from_state_dict(model.state_dict())
    assert tree_equal({"params": got_params, "frozen": got_frozen},
                      {"params": params, "frozen": frozen})
    assert "weight" in got_params["backbone"]["bn_stem"]
    # The trunks in float32 (the CLI trained in bfloat16).
    mcfg = dataclasses.replace(mcfg, compute_dtype="float32")
    _, model = inference.build_inference_model(
        params, frozen, dataclasses.replace(port_cfg,
                                            compute_dtype="float32"), "cpu")
    _, feats = eval_steps(mcfg)(params, frozen, jnp.asarray(imgs))
    with torch.inference_mode():
        pyramid = model.features(t(imgs))
    for g, w in zip(pyramid, feats):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    # JAX-saved: the same config, seeded weights.
    start = start_variables(dataclasses.replace(
        jax_config(v3()), model=mcfg), 4)
    path = str(tmp_path / "jax_saved")
    jax_ckpt.save_model(path, start["params"], start["frozen"], mcfg, labels)
    jax_ckpt.save_labels(path, labels)
    _, params, frozen, saved_cfg, _ = jax_inference.load_inference_model(path)
    want, _ = eval_steps(saved_cfg)(params, frozen, jnp.asarray(imgs))
    forward, model, _, _ = inference.load_inference_model(path, device="cpu")
    assert isinstance(model.backbone.body[0][1], BatchNorm2d)
    got = forward(imgs)
    v = np.asarray(want.valid)
    assert v.sum() > 0
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy()[v],
                               np.asarray(want.boxes)[v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy()[v],
                               np.asarray(want.scores)[v], rtol=0, atol=1e-4)
    server = DetectionServer(path, batch_size=2, device="cpu")
    try:
        out = server.detect_array(imgs[0], 0.0)
    finally:
        server.close()
    v0 = got.valid[0].numpy()
    assert len(out["detections"]) == int(v0.sum())
    np.testing.assert_allclose(sorted(d["score"] for d in out["detections"]),
                               np.sort(got.scores[0].numpy()[v0]), rtol=0,
                               atol=1e-4)
