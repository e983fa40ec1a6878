"""SSDLite320-MobileNetV3 in podtpu_torch against podtpu (CPU, float32, 4
classes, small capacities, its own 320x320 canvas and widths), with the
helpers of ``tests/test_torch_ssd.py``.

* The weight bridge both ways against ``ssdlite_key_map`` (frozen norms;
  trainable ones keep ``weight``/``bias`` in flax ``params``), and
  ``load_pretrained`` of a synthetic ``ssdlite320_mobilenet_v3_large``
  state dict into a frozen-norm and a trainable-norm model against the JAX
  package's: a trainable norm takes the checkpoint's statistics, not its
  affine terms, and the heads' norms stay frozen either way.
* The six maps (block 13's expansion, the head conv, the four extras),
  1e-5 of their largest, and the eval forward, with frozen and with
  trainable norms (their running averages): boxes 1e-3, scores 1e-4,
  labels and validity exactly.  The norms get random values and the class
  head's kernels are scaled by 30, so that a misplaced norm shows and
  scores do not tie.
* The ``ssdlite`` policy on JAX's draws, JAX run eagerly, masks and
  keypoints included.
* One train step with trainable norms under the ``ssdlite`` policy at
  ``trainable_backbone_stages=3``, each norm teacher-forced to JAX's output
  (``tests/test_torch_mobilenet.py::forced_norms``; corrections under 1e-5
  of each output): losses 1e-5, gradients 2e-3 of each tensor's largest,
  parameters 1e-6, running statistics 1e-6.  The two frozen units (stem
  to block 3) get zero gradients and are still decayed, as under JAX's
  mask; the heads' norms stay frozen.
* ``train(family="ssdlite")`` from scratch on 4 images: the switch to the
  320 recipe, all five units and trainable norms, as JAX prints them; one
  epoch as one group of two steps through ``CachedMultiStep`` equals the
  same epoch in single steps, bit for bit.  Its model directory then
  serves through ``load_inference_model`` (read by JAX's too, bit for
  bit), ``evaluate_model``, ``DetectionServer``, ``infer`` and
  ``infer_tiled`` at its canvas; ``infer_tiled`` at another canvas raises
  a ``ValueError``, where JAX's default boxes no longer fit the head.
"""
import contextlib
import copy
import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from podtpu.infer import inference as jax_inference
from podtpu.models import weights as jax_weights
from podtpu_torch.core.config import config_from_dict
from podtpu_torch.infer import inference, tiled
from podtpu_torch.infer.server import DetectionServer
from podtpu_torch.models.resnet import BatchNorm2d, FrozenBatchNorm2d
from podtpu_torch.models.weights import (_state_dict_layout,
                                         flax_from_state_dict, key_map,
                                         load_pretrained)
from podtpu_torch.train import checkpoints
from podtpu_torch.train import train as port_train
from tests.conftest import tiny_config
from tests.synthetic import make_project
from tests.test_torch_data import port_project
from tests.test_torch_mask import torch_threads  # noqa: F401
from tests.test_torch_mobilenet import as_batch_norm, forced_norms, tree_equal
from tests.test_torch_ssd import (B, check_eval, check_policy, check_step,
                                  jax_config, port_model, run_step,
                                  start_variables, t)

LABELS = ["particle"]


@pytest.fixture(scope="module")
def frozen_vars():
    return start_variables(jax_config("ssdlite"), 1)


@pytest.fixture(scope="module")
def batch_vars(frozen_vars):
    """The trainable-norm model's trees: each trunk and extra norm's
    weight and bias in ``params``; the heads' norms stay frozen."""
    return as_batch_norm(frozen_vars)


def test_bridge_both_ways(frozen_vars, batch_vars):
    model = port_model(jax_config("ssdlite"), frozen_vars)
    sd = model.state_dict()
    assert set(sd) == set(jax_weights.ssdlite_key_map())
    back, (loaded, skipped) = jax_weights.convert_torchvision_state_dict(
        sd, frozen_vars, return_stats=True)
    assert not skipped and loaded == len(sd)
    assert tree_equal(back, frozen_vars)
    batch = port_model(jax_config("ssdlite", backbone_norm="batch"),
                       batch_vars)
    norms = [m for m in batch.modules() if isinstance(m, BatchNorm2d)]
    heads = [m for m in batch.head.modules()
             if isinstance(m, FrozenBatchNorm2d)]
    assert len(norms) == 58 and len(heads) == 12
    params, frozen = flax_from_state_dict(batch.state_dict())
    assert tree_equal({"params": params, "frozen": frozen}, batch_vars)
    assert set(batch_vars["frozen"]["backbone"]["extra1_bn1"]) == {"mean",
                                                                  "var"}
    assert "bn" in batch_vars["frozen"]["head"]["cls0"]
    assert _state_dict_layout(batch.state_dict()) == dict(
        family="ssdlite", batch_norm=True)


@pytest.mark.parametrize("norm", ["frozen", "batch"])
def test_load_pretrained_ssdlite320(frozen_vars, batch_vars, norm,
                                    tmp_path):
    rng = np.random.default_rng(5)
    keys = {k for k, *_ in key_map(family="ssdlite")}
    own = port_model(jax_config("ssdlite"), frozen_vars).state_dict()
    sd = {k: t(rng.normal(0, 0.1, own[k].shape).astype(np.float32)
               + (1.0 if k.endswith("running_var") else 0.0))
          for k in keys}
    path = str(tmp_path / "ssdlite.pth")
    torch.save(sd, path)
    variables = frozen_vars if norm == "frozen" else batch_vars
    jcfg = jax_config("ssdlite", backbone_norm=norm)
    model = port_model(jcfg, variables)
    load_pretrained(model, path)
    want = jax_weights.load_pretrained(variables, path)
    params, frozen = flax_from_state_dict(model.state_dict())
    assert tree_equal({"params": params, "frozen": frozen}, want)
    stem = frozen["backbone"]["bn_stem"]
    assert np.array_equal(stem["mean"], sd["backbone.features.0.0.1."
                                           "running_mean"].numpy())
    if norm == "batch":
        # The affine terms stay the model's own.
        assert tree_equal(params["backbone"]["bn_stem"],
                          variables["params"]["backbone"]["bn_stem"])


@pytest.mark.parametrize("norm", ["frozen", "batch"])
def test_maps_and_eval_forward(frozen_vars, batch_vars, norm):
    variables = frozen_vars if norm == "frozen" else batch_vars
    images = np.random.default_rng(8).integers(0, 256, (B, 320, 320, 3),
                                               dtype=np.uint8)
    model = check_eval(jax_config("ssdlite", backbone_norm=norm), variables,
                       images)
    assert any(isinstance(m, BatchNorm2d) for m in model.modules()) \
        == (norm == "batch")


@pytest.mark.parametrize("targets", ["masks", "keypoints"])
def test_ssdlite_policy(targets):
    draws = check_policy("ssdlite", targets)
    assert draws.zoom is None


def test_train_step(batch_vars):
    jcfg = dataclasses.replace(
        jax_config("ssdlite", backbone_norm="batch",
                   trainable_backbone_stages=3),
        data=dataclasses.replace(tiny_config().data, aug_policy="ssdlite"))
    one = run_step(jcfg, start_variables(jcfg, 2, cls_scale=1.0), 12,
                   forced=forced_norms)
    frozen_units = tuple(f"backbone.features.0.{i}." for i in range(4))
    counts = check_step(one, detached=frozen_units)
    assert counts["detached"] > 0 and counts["checked"] > 100
    assert len(one["gaps"]) == 58 and max(one["gaps"].values()) < 1e-5
    heads = [m for m in one["model"].head.modules()
             if isinstance(m, FrozenBatchNorm2d)]
    assert len(heads) == 12


# -- train() and serving ------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train(family="ssdlite")`` from scratch for one epoch of two steps,
    once as one group of two (``CachedMultiStep``), once in single steps."""
    root = tmp_path_factory.mktemp("ssdlite_train")
    project = port_project(make_project(str(root / "train"), num_images=4,
                                        seed=1))
    test_project = port_project(make_project(str(root / "test"),
                                             num_images=2, seed=2))
    base = config_from_dict(dataclasses.asdict(tiny_config()))
    runs = {}
    for k in (2, 1):
        cfg = dataclasses.replace(base, train=dataclasses.replace(
            base.train, steps_per_dispatch=k))
        groups = []
        make = port_train.make_cached_multi_step

        def counted(*a, **kw):
            multi = make(*a, **kw)
            groups.append(multi)
            return multi

        out = io.StringIO()
        with pytest.MonkeyPatch.context() as mp, \
                contextlib.redirect_stdout(out):
            mp.setattr(port_train, "make_cached_multi_step", counted)
            path = port_train.train(
                project, labels=LABELS, output_dir=str(root), name=f"k{k}",
                batch_size=2, max_epochs=1, config=cfg, family="ssdlite",
                seed=4, num_workers=1, test_project=test_project,
                device="cpu")
        state = torch.load(os.path.join(path, checkpoints.CHECKPOINT),
                           weights_only=False)["model"]
        runs[k] = dict(path=path, printed=out.getvalue(), state=state,
                       calls=sum(g.calls for g in groups))
    return dict(runs=runs, project=project, test_project=test_project,
                root=root)


def test_train_switch_and_one_group(trained):
    grouped, single = trained["runs"][2], trained["runs"][1]
    assert grouped["calls"] == 1 and single["calls"] == 0
    printed = grouped["printed"]
    assert "No pretrained weights: training all backbone stages" in printed
    assert "mobile trunk uses trainable BatchNorm" in printed
    cfg = checkpoints.load_model(grouped["path"])[2]
    assert (cfg.family, cfg.backbone, cfg.image_size, cfg.backbone_norm,
            cfg.trainable_backbone_stages) == ("ssdlite", "mobilenet_v3",
                                               (320, 320), "batch", 5)
    for name, x in grouped["state"].items():
        assert torch.equal(x, single["state"][name]), name
    assert any(n.endswith("running_mean") and not torch.equal(
        x, torch.zeros_like(x)) for n, x in grouped["state"].items())


def test_model_directory_serves(trained, tmp_path):
    path = trained["runs"][2]["path"]
    _, params, frozen, _, _ = jax_inference.load_inference_model(path)
    forward, model, cfg, labels = inference.load_inference_model(
        path, device="cpu")
    got_params, got_frozen = flax_from_state_dict(model.state_dict())
    assert tree_equal({"params": got_params, "frozen": got_frozen},
                      {"params": params, "frozen": frozen})
    images = np.random.default_rng(3).integers(0, 256, (2, 320, 320, 3),
                                               dtype=np.uint8)
    det = forward(images)
    assert det.boxes.shape == (2, cfg.detections_per_image, 4)
    stats = port_train.evaluate_model(trained["test_project"], path,
                                      num_workers=1, device="cpu")
    assert len(stats) == 12
    server = DetectionServer(path, batch_size=2, device="cpu")
    try:
        out = server.detect_array(images[0], threshold=0.0)
    finally:
        server.close()
    assert len(out["detections"]) == int(det.valid[0].sum())
    unlabelled = copy.deepcopy(trained["test_project"])
    for image in unlabelled.image_dict.values():
        image.boxes = []
    annotated = inference.infer(unlabelled, path, threshold=0.0,
                                num_workers=1, device="cpu")
    assert sum(len(im.boxes) for im in annotated.image_dict.values()) > 0
    scan = np.random.default_rng(4).integers(0, 256, (400, 500, 3),
                                             dtype=np.uint8)
    assert isinstance(tiled.infer_tiled(scan, path, device="cpu"), list)
    with pytest.raises(ValueError, match="own canvas"):
        tiled.infer_tiled(scan, path, tile_size=256, device="cpu")
    # JAX's default boxes keep the saved canvas's grids there.
    from podtpu.infer.tiled import infer_tiled as jax_infer_tiled
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax_infer_tiled(scan, path, tile_size=256)
