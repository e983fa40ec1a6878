"""The MobileNetV2 Faster R-CNN and trainable BatchNorm in podtpu_torch
against podtpu (CPU, ``tests/conftest.py::tiny_config`` sizes, float32, 4
classes).

* The weight bridge: the port's trunk keys are those of
  ``podtpu.models.weights.mobilenet_v2_key_map`` under ``backbone.`` in
  place of ``features.``, the JAX package's converter reads them back
  exactly, and a trainable norm's ``weight``/``bias`` go to flax
  ``params``, ``mean``/``var`` to ``frozen``, ``num_batches_tracked``
  nowhere.
* The eval forward with trainable norms (their running averages): trunk
  features 1e-5 of their largest, boxes 1e-3, scores 1e-4, valid slots and
  labels equal; a Mask R-CNN MobileNetV2 eval forward, masks 1e-4.
* One training step with trainable norms at ``trainable_backbone_stages=3``
  on the draws of one JAX key: losses rtol 1e-5, gradients 2e-3 of each
  tensor's largest, parameters after the update 1e-6, running statistics
  1e-6 of their largest (at least 1).  The two frozen units' parameters
  get zero gradients and are still decayed, as under the JAX package's
  optimiser mask (ResNet's names only).  A bias whose every path runs into
  a training norm's mean has an exact gradient of 0, held under 1e-6 in
  both.  The eval forward after the step equals JAX's on the new state.

  The step is teacher-forced norm by norm (:func:`forced_norms`): with
  batch statistics, float32 rounding grows about 1.06x a norm, to 4e-5 of
  the trunk's output after MobileNetV2's 52 norms in either package
  (against a float64 run of the port), which flips ReLUs and moves
  gradient entries by percents.  So each port norm's output takes JAX's
  value through a straight-through correction, and the correction itself
  is held: under 1e-5 of each output's largest, one norm's rounding.
* A torchvision ImageNet ``mobilenet_v2`` state dict through
  ``load_pretrained`` into a frozen-norm and a trainable-norm model, against
  the JAX package's ``load_pretrained``: a trainable norm takes the
  checkpoint's statistics, not its affine terms.

The models start from the port's seeded initialisation with random norm
values, so that a norm in the wrong place shows.  One JAX compile per
config: the eval forward (with the trunk's features), the mask model's,
the train step's gradients and its update.
"""
import contextlib
import copy
import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from podtpu.core.config import mobilenet_config as jax_mobilenet_config
from podtpu.data import presets as jax_presets
from podtpu.models import weights as jax_weights
from podtpu.models.detector import make_detector as jax_make_detector
from podtpu.models.resnet import FrozenBatchNorm
from podtpu.train.optim import apply_optimizer
from podtpu.train.optim import make_optimizer as jax_make_optimizer
from podtpu.train.step import images_to_float
from podtpu_torch.core.config import config_from_dict
from podtpu_torch.models.detector import (ModelDraws, init_parameters,
                                          make_detector, num_anchors)
from podtpu_torch.models.mobilenet import MobileNetV2
from podtpu_torch.models.resnet import BatchNorm2d
from podtpu_torch.models.weights import (_state_dict_layout,
                                         flax_from_state_dict, key_map,
                                         load_pretrained,
                                         state_dict_from_flax)
from podtpu_torch.train.optim import make_optimizer
from podtpu_torch.train.step import TrainDraws, make_train_step
from tests.conftest import tiny_config
from tests.test_torch_augment import jax_augment_draws
from tests.test_torch_mask import torch_threads  # noqa: F401
from tests.test_torch_train_ops import batch_sampler_draws, gt_batch

B, G, LR = 2, 8, 0.005
# Gradients held absolutely: an exact zero's float32 rounding.
ZERO_GRADIENT = 1e-6


def t(a):
    return torch.from_numpy(np.array(a))


def jax_config(mobile=jax_mobilenet_config, **model_kw):
    """The tiny config on a mobile trunk (``mobile(model_cfg)``), 4 classes;
    ``model_kw`` overrides model fields."""
    cfg = tiny_config()
    model = mobile(dataclasses.replace(cfg.model, num_classes=4))
    return dataclasses.replace(cfg, model=dataclasses.replace(model,
                                                              **model_kw))


def port_config(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def start_variables(jcfg, seed):
    """Flax trees of a port model of ``jcfg`` from the port's seeded
    initialisation, every norm's four vectors drawn near the identity."""
    model = make_detector(port_config(jcfg).model)
    init_parameters(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for mod in model.modules():
            if hasattr(mod, "running_var"):
                for name in ("weight", "running_var"):
                    x = getattr(mod, name)
                    x.copy_(t(rng.uniform(0.8, 1.25, x.shape)))
                for name in ("bias", "running_mean"):
                    x = getattr(mod, name)
                    x.copy_(t(rng.normal(0, 0.05, x.shape)))
    params, frozen = flax_from_state_dict(model.state_dict())
    return {"params": params, "frozen": frozen}


def port_model(jcfg, variables):
    model = make_detector(port_config(jcfg).model)
    sd = state_dict_from_flax(variables["params"], variables["frozen"])
    model.load_state_dict({k: t(v) for k, v in sd.items()})
    return model.to(memory_format=torch.channels_last)


def tree_equal(a, b):
    return all(jax.tree.leaves(jax.tree.map(
        np.array_equal, jax.tree.map(np.asarray, a),
        jax.tree.map(np.asarray, b))))


@pytest.fixture(scope="module")
def eval_steps():
    """One jitted JAX eval forward per model config (``make_eval_step``'s,
    with the trunk's features beside its detections), shared by the
    file."""
    steps = {}

    def get(mcfg):
        if mcfg not in steps:
            model = jax_make_detector(mcfg)

            def run(params, frozen, images):
                v = {"params": params, "frozen": frozen}
                return (model.apply(v, images, train=False),
                        model.apply(v, images,
                                    method=lambda m, x: m._features(x)))

            steps[mcfg] = jax.jit(run)
        return steps[mcfg]

    return get


def assert_same_detections(got, want, masks=None, want_masks=None):
    v = np.asarray(want.valid)
    assert v.sum() > 4
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy()[v],
                               np.asarray(want.boxes)[v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy()[v],
                               np.asarray(want.scores)[v], rtol=0, atol=1e-4)
    if masks is not None:
        np.testing.assert_allclose(masks.numpy()[v],
                                   np.asarray(want_masks)[v], rtol=0,
                                   atol=1e-4)


def check_eval(jcfg, variables, eval_steps, images, model=None):
    """The port's eval forward against JAX's eval step on ``images``, the
    trunk's features included; returns the port model."""
    model = model or port_model(jcfg, variables)
    want, feats = eval_steps(jcfg.model)(
        variables["params"], variables["frozen"], jnp.asarray(images))
    with torch.inference_mode():
        got = model(t(images))
        pyramid = model.features(t(images))
    assert len(pyramid) == len(feats)
    for g, w in zip(pyramid, feats):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    if jcfg.model.with_mask:
        (got, masks), (want, want_masks) = got, want
        assert_same_detections(got, want, masks, want_masks)
    else:
        assert_same_detections(got, want)
    return model


def jax_train_step(jcfg, variables, batch, key):
    """The JAX step's losses, gradients, new ``frozen`` collection (the
    running statistics) and updated parameters: its augmentation eagerly,
    the loss and gradients as one compile with ``frozen`` mutable, as
    ``podtpu.train.step.make_train_step`` runs a trainable-norm model, then
    the optimiser."""
    jmodel = jax_make_detector(jcfg.model)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rng_aug, rng_model = jax.random.split(key)
    images, boxes, valid, _, _ = jax_presets.augment_batch_policy(
        jax_presets.get_policy(jcfg.data.aug_policy), rng_aug,
        images_to_float(jb["image"]), jb["boxes"], jb["valid"],
        **jax_presets.policy_kwargs(jcfg))
    gt = {"boxes": boxes, "labels": jb["labels"], "valid": valid}

    def loss_fn(params):
        losses, muts = jmodel.apply(
            {"params": params, "frozen": variables["frozen"]}, images,
            gt=gt, train=True, rng=rng_model,
            mutable=["frozen", "intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(
                mdl, FrozenBatchNorm))
        return sum(losses.values()), (losses, muts["frozen"],
                                      muts["intermediates"])

    (total, (losses, frozen, norms)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    tx = jax_make_optimizer(jcfg.train, jcfg.model)
    # One compile: op by op, each of the trunk's shapes compiles alone.
    params, _ = jax.jit(lambda g, s, p: apply_optimizer(
        tx, g, s, p, jnp.float32(LR)))(
        grads, tx.init(variables["params"]), variables["params"])
    as_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return dict(losses={k: float(v) for k, v in
                        dict(losses, loss=total).items()},
                grads=as_np(grads), frozen=as_np(frozen),
                params=as_np(params), norms=as_np(norms))


def norm_paths(model):
    """Each trainable norm's module name -> its flax module path."""
    return {key[:-len(".running_mean")]: path[:-len("/mean")]
            for key, coll, path, _ in key_map(**_state_dict_layout(
                model.state_dict())) if key.endswith(".running_mean")}


@contextlib.contextmanager
def forced_norms(model, norms):
    """Within the block each :class:`BatchNorm2d` of ``model`` returns the
    output JAX's norm gave (``norms``: the step's captured intermediates),
    through a straight-through correction: its own value plus the detached
    difference, so that gradients take the port's own norm.  Yields the
    largest correction of each norm relative to its output's largest."""
    paths = norm_paths(model)
    gaps, hooks = {}, []

    def hook(name):
        def replace(mod, inputs, out):
            node = norms
            for k in paths[name].split("/"):
                node = node[k]
            want = t(node["__call__"][0]).permute(0, 3, 1, 2)
            gap = (want - out).detach()
            gaps[name] = float(gap.abs().max() / want.abs().max())
            return out + gap
        return replace

    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm2d):
            hooks.append(mod.register_forward_hook(hook(name)))
    try:
        yield gaps
    finally:
        for h in hooks:
            h.remove()


def port_draws(jcfg, key):
    """The port's draws of one step along the JAX step's split tree."""
    cfg = port_config(jcfg)
    rng_aug, rng_model = jax.random.split(key)
    rng_rpn, rng_roi = jax.random.split(rng_model)
    rp, rn = batch_sampler_draws(rng_rpn, B, num_anchors(cfg.model))
    qp, qn = batch_sampler_draws(
        rng_roi, B, cfg.model.rpn_post_nms_topk_train + G)
    return TrainDraws(augment=jax_augment_draws(rng_aug, B,
                                                jcfg.data.aug_policy),
                      model=ModelDraws(t(rp), t(rn), t(qp), t(qn)))


def make_batch(seed):
    rng = np.random.default_rng(seed)
    boxes, labels, valid = gt_batch(rng, B, G)
    return {"image": rng.integers(0, 256, (B, 128, 128, 3), dtype=np.uint8),
            "boxes": boxes, "labels": labels, "valid": valid}


def run_step(jcfg, variables, seed):
    """One step of both packages from ``variables`` on batch ``seed`` and
    the draws of JAX key ``seed``."""
    batch = make_batch(seed)
    key = jax.random.PRNGKey(seed)
    want = jax_train_step(jcfg, variables, batch, key)
    model = port_model(jcfg, variables)
    cfg = port_config(jcfg)
    step = make_train_step(model, make_optimizer(cfg.train, model), cfg,
                           device="cpu")
    with forced_norms(model, want["norms"]) as gaps:
        metrics = step({k: t(v) for k, v in batch.items()}, LR,
                       draws=port_draws(jcfg, key))
    return dict(want=want, model=model, variables=variables, gaps=gaps,
                metrics={k: float(v) for k, v in metrics.items()
                         if k != "lr"})


def check_step(one, frozen_prefixes=()):
    """Losses, gradients, parameters and running statistics of ``one``
    (:func:`run_step`) against JAX's; parameters under
    ``frozen_prefixes`` must have zero gradients and still move."""
    want, model = one["want"], one["model"]
    assert set(one["metrics"]) == set(want["losses"])
    for k, w in want["losses"].items():
        np.testing.assert_allclose(one["metrics"][k], w, rtol=1e-5,
                                   err_msg=k)
    frozen = one["variables"]["frozen"]
    grads = state_dict_from_flax(want["grads"], frozen)
    params = state_dict_from_flax(want["params"], want["frozen"])
    before = state_dict_from_flax(one["variables"]["params"], frozen)
    n_frozen = checked = 0
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        if name.startswith(frozen_prefixes):
            n_frozen += 1
            assert not np.any(g) and not np.any(grads[name]), name
            assert not np.array_equal(p.detach().numpy(), before[name]), name
        elif float(np.abs(grads[name]).max()) < ZERO_GRADIENT:
            # A bias whose every path runs into a training norm's mean has
            # an exact gradient of 0: both must be within rounding of it.
            assert float(np.abs(g).max()) < ZERO_GRADIENT, name
        else:
            scale = float(np.abs(grads[name]).max())
            np.testing.assert_allclose(g, grads[name], rtol=0,
                                       atol=2e-3 * scale, err_msg=name)
            checked += 1
        np.testing.assert_allclose(p.detach().numpy(), params[name], rtol=0,
                                   atol=1e-6, err_msg=name)
    assert (n_frozen > 0) == bool(frozen_prefixes)
    assert checked > 50
    # Each norm's output, from JAX's inputs, within float32 rounding of
    # JAX's before the correction.
    assert len(one["gaps"]) > 30 and max(one["gaps"].values()) < 1e-5
    moved = 0
    for name, b in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            w = params[name]
            np.testing.assert_allclose(b.numpy(), w, rtol=0,
                                       atol=1e-6 * max(1.0, np.abs(w).max()),
                                       err_msg=name)
            moved += not np.array_equal(w, before[name])
        elif name.endswith("num_batches_tracked"):
            assert int(b) == 1, name
    assert moved == 2 * sum(isinstance(m, BatchNorm2d)
                            for m in model.modules())


# -- MobileNetV2 ---------------------------------------------------------------

@pytest.fixture(scope="module")
def frozen_vars():
    return start_variables(jax_config(), 1)


def as_batch_norm(variables):
    """``variables`` of a frozen-norm mobile model as its trainable-norm
    model's: each trunk norm's weight and bias moved to ``params``."""
    out = copy.deepcopy(variables)

    def move(frozen, params):
        for k, v in frozen.items():
            if {"weight", "mean"} <= set(v):
                params.setdefault(k, {}).update(
                    weight=v.pop("weight"), bias=v.pop("bias"))
            elif isinstance(v, dict) and "mean" not in v:
                move(v, params.setdefault(k, {}))

    move(out["frozen"]["backbone"], out["params"]["backbone"])
    return out



@pytest.fixture(scope="module")
def batch_cfg():
    """Trainable norms, the two lowest freeze units frozen."""
    return jax_config(backbone_norm="batch", trainable_backbone_stages=3)


@pytest.fixture(scope="module")
def batch_vars(frozen_vars):
    return as_batch_norm(frozen_vars)


def test_bridge_against_the_mobilenet_v2_key_map(frozen_vars):
    jcfg = jax_config()
    variables = frozen_vars
    model = port_model(jcfg, variables)
    sd = {k: v for k, v in model.state_dict().items()}
    trunk = {re.sub(r"^backbone\.", "features.", k): v for k, v in sd.items()
             if re.match(r"backbone\.\d", k)}
    assert set(trunk) == set(jax_weights.mobilenet_v2_key_map())
    back, (loaded, skipped) = jax_weights.convert_torchvision_state_dict(
        trunk, variables, key_map=jax_weights.mobilenet_v2_key_map(),
        return_stats=True)
    assert not skipped and loaded == len(trunk)
    assert tree_equal(back, variables)
    assert "backbone.18.0.weight" in sd and "roi_heads.box_head.fc6.weight" \
        in sd and sd["roi_heads.box_head.fc6.weight"].shape == (1024, 62720)


def test_trainable_norm_layout(batch_cfg, batch_vars):
    model = port_model(batch_cfg, batch_vars)
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    assert len(norms) == 52
    assert "bn_stem" in batch_vars["params"]["backbone"]
    assert set(batch_vars["frozen"]["backbone"]["bn_stem"]) == {"mean", "var"}
    sd = model.state_dict()
    assert int(sd["backbone.0.1.num_batches_tracked"]) == 0
    params, frozen = flax_from_state_dict(sd)
    assert tree_equal({"params": params, "frozen": frozen}, batch_vars)


def test_eval_forward(batch_cfg, batch_vars, eval_steps):
    images = np.random.default_rng(40).integers(0, 256, (2, 128, 128, 3),
                                                dtype=np.uint8)
    check_eval(batch_cfg, batch_vars, eval_steps, images)


def test_mask_eval_forward(eval_steps):
    jcfg = jax_config(with_mask=True)
    variables = start_variables(jcfg, 2)
    assert variables["params"]["mask_head"]["conv1"]["kernel"].shape == \
        (3, 3, 1280, 256)
    images = np.random.default_rng(41).integers(0, 256, (2, 128, 128, 3),
                                                dtype=np.uint8)
    check_eval(jcfg, variables, eval_steps, images)


@pytest.fixture(scope="module")
def one_step(batch_cfg, batch_vars):
    return run_step(batch_cfg, batch_vars, 7)


def test_train_step(one_step):
    # Units 0 and 1: the stem, blocks 1 to 3.
    check_step(one_step, ("backbone.0.", "backbone.1.", "backbone.2.",
                          "backbone.3."))


def test_eval_after_step(batch_cfg, one_step, eval_steps):
    want = one_step["want"]
    images = np.random.default_rng(42).integers(0, 256, (2, 128, 128, 3),
                                                dtype=np.uint8)
    check_eval(batch_cfg, {"params": want["params"],
                           "frozen": want["frozen"]},
               eval_steps, images, model=one_step["model"])


def test_load_pretrained_imagenet(frozen_vars, tmp_path):
    """A torchvision ImageNet checkpoint (``features.*``, ``classifier.*``,
    ``num_batches_tracked``) into either norm, as the JAX package loads
    it."""
    rng = np.random.default_rng(6)
    sd = {}
    for k, v in MobileNetV2().state_dict().items():
        if not k.endswith("num_batches_tracked"):
            key = f"features.{k}"
            sd[key] = t(rng.normal(0, 0.1, v.shape).astype(np.float32))
            if key.endswith("running_var"):
                sd[key] = sd[key].abs() + 0.5
                sd[key.replace("running_var", "num_batches_tracked")] = \
                    torch.tensor(5)
    sd["classifier.1.weight"] = torch.zeros(1000, 1280)
    sd["classifier.1.bias"] = torch.zeros(1000)
    path = str(tmp_path / "mobilenet_v2.pth")
    torch.save(sd, path)
    for norm in ("frozen", "batch"):
        jc = jax_config(backbone_norm=norm)
        start = frozen_vars if norm == "frozen" else as_batch_norm(
            frozen_vars)
        got = load_pretrained(port_model(jc, start), path, verbose=False)
        want = jax_weights.load_pretrained(copy.deepcopy(start), path,
                                           verbose=False)
        params, frozen = flax_from_state_dict(got.state_dict())
        assert tree_equal({"params": params, "frozen": frozen}, want), norm
        stem = got.backbone[0][1]
        assert torch.equal(stem.running_var, sd["features.0.1.running_var"])
        # A trainable norm keeps its own affine terms.
        assert torch.equal(stem.weight, sd["features.0.1.weight"]) == (
            norm == "frozen")
