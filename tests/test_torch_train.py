"""One podtpu_torch training step against ``podtpu.train.step`` (CPU).

The tiny float32 detector (``tests/conftest.py::tiny_config``, 4 classes,
the miso policy with photometric distortion) takes one SGD step in both
packages from the same weights (the port's seeded flax-style initialisation,
``tests/test_torch_mask.py::port_init_variables``, through the bridge), the same batch and the draws of the same JAX key.  The loss dict
agrees to rtol 1e-5; each parameter's gradient to 2e-3 of that tensor's
largest gradient (float32 convolutions sum in another order, and a ReLU
input within rounding of zero passes its gradient in one package and not
in the other; the worst tensor measured 1e-3); the parameters after the
update to 1e-6.  Frozen stages get no gradient and
keep their values.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from podtpu.data.presets import (augment_batch_policy, get_policy,
                                 policy_kwargs)
from podtpu.models.detector import make_detector as jax_make_detector
from podtpu.train import checkpoints as jax_ckpt
from podtpu.train.optim import make_optimizer as jax_make_optimizer
from podtpu.train.step import (create_train_state, images_to_float,
                               make_train_step as jax_make_train_step)
from podtpu_torch.core.config import config_from_dict
from podtpu_torch.models.detector import ModelDraws, make_detector, num_anchors
from podtpu_torch.models.weights import state_dict_from_flax
from podtpu_torch.train import checkpoints
from podtpu_torch.train.optim import make_optimizer
from podtpu_torch.train.step import TrainDraws, make_train_step
from tests.conftest import tiny_config
from tests.test_torch_augment import jax_augment_draws
from tests.test_torch_train_ops import batch_sampler_draws, gt_batch
from tests.test_torch_mask import (port_init_variables,  # noqa: F401
                                   torch_threads)

LR = 0.005
B, G = 2, 8


def t(a):
    return torch.from_numpy(np.array(a))


def jax_config():
    cfg = tiny_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, num_classes=4),
        data=dataclasses.replace(cfg.data, photometric_distort=True))


def make_batch(seed, b=B):
    rng = np.random.default_rng(seed)
    boxes, labels, valid = gt_batch(rng, b, G)
    return {"image": rng.integers(0, 256, (b, 128, 128, 3), dtype=np.uint8),
            "boxes": boxes, "labels": labels, "valid": valid}


def jax_draws(key, cfg, b=B):
    """The port's draws for one step, made along the JAX step's split tree
    (``step.py:86``, ``detector.py:177``)."""
    rng_aug, rng_model = jax.random.split(key)
    rng_rpn, rng_roi = jax.random.split(rng_model)
    rp, rn = batch_sampler_draws(rng_rpn, b, num_anchors(cfg.model))
    qp, qn = batch_sampler_draws(
        rng_roi, b, cfg.model.rpn_post_nms_topk_train + G)
    return TrainDraws(augment=jax_augment_draws(rng_aug, b),
                      model=ModelDraws(t(rp), t(rn), t(qp), t(qn)))


def port_model(cfg, variables):
    model = make_detector(cfg.model)
    sd = state_dict_from_flax(variables["params"], variables["frozen"])
    model.load_state_dict({k: t(v) for k, v in sd.items()})
    return model.to(memory_format=torch.channels_last)


@pytest.fixture(scope="module")
def one_step():
    jcfg = jax_config()
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    jmodel = jax_make_detector(jcfg.model)
    variables = port_init_variables(jcfg.model, 0)
    batch = make_batch(1)
    key = jax.random.PRNGKey(2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    # JAX: the gradients of the step's loss (its augmentation, then the
    # model), and the step itself.
    rng_aug, rng_model = jax.random.split(key)
    images, boxes, valid, _, _ = augment_batch_policy(
        get_policy("miso"), rng_aug, images_to_float(jbatch["image"]),
        jbatch["boxes"], jbatch["valid"], **policy_kwargs(jcfg))
    gt = {"boxes": boxes, "labels": jbatch["labels"], "valid": valid}

    def loss_fn(params):
        losses = jmodel.apply({"params": params,
                               "frozen": variables["frozen"]}, images,
                              gt=gt, train=True, rng=rng_model)
        return sum(losses.values())

    jgrads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(
        variables["params"]))
    tx = jax_make_optimizer(jcfg.train, jcfg.model)
    state = create_train_state(jax.tree.map(jnp.asarray, variables), tx)
    state, jmetrics = jax_make_train_step(jmodel, tx, jcfg)(
        state, jbatch, key, jnp.float32(LR))
    jparams = jax.tree.map(np.asarray, state.params)

    model = port_model(cfg, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, make_optimizer(cfg.train, model), cfg,
                           device="cpu")
    metrics = step({k: t(v) for k, v in batch.items()}, LR,
                   draws=jax_draws(key, cfg))
    return dict(cfg=cfg, variables=variables, jgrads=jgrads,
                jmetrics={k: float(v) for k, v in jmetrics.items()},
                jparams=jparams, model=model, before=before,
                metrics={k: float(v) for k, v in metrics.items()})


class TestTrainStep:
    def test_losses(self, one_step):
        got, want = one_step["metrics"], one_step["jmetrics"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        assert all(np.isfinite(v) and v > 0 for k, v in got.items())

    def test_gradients(self, one_step):
        model = one_step["model"]
        want = state_dict_from_flax(one_step["jgrads"],
                                    one_step["variables"]["frozen"])
        frozen = {"backbone.body.conv1.weight"} | {
            n for n, _ in model.named_parameters()
            if n.startswith("backbone.body.layer1.")}
        checked = 0
        for name, p in model.named_parameters():
            if name in frozen:
                assert p.grad is None and not p.requires_grad, name
                assert not np.any(want[name]), name
                continue
            scale = float(np.abs(want[name]).max())
            assert scale > 0, name
            np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0,
                                       atol=2e-3 * scale, err_msg=name)
            checked += 1
        assert checked == 72  # layer2..4 convs, FPN, RPN head, box head

    def test_parameters_after_update(self, one_step):
        model, before = one_step["model"], one_step["before"]
        want = state_dict_from_flax(one_step["jparams"],
                                    one_step["variables"]["frozen"])
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       rtol=0, atol=1e-6, err_msg=name)
            moved = not torch.equal(p.detach(), before[name])
            assert moved == p.requires_grad, name

    def test_saved_model_loads_in_jax(self, one_step, tmp_path):
        model, cfg = one_step["model"], one_step["cfg"]
        checkpoints.save_model(str(tmp_path), model, cfg.model, ["a", "b",
                                                                 "c"])
        params, frozen, jcfg, labels = jax_ckpt.load_model(str(tmp_path))
        assert labels == ["a", "b", "c"]
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg.model)
        got = state_dict_from_flax(params, frozen)
        for k, v in model.state_dict().items():
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


class TestImageWeight:
    def test_zero_weight_duplicate_is_ignored(self, one_step):
        """A wrap-around duplicate with ``image_weight`` 0 leaves the
        losses of the batch without it."""
        cfg, variables = one_step["cfg"], one_step["variables"]
        batch = make_batch(3, b=1)
        pair = {k: np.concatenate([v, v]) for k, v in batch.items()}
        pair["image_weight"] = np.array([1.0, 0.0], np.float32)
        draws = jax_draws(jax.random.PRNGKey(4), cfg)
        # The duplicate gets other draws: only weight 0 keeps it out.
        first = jax.tree.map(lambda x: x[:1], draws)
        losses = []
        for b, d in ((batch, first), (pair, draws)):
            model = port_model(cfg, variables)
            step = make_train_step(model, make_optimizer(cfg.train, model),
                                   cfg, device="cpu")
            losses.append(step({k: t(v) for k, v in b.items()}, LR,
                               draws=d))
        for k in ("loss_objectness", "loss_rpn_box_reg", "loss_classifier",
                  "loss_box_reg", "loss"):
            np.testing.assert_allclose(float(losses[1][k]),
                                       float(losses[0][k]), rtol=1e-5,
                                       err_msg=k)

    def test_step_needs_draws_or_generator(self, one_step):
        cfg, variables = one_step["cfg"], one_step["variables"]
        model = port_model(cfg, variables)
        step = make_train_step(model, make_optimizer(cfg.train, model), cfg,
                           device="cpu")
        batch = {k: t(v) for k, v in make_batch(5).items()}
        with pytest.raises(ValueError, match="Generator"):
            step(batch, LR)
        m = step(batch, LR, generator=torch.Generator().manual_seed(0))
        assert all(np.isfinite(float(v)) for v in m.values())

    def test_step_marks_its_parts(self, one_step):
        """``mark`` sees each part begin, in order, and leaves the step's
        losses as they were."""
        cfg, variables = one_step["cfg"], one_step["variables"]
        model = port_model(cfg, variables)
        parts = []
        step = make_train_step(model, make_optimizer(cfg.train, model), cfg,
                               device="cpu", mark=parts.append)
        m = step({k: t(v) for k, v in make_batch(1).items()}, LR,
                 draws=jax_draws(jax.random.PRNGKey(2), cfg))
        assert parts == ["augment", "forward_losses", "backward",
                         "optimizer", "end"]
        assert {k: float(v) for k, v in m.items()} == one_step["metrics"]

    def test_step_defaults_to_the_gpu(self, one_step, monkeypatch):
        cfg, variables = one_step["cfg"], one_step["variables"]
        model = port_model(cfg, variables)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_train_step(model, make_optimizer(cfg.train, model), cfg)
