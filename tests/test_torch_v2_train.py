"""Training the v2 recipe in podtpu_torch against podtpu (CPU).

One step of Faster R-CNN v2 under ``lsj`` and of Mask R-CNN v2 under
``multiscale`` (``tests/conftest.py::tiny_config`` sizes, float32, 4
classes, frozen norms with random statistics) in both packages, from the
same weights (flax ``init_variables`` through the weight bridge), batch and
draws of the same JAX key: losses to rtol 1e-5, each gradient to 2e-3 of
its tensor's largest, parameters after the update to 1e-6.  The step
trains the v2 layers (FPN, RPN tower, heads) on a frozen ResNet body, 64
sampled RoIs an image: with the tiny config's 32 and the body training, a
few gradient entries part from JAX's by more than 2e-3 of their tensor's
largest, where float32 sums taken in another order move ReLU inputs
across zero (``tools/torch_v2_step_noise.py`` measures how far the port's
own v2 step moves under a 1e-7 change of one weight: the same order as
the tolerance).  The body's own step is held in
``tests/test_torch_train.py``.  Then one
``train(family="faster_rcnn_v2")`` epoch under ``lsj`` on the CPU, whose
model directory stores the family ``faster_rcnn`` with the v2 fields and
loads in the JAX package's ``load_inference_model``, which gives the
port's detections (boxes 1e-3, scores 1e-4).  One JAX step compile per
model serves the file.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from podtpu.core.config import fasterrcnn_v2_config as jax_v2_config
from podtpu.data import presets as jax_presets
from podtpu.infer import inference as jax_inference
from podtpu.models.detector import init_variables
from podtpu.models.detector import make_detector as jax_make_detector
from podtpu.train.optim import apply_optimizer
from podtpu.train.optim import make_optimizer as jax_make_optimizer
from podtpu.train.step import images_to_float
from podtpu_torch.core.config import config_from_dict
from podtpu_torch.data.dataset import DetectionDataset
from podtpu_torch.infer import inference
from podtpu_torch.models.detector import ModelDraws, num_anchors
from podtpu_torch.models.weights import state_dict_from_flax
from podtpu_torch.train import train as port_train
from podtpu_torch.train.optim import make_optimizer
from podtpu_torch.train.step import TrainDraws, make_train_step
from tests.conftest import tiny_config
from tests.synthetic import make_project
from tests.test_torch_augment import jax_augment_draws
from tests.test_torch_data import port_project
from tests.test_torch_mask import gt_masks, torch_threads  # noqa: F401
from tests.test_torch_train_ops import batch_sampler_draws, gt_batch
from tests.test_torch_v2 import port_model, random_frozen

B, G, LR = 2, 8, 0.005
# Each model's policy: the recipes' two scale jitters.
POLICY = {"faster": "lsj", "mask": "multiscale"}


def t(a):
    return torch.from_numpy(np.array(a))


def jax_config(name):
    cfg = tiny_config()
    return dataclasses.replace(
        cfg, model=jax_v2_config(dataclasses.replace(
            cfg.model, num_classes=4, with_mask=name == "mask",
            trainable_backbone_stages=0, box_batch_per_image=64)),
        data=dataclasses.replace(cfg.data, aug_policy=POLICY[name]))


def make_batch(seed, with_masks):
    rng = np.random.default_rng(seed)
    boxes, labels, valid = gt_batch(rng, B, G)
    batch = {"image": rng.integers(0, 256, (B, 128, 128, 3), dtype=np.uint8),
             "boxes": boxes, "labels": labels, "valid": valid}
    if with_masks:
        batch["masks"] = gt_masks(rng, boxes, valid, 16, 16, 8)
    return batch


def jax_step_draws(key, cfg, policy):
    """The port's draws of one step along the JAX step's split tree
    (``step.py:86``, ``detector.py:177``)."""
    rng_aug, rng_model = jax.random.split(key)
    rng_rpn, rng_roi = jax.random.split(rng_model)
    rp, rn = batch_sampler_draws(rng_rpn, B, num_anchors(cfg.model))
    qp, qn = batch_sampler_draws(
        rng_roi, B, cfg.model.rpn_post_nms_topk_train + G)
    return TrainDraws(augment=jax_augment_draws(rng_aug, B, policy),
                      model=ModelDraws(t(rp), t(rn), t(qp), t(qn)))


@pytest.fixture(scope="module", params=["faster", "mask"])
def one_step(request):
    name = request.param
    jcfg = jax_config(name)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    jmodel = jax_make_detector(jcfg.model)
    variables = jax.tree.map(np.asarray, jax.device_get(dict(
        init_variables(jmodel, jax.random.PRNGKey(0)))))
    variables["frozen"] = random_frozen(variables["frozen"], 1)
    batch = make_batch(1, name == "mask")
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    # The JAX step (``step.py:83-134``): its augmentation eagerly (under
    # jit XLA contracts the resample's products and sums into FMAs, which
    # moves pixels past the 1e-6 the port's resample is held to), its loss
    # and gradients as one compile, then the optimiser update.
    rng_aug, rng_model = jax.random.split(key)
    images, boxes, jvalid, masks, _ = jax_presets.augment_batch_policy(
        jax_presets.get_policy(POLICY[name]), rng_aug,
        images_to_float(jbatch["image"]), jbatch["boxes"], jbatch["valid"],
        masks=jbatch.get("masks"), **jax_presets.policy_kwargs(jcfg))
    gt = {"boxes": boxes, "labels": jbatch["labels"], "valid": jvalid}
    if masks is not None:
        gt["masks"] = masks

    def loss_fn(params):
        losses = jmodel.apply({"params": params,
                               "frozen": variables["frozen"]}, images,
                              gt=gt, train=True, rng=rng_model)
        return sum(losses.values()), losses

    (total, jlosses), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    tx = jax_make_optimizer(jcfg.train, jcfg.model)
    jparams, _ = apply_optimizer(tx, jgrads, tx.init(variables["params"]),
                                 variables["params"], jnp.float32(LR))

    model = port_model(cfg, variables).train()
    step = make_train_step(model, make_optimizer(cfg.train, model), cfg,
                           device="cpu")
    draws = jax_step_draws(key, cfg, POLICY[name])
    metrics = step({k: t(v) for k, v in batch.items()}, LR, draws=draws)
    return dict(name=name, variables=variables, draws=draws,
                valid=batch["valid"], jvalid=np.asarray(jvalid),
                jgrads=jax.tree.map(np.asarray, jgrads),
                jparams=jax.tree.map(np.asarray, jparams),
                jmetrics={k: float(v) for k, v in
                          dict(jlosses, loss=total).items()},
                model=model,
                metrics={k: float(v) for k, v in metrics.items()
                         if k != "lr"})


class TestTrainStep:
    def test_losses(self, one_step):
        got, want = one_step["metrics"], one_step["jmetrics"]
        assert set(got) == set(want)
        assert ("loss_mask" in got) == (one_step["name"] == "mask")
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        assert all(np.isfinite(v) and v > 0 for v in got.values())
        # The jitter moved the boxes: some scale is not 1, and the
        # policy's revalidation ran on JAX's boxes as on the port's.
        scale = one_step["draws"].augment.scale
        assert scale.shape == (B,) and bool((scale != 1).all())
        assert one_step["jvalid"].sum() <= one_step["valid"].sum()

    def test_gradients(self, one_step):
        model = one_step["model"]
        want = state_dict_from_flax(one_step["jgrads"],
                                    one_step["variables"]["frozen"])
        checked = []
        for name, p in model.named_parameters():
            if p.grad is None:
                assert not p.requires_grad and not np.any(want[name]), name
                continue
            scale = float(np.abs(want[name]).max())
            assert scale > 0, name
            np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0,
                                       atol=2e-3 * scale, err_msg=name)
            checked.append(name)
        for v2 in ("backbone.fpn.inner_blocks.0.0.weight",
                   "rpn.head.conv.1.0.weight", "roi_heads.box_head.3.0.weight",
                   "roi_heads.box_head.5.weight"):
            assert v2 in checked, v2
        if one_step["name"] == "mask":
            assert "roi_heads.mask_head.3.0.weight" in checked

    def test_parameters_after_update(self, one_step):
        want = state_dict_from_flax(one_step["jparams"],
                                    one_step["variables"]["frozen"])
        for name, p in one_step["model"].named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       rtol=0, atol=1e-6, err_msg=name)
        # The frozen norms are buffers: the step leaves them as they were.
        for name, b in one_step["model"].named_buffers():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_array_equal(b.numpy(), want[name])


def test_train_v2_epoch_loads_in_jax(tmp_path):
    """``train(family="faster_rcnn_v2")`` under ``lsj``: the model directory
    keeps the family ``faster_rcnn`` and the v2 fields, and the JAX
    package's ``load_inference_model`` reads it into the port's
    detections."""
    jcfg = tiny_config()
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(
        jcfg.data, aug_policy="lsj"))
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    project = make_project(str(tmp_path / "images"), num_images=6, seed=4)
    model_dir = port_train.train(
        port_project(project), output_dir=str(tmp_path / "models"),
        name="v2", batch_size=2, max_epochs=1, alrs_epochs=2,
        alrs_startup_factor=1, config=cfg, num_workers=2, seed=0,
        family="faster_rcnn_v2", device="cpu")
    eval_step, params, frozen, jmcfg, labels = \
        jax_inference.load_inference_model(model_dir)
    assert jmcfg.family == "faster_rcnn"
    assert (jmcfg.rpn_conv_depth, jmcfg.box_head_type, jmcfg.fpn_norm,
            jmcfg.mask_head_norm) == (2, "convfc", True, True)
    assert jmcfg == jax_v2_config(dataclasses.replace(
        jcfg.model, num_classes=2, trainable_backbone_stages=5))
    forward, model, mcfg, port_labels = inference.load_inference_model(
        model_dir, device="cpu")
    assert port_labels == labels
    assert "roi_heads.box_head.5.weight" in model.state_dict()
    ds = DetectionDataset(port_project(project), image_size=(128, 128),
                          max_gt=8, label_names=labels)
    images = np.stack([s.image for s in ds.load_batch([0, 1])])
    want = eval_step(params, frozen, jnp.asarray(images))
    with torch.inference_mode():
        got = forward(images)
    v = np.asarray(want.valid)
    assert v.sum() > 0
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy()[v],
                               np.asarray(want.boxes)[v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy()[v],
                               np.asarray(want.scores)[v], rtol=0, atol=1e-4)
