"""RetinaNet v1 and v2 in podtpu_torch against podtpu (CPU).

``tests/conftest.py::tiny_config`` sizes (128x128 canvas, float32), 4
classes.  The same numpy-seeded inputs and the same weights (the port's
seeded flax-style initialisation, ``tests/test_torch_mask.py::
port_init_variables``, through the bridge) go to both packages.
Random weights score every class near the prior 0.01, under the 0.05
threshold, so the eval tests lift the scores (``lift``): ``cls_logits``
gets bias 0 and, in v1, its kernel is scaled by 100, which spreads the
logits over about +-1 and fills the detection slots.  Held here:

* the box coders, GIoU (degenerate boxes too) and the focal loss, values
  and gradients, to 1e-6;
* the pyramid P3..P7 (v1: P6 from P5; v2: from C5) to 1e-5 of the largest
  output, the heads (v2's GroupNorm with flax's variance) on JAX's pyramid
  to 1e-5 of their largest, and GroupNorm alone in float32 and bfloat16;
* the eval forward: valid slots and labels equal, boxes 1e-3, scores 1e-4,
  at least half the slots valid; the single class-offset NMS of each image
  (one launch for the batch, presorted by the pool's stable top-k) against
  JAX's ``batched_nms_keep``, whose own argsort leaves the pool in place;
* one train step (``aug_policy="none"``, ``image_weight`` included):
  losses to rtol 1e-5, gradients to 2e-3 of each tensor's largest,
  parameters after the SGD update to 1e-6;
* the weight bridge against ``retinanet_key_map`` and
  ``retinanet_v2_key_map``, and ``load_pretrained`` of synthetic
  torchvision state dicts in each layout against JAX's;
* ``train(family="retinanet_v2")`` for one epoch (the stored config), and
  ``infer``, ``evaluate_model`` and ``DetectionServer`` on a JAX-saved
  model directory against JAX's ``infer``.

One JAX compile each of eval, of the pyramid and heads, and of loss and
gradients per configuration.
"""
import copy
import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from podtpu.core.config import retinanet_config as jax_retinanet_config
from podtpu.core.config import \
    retinanet_v2_config as jax_retinanet_v2_config
from podtpu.infer import inference as jax_inference
from podtpu.models import fcos as jax_fcos
from podtpu.models import fpn as jax_fpn
from podtpu.models import resnet as jax_resnet
from podtpu.models import retinanet as jax_retinanet
from podtpu.models import weights as jax_weights
from podtpu.models.detector import make_detector as jax_make_detector
from podtpu.models.rpn import optax_sigmoid_bce
from podtpu.ops import boxes as jax_boxes
from podtpu.ops import nms as jax_nms
from podtpu.train import checkpoints as jax_ckpt
from podtpu.train import step as jax_step
from podtpu.train import train as jax_train
from podtpu.train.optim import apply_optimizer
from podtpu.train.optim import make_optimizer as jax_make_optimizer
from podtpu_torch.core.config import (config_from_dict,
                                      model_config_from_dict)
from podtpu_torch.infer import inference
from podtpu_torch.infer.server import DetectionServer
from podtpu_torch.models import retinanet
from podtpu_torch.models.detector import make_detector
from podtpu_torch.models.weights import (flax_from_state_dict, key_map,
                                         load_pretrained,
                                         state_dict_from_flax)
from podtpu_torch.ops import boxes as box_ops
from podtpu_torch.ops.nms import NEG_INF
from podtpu_torch.train import train as port_train
from podtpu_torch.train.optim import make_optimizer
from podtpu_torch.train.step import TrainDraws, make_train_step
from tests.conftest import tiny_config
from tests.synthetic import make_project
from tests.test_torch_augment import jax_augment_draws
from tests.test_torch_data import port_project
from tests.test_torch_infer import assert_same_annotations
from tests.test_torch_mask import (port_init_variables,  # noqa: F401
                                   torch_threads)
from tests.test_torch_train_ops import gt_batch

B, G, LR = 2, 8, 0.005
LABELS = ["particle", "bubble", "grain"]
PRESETS = {"retinanet": jax_retinanet_config,
           "retinanet_v2": jax_retinanet_v2_config}
JAX_KEY_MAPS = {"retinanet": jax_weights.retinanet_key_map,
                "retinanet_v2": jax_weights.retinanet_v2_key_map}


def t(a):
    return torch.from_numpy(np.array(a))


def jax_config(name, presets=PRESETS):
    cfg = tiny_config()
    return dataclasses.replace(
        cfg, model=presets[name](dataclasses.replace(cfg.model,
                                                     num_classes=4)),
        data=dataclasses.replace(cfg.data, aug_policy="none"))


def lift(variables):
    """Scores spread around 0.5: ``cls_logits`` bias 0 and, behind towers
    without GroupNorm (whose outputs are about 100 times smaller), its
    kernel times 100."""
    v = copy.deepcopy(variables)
    head = v["params"]["head"]
    head["cls_logits"]["bias"] = np.zeros_like(head["cls_logits"]["bias"])
    if "cls_gn0" not in head:
        head["cls_logits"]["kernel"] = head["cls_logits"]["kernel"] * 100.0
    return v


def port_model(mcfg, variables):
    model = make_detector(mcfg)
    sd = state_dict_from_flax(variables["params"], variables["frozen"])
    model.load_state_dict({k: t(v) for k, v in sd.items()})
    return model.to(memory_format=torch.channels_last).eval()


def images(seed, b=B):
    return np.random.default_rng(seed).integers(
        0, 256, (b, 128, 128, 3)).astype(np.uint8)


_EVAL_STEPS = {}


def cached_eval_step(model):
    """``make_eval_step`` compiled once per configuration for the file."""
    if model.cfg not in _EVAL_STEPS:
        _EVAL_STEPS[model.cfg] = jax_step.make_eval_step(model)
    return _EVAL_STEPS[model.cfg]


@pytest.fixture(autouse=True, scope="module")
def one_jax_eval_step():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_inference, "make_eval_step", cached_eval_step)
    mp.setattr(jax_train, "make_eval_step", cached_eval_step)
    yield
    mp.undo()


_FAMILIES = {}


def setup_family(name, presets=PRESETS, lifted=lift):
    """JAX config, model, numpy variables as initialised and lifted, the
    port's model with the lifted ones; made once per family for the
    file (callers copy the dict before adding to it)."""
    if name not in _FAMILIES:
        _FAMILIES[name] = _setup_family(name, presets, lifted)
    return dict(_FAMILIES[name])


def _setup_family(name, presets, lifted):
    jcfg = jax_config(name, presets)
    jmodel = jax_make_detector(jcfg.model)
    variables = port_init_variables(jcfg.model, 0)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    return dict(name=name, jcfg=jcfg, jmodel=jmodel, raw=variables,
                variables=lifted(variables), cfg=cfg,
                model=port_model(cfg.model, lifted(variables)))


def eval_outputs(fam, imgs):
    """JAX's pyramid, head outputs and detections of ``imgs``; the port's
    detections."""
    jmodel, v = fam["jmodel"], fam["variables"]

    def parts(m, x):
        pyramid = m._features(x)
        return pyramid, m.head(pyramid)

    pyramid, head = jax.jit(lambda p, f, x: jmodel.apply(
        {"params": p, "frozen": f}, x, method=parts))(
        v["params"], v["frozen"], imgs)
    want = cached_eval_step(jmodel)(v["params"], v["frozen"],
                                    jnp.asarray(imgs))
    with torch.inference_mode():
        got = fam["model"](t(imgs))
    return dict(pyramid=jax.tree.map(np.asarray, pyramid),
                head=jax.tree.map(np.asarray, head), want=want, got=got)


@pytest.fixture(scope="module", params=list(PRESETS))
def family(request):
    fam = setup_family(request.param)
    fam.update(eval_outputs(fam, images(3)))
    return fam


def close_to_largest(got, want, rel, name=""):
    scale = float(np.abs(want).max())
    assert scale > 0, name
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)


def nchw(x):
    return t(np.transpose(np.asarray(x), (0, 3, 1, 2))).contiguous(
        memory_format=torch.channels_last)


# -- box coders, GIoU, focal loss --------------------------------------------

def random_boxes(rng, n, degenerate=0):
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(1, 50, (n, 2))
    wh[:degenerate] = 0.0           # zero-area boxes
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_linear_coder_and_giou():
    rng = np.random.default_rng(0)
    anchors, boxes = random_boxes(rng, 64), random_boxes(rng, 64, 6)
    boxes[6:9] = anchors[6:9]        # identical pairs
    want = jax_boxes.encode_boxes_linear(jnp.asarray(anchors),
                                         jnp.asarray(boxes))
    got = box_ops.encode_boxes_linear(t(anchors), t(boxes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    codes = rng.uniform(0, 3, (64, 4)).astype(np.float32)
    np.testing.assert_allclose(
        box_ops.decode_boxes_linear(t(codes), t(anchors)).numpy(),
        np.asarray(jax_boxes.decode_boxes_linear(jnp.asarray(codes),
                                                 jnp.asarray(anchors))),
        rtol=1e-6, atol=1e-6)
    for scale in (False, True):
        np.testing.assert_allclose(
            box_ops.decode_boxes_linear(t(codes), t(anchors),
                                        scale).numpy(),
            np.asarray(jax_boxes.decode_boxes_linear(
                jnp.asarray(codes), jnp.asarray(anchors), scale)),
            rtol=1e-6, atol=1e-6)
    # GIoU values and gradients, degenerate and identical pairs included.
    a, b = random_boxes(rng, 64, 4), boxes
    jg, jgrad = jax.value_and_grad(
        lambda x: jax_boxes.elementwise_giou(x, jnp.asarray(b)).sum())(
        jnp.asarray(a))
    x = t(a).requires_grad_()
    g = box_ops.elementwise_giou(x, t(b))
    g.sum().backward()
    assert np.isfinite(g.detach().numpy()).all()
    np.testing.assert_allclose(
        g.detach().numpy(),
        np.asarray(jax_boxes.elementwise_giou(jnp.asarray(a),
                                              jnp.asarray(b))),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(g.detach().sum()), float(jg),
                               rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-6)


def test_sigmoid_focal_loss():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (256, 4)).astype(np.float32)
    tgt = (rng.uniform(size=(256, 4)) > 0.7).astype(np.float32)
    for alpha, gamma in ((0.25, 2.0), (-1.0, 2.0), (0.5, 1.5)):
        def f(x):
            return jax_retinanet.sigmoid_focal_loss(x, jnp.asarray(tgt),
                                                    alpha, gamma)
        want = f(jnp.asarray(logits))
        jgrad = jax.grad(lambda x: f(x).sum())(jnp.asarray(logits))
        x = t(logits).requires_grad_()
        got = retinanet.sigmoid_focal_loss(x, t(tgt), alpha, gamma)
        got.sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        retinanet.sigmoid_bce(t(logits), t(tgt)).numpy(),
        np.asarray(optax_sigmoid_bce(jnp.asarray(logits), jnp.asarray(tgt))),
        rtol=1e-6, atol=1e-7)


def test_group_norm_is_flax():
    """Float32 statistics with the variance E[x^2] - E[x]^2 and the output
    in the input's dtype.  The inputs sit on a mean of 3: on a larger one
    the formula's cancellation makes its result depend on the order of
    the sums (at 30, 1 % between flax and the port)."""
    from flax import linen as fnn

    rng = np.random.default_rng(2)
    x = (rng.normal(0, 1, (2, 6, 5, 64)) + 3.0).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = rng.normal(0, 0.1, 64).astype(np.float32)
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                         (torch.bfloat16, jnp.bfloat16, 0.0)):
        gn = fnn.GroupNorm(num_groups=32, epsilon=1e-5, dtype=jdt,
                           param_dtype=jnp.float32)
        xj = jnp.asarray(x).astype(jdt)
        want = gn.apply({"params": {"scale": scale, "bias": bias}}, xj)
        mod = retinanet.GroupNorm(32, 64, eps=1e-5)
        with torch.no_grad():
            mod.weight.copy_(t(scale))
            mod.bias.copy_(t(bias))
            got = mod(nchw(np.asarray(xj.astype(jnp.float32))).to(dt))
        assert got.dtype == dt
        got = got.float().permute(0, 2, 3, 1).numpy()
        want = np.asarray(want.astype(jnp.float32))
        if tol:
            close_to_largest(got, want, tol)
        else:
            # bf16 outputs: equal up to one rounding of the float32 value.
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


# -- pyramid, heads and the eval forward -------------------------------------

def test_pyramid(family):
    """P3..P7 to 1e-5 of each level's largest value; v2's P6 reads C5."""
    with torch.inference_mode():
        got = family["model"].features(t(images(3)))
    assert len(got) == 5 == len(family["pyramid"])
    for i, (g, w) in enumerate(zip(got, family["pyramid"])):
        close_to_largest(g.permute(0, 2, 3, 1).numpy(), w, 1e-5, f"P{i + 3}")
    p6 = family["model"].backbone.fpn.extra_blocks.p6
    assert p6.in_channels == (2048 if family["name"] == "retinanet_v2"
                              else 256)


def test_heads(family):
    """The subnets on JAX's pyramid: logits and deltas, location-major and
    anchor-minor, to 1e-5 of their largest (v2: GroupNorm, no conv
    bias)."""
    head = family["model"].head
    with torch.inference_mode():
        logits, deltas = head([nchw(p) for p in family["pyramid"]])
    for g, w in zip(logits + deltas, family["head"][0] + family["head"][1]):
        assert tuple(g.shape) == w.shape
        close_to_largest(g.numpy(), w, 1e-5)
    v2 = family["name"] == "retinanet_v2"
    conv0 = head.classification_head.conv[0]
    assert (conv0[0].bias is None) == v2
    assert isinstance(conv0[1], retinanet.GroupNorm) == v2


def check_detections(got, want, min_valid_share=0.5):
    v = np.asarray(want.valid)
    assert v.mean() >= min_valid_share, v.mean()
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-4)


def test_eval_forward(family):
    check_detections(family["got"], family["want"])
    assert family["got"].boxes.shape == (
        B, family["cfg"].model.detections_per_image, 4)


def check_single_nms(fam, module, imgs):
    """The postprocess's class-offset NMS: one call for the batch, one
    segment an image, presorted; its keep flags equal JAX's
    ``batched_nms_keep`` on the same pool, whose stable argsort of the
    masked scores is the identity."""
    calls = []
    launch = module.batched_nms_keep

    def recording(boxes, scores, idxs, t_, valid, presorted=False):
        keep = launch(boxes, scores, idxs, t_, valid, presorted=presorted)
        calls.append((boxes, scores, idxs, valid, presorted, keep))
        return keep

    module.batched_nms_keep = recording
    try:
        with torch.inference_mode():
            fam["model"](t(imgs))
    finally:
        module.batched_nms_keep = launch
    assert len(calls) == 1
    boxes, scores, idxs, valid, presorted, keep = calls[0]
    assert presorted and boxes.shape[0] == len(imgs)
    mcfg = fam["cfg"].model
    for i in range(len(imgs)):
        masked = jnp.where(jnp.asarray(valid[i].numpy()),
                           jnp.asarray(scores[i].numpy()), jax_nms.NEG_INF)
        order = np.asarray(jnp.argsort(-masked, stable=True))
        np.testing.assert_array_equal(order, np.arange(len(order)))
        want = jax_nms.batched_nms_keep(
            jnp.asarray(boxes[i].numpy()), jnp.asarray(scores[i].numpy()),
            jnp.asarray(idxs[i].numpy()), mcfg.nms_thresh,
            valid=jnp.asarray(valid[i].numpy()))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(want))
        assert 0 < int(keep[i].sum()) < int(valid[i].sum())
    assert float(scores.min()) > NEG_INF / 2 or not bool(valid.all())
    return boxes.shape


def test_single_class_offset_nms(family):
    s, n = check_single_nms(family, retinanet, images(3))[:2]
    # Every level's 1000 or fewer (anchor, class) pairs, merged.
    assert (s, n) == (B, min(5000, 1000 + 1000 + 16 * 27 + 4 * 27 + 27))


# -- one train step -------------------------------------------------------------

class RecordingLinen:
    """``flax.linen`` with ``relu`` recording, in trace order, whether each
    input is positive (``jax.debug.callback``), for a JAX model module to
    look up as its ``nn``."""

    def __init__(self):
        from flax import linen
        self._linen, self.signs, self.calls = linen, {}, 0

    def __getattr__(self, name):
        return getattr(self._linen, name)

    def relu(self, x):
        i, self.calls = self.calls, self.calls + 1
        jax.debug.callback(lambda m: self.signs.__setitem__(i, np.asarray(m)),
                           x > 0)
        return self._linen.relu(x)


BODY = [("body", i) for i in range(49)]   # the stem's, 3 per bottleneck


def jax_relu_order(family, levels=5):
    """Keys of the ReLUs the JAX model runs, in its order: the ResNet
    body's, P7's, then per level the class tower's four, the box tower's
    four (and FCOS's distances)."""
    keys = BODY + ["p7"]
    for lvl in range(levels):
        keys += [(t, lvl, i) for t in ("cls", "box") for i in range(4)]
        if family == "fcos":
            keys.append(("deltas", lvl, 0))
    return keys


def port_relu_order(family, levels=5):
    """The same ReLUs in the port's order: the body's, P7's, then the class
    tower over every level, then the box tower (with FCOS's distances
    after each level's tower)."""
    keys = BODY + ["p7"]
    keys += [("cls", lvl, i) for lvl in range(levels) for i in range(4)]
    for lvl in range(levels):
        keys += [("box", lvl, i) for i in range(4)]
        if family == "fcos":
            keys.append(("deltas", lvl, 0))
    return keys


def forced_relus(signs):
    """A dispatch mode that gives the port's ReLUs JAX's signs, in the
    port's order (``signs``: one bool array per call, None to leave the
    call alone): where they differ, the output is ``|x|`` or 0 as JAX's
    sign says.  ReLU's backward reads its output, so gradients then take
    JAX's path; forward values move by at most the flipped input.  Counts
    the flips."""
    from torch.utils._python_dispatch import TorchDispatchMode

    relu = torch.ops.aten.relu.default

    class Forced(TorchDispatchMode):
        calls, flips, inputs = 0, 0, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is not relu:
                return out
            k, self.calls = self.calls, self.calls + 1
            if k >= len(signs) or signs[k] is None:
                return out
            want = t(signs[k]).permute(0, 3, 1, 2) if signs[k].ndim == 4 \
                else t(signs[k])
            want = want.reshape(out.shape)
            self.flips += int((want != (args[0] > 0)).sum())
            self.inputs += want.numel()
            return torch.where(want, args[0].abs(), torch.zeros_like(out))

    return Forced()

def make_batch(seed):
    rng = np.random.default_rng(seed)
    boxes, labels, valid = gt_batch(rng, B, G)
    return {"image": rng.integers(0, 256, (B, 128, 128, 3), dtype=np.uint8),
            "boxes": boxes, "labels": labels, "valid": valid,
            "image_weight": np.float32([1.0, 0.5])}


def train_step(fam, seed=1):
    """One step in both packages from the same weights (as initialised,
    the prior on the class logits) and batch: JAX's loss and gradients as
    one compile, then its optimiser; the port's ``make_train_step``
    (``aug_policy="none"``, no model draws)."""
    jcfg, jmodel, variables = fam["jcfg"], fam["jmodel"], fam["raw"]
    batch = make_batch(seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    gt = {"boxes": jb["boxes"], "labels": jb["labels"], "valid": jb["valid"],
          "image_weight": jb["image_weight"]}

    def loss_fn(params):
        losses = jmodel.apply({"params": params,
                               "frozen": variables["frozen"]},
                              jax_step.images_to_float(jb["image"]), gt=gt,
                              train=True, rng=jax.random.PRNGKey(0))
        return sum(losses.values()), losses

    family = fam["cfg"].model.family
    linen = RecordingLinen()
    mp = pytest.MonkeyPatch()
    head_module = jax_fcos if family == "fcos" else jax_retinanet
    mp.setattr(head_module, "nn", linen)
    mp.setattr(jax_fpn, "nn", linen)
    mp.setattr(jax_resnet, "nn", linen)
    try:
        (total, jlosses), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"])
        jax.block_until_ready(jgrads)
        jax.effects_barrier()
    finally:
        mp.undo()
    order = jax_relu_order(family)
    assert linen.calls == len(order) == len(linen.signs)
    by_key = dict(zip(order, (linen.signs[i] for i in range(len(order)))))
    tx = jax_make_optimizer(jcfg.train, jcfg.model)
    jparams, _ = apply_optimizer(tx, jgrads, tx.init(variables["params"]),
                                 variables["params"], jnp.float32(LR))
    cfg = fam["cfg"]
    model = port_model(cfg.model, variables).train()
    step = make_train_step(model, make_optimizer(cfg.train, model), cfg,
                           device="cpu")
    draws = TrainDraws(augment=jax_augment_draws(jax.random.PRNGKey(1), B,
                                                 "none"), model=None)
    forced = forced_relus([by_key[k] for k in port_relu_order(family)])
    with forced:
        metrics = step({k: t(v) for k, v in batch.items()}, LR,
                       draws=draws)
    assert forced.calls == len(port_relu_order(family))
    return dict(model=model, flips=forced.flips, relu_inputs=forced.inputs,
                jgrads=jax.tree.map(np.asarray, jgrads),
                jparams=jax.tree.map(np.asarray, jparams),
                jmetrics={k: float(v) for k, v in
                          dict(jlosses, loss=total).items()},
                metrics={k: float(v) for k, v in metrics.items()
                         if k != "lr"})


def check_train_step(fam, one, names):
    got, want = one["metrics"], one["jmetrics"]
    assert set(got) == set(want) == set(names) | {"loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert all(np.isfinite(v) and v > 0 for v in got.values())
    # Sums in another order move ReLU inputs within rounding of zero
    # across it; the port's step took JAX's side of each (forced_relus).
    assert one["flips"] <= 1e-5 * one["relu_inputs"], one["flips"]
    frozen = fam["raw"]["frozen"]
    grads = state_dict_from_flax(one["jgrads"], frozen)
    params = state_dict_from_flax(one["jparams"], frozen)
    checked = 0
    for name, p in one["model"].named_parameters():
        if p.grad is None:
            assert not p.requires_grad and not np.any(grads[name]), name
            continue
        close_to_largest(p.grad.numpy(), grads[name], 2e-3, name)
        np.testing.assert_allclose(p.detach().numpy(), params[name], rtol=0,
                                   atol=1e-6, err_msg=name)
        checked += 1
    return checked


@pytest.fixture(scope="module")
def stepped(family):
    return train_step(family)


def test_train_step(family, stepped):
    checked = check_train_step(family, stepped,
                               ("classification", "bbox_regression"))
    named = dict(stepped["model"].named_parameters())
    assert named["head.classification_head.cls_logits.weight"].grad \
        is not None
    assert checked > 60


# -- the weight bridge -------------------------------------------------------

def test_bridge_keys(family):
    sd = family["model"].state_dict()
    jmap = JAX_KEY_MAPS[family["name"]]()
    mine = key_map(family=family["model"].cfg.family,
                   retinanet_head_norm=family["name"] == "retinanet_v2")
    assert {k for k, *_ in mine} == set(sd)
    for k, coll, path, _ in mine:
        assert jmap[k][:2] == (coll, path), k
    params, frozen = flax_from_state_dict(sd)
    v = family["variables"]
    for tree, want in ((params, v["params"]), (frozen, v["frozen"])):
        leaves = dict(jax.tree_util.tree_leaves_with_path(want))
        got = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert set(got) == set(leaves)
        for k, x in leaves.items():
            np.testing.assert_array_equal(got[k], x)


def torchvision_state_dict(fam, spelling, num_classes=4, seed=5):
    """A synthetic torchvision checkpoint of ``fam``'s layout, random
    values, with the subnets spelt ``spelling`` ("nested" conv.{i}.0,
    "plain" conv.{2i}, the pre-0.13 v1 form, with the FPN's unnested
    convs) and ``cls_logits`` for ``num_classes``."""
    rng = np.random.default_rng(seed)
    mcfg = dataclasses.replace(fam["cfg"].model, num_classes=num_classes)
    out = {}
    for k, v in make_detector(mcfg).state_dict().items():
        if spelling == "plain":
            parts = k.split(".")
            if parts[:1] == ["head"] and parts[2] == "conv":
                parts[3:5] = [str(2 * int(parts[3]))]
            k = ".".join(parts)
        elif k.startswith("backbone.fpn.") and "extra" not in k:
            k = k.replace(".weight", ".0.weight").replace(".bias", ".0.bias")
        out[k] = torch.from_numpy(
            rng.normal(0, 0.1, tuple(v.shape)).astype(np.float32))
    return out


# (checkpoint's family, model's family, spelling, checkpoint's classes):
# each spelling and layout, a mis-sized cls_logits in each layout, and
# either layout into the other model.
LAYOUTS = [("retinanet", "retinanet", "plain", 4),
           ("retinanet", "retinanet", "nested", 91),
           ("retinanet_v2", "retinanet_v2", "nested", 91),
           ("retinanet", "retinanet_v2", "plain", 4),
           ("retinanet_v2", "retinanet", "nested", 4)]


@pytest.fixture(scope="module")
def bridge_families():
    return {n: setup_family(n) for n in PRESETS}


@pytest.mark.parametrize("ckpt, into, spelling, classes", LAYOUTS)
def test_load_pretrained_torchvision(bridge_families, tmp_path, capsys,
                                     ckpt, into, spelling, classes):
    """The port's ``load_pretrained`` of a torchvision ``.pth`` equals
    JAX's on the same file, from the same start: what loads, what is
    skipped (a mis-sized ``cls_logits``, v1's conv biases in a v2 model,
    v1's P6 over P5 in a v2 model)."""
    fams = bridge_families
    path = str(tmp_path / "tv.pth")
    torch.save(torchvision_state_dict(fams[ckpt], spelling, classes), path)
    v = fams[into]["variables"]
    want = jax_weights.load_pretrained(
        {"params": v["params"], "frozen": v["frozen"]}, path, verbose=False)
    model = port_model(fams[into]["cfg"].model, v)
    load_pretrained(model, path)
    printed = capsys.readouterr().out
    assert f"torchvision {ckpt} layout" in printed
    want = state_dict_from_flax(jax.tree.map(np.asarray, want["params"]),
                                jax.tree.map(np.asarray, want["frozen"]))
    got = model.state_dict()
    before = fams[into]["model"].state_dict()
    changed = 0
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
        changed += not np.array_equal(before[k].numpy(), w)
    assert changed > 250
    logits = "head.classification_head.cls_logits.weight"
    assert np.array_equal(got[logits].numpy(), before[logits].numpy()) \
        == (classes != 4)


# -- the driver, inference and serving --------------------------------------

def test_train_epoch_stores_the_v2_recipe(tmp_path):
    jcfg = tiny_config()
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    project = make_project(str(tmp_path / "images"), num_images=6, seed=4)
    model_dir = port_train.train(
        port_project(project), output_dir=str(tmp_path / "models"),
        name="r2", batch_size=2, max_epochs=1, alrs_epochs=2,
        alrs_startup_factor=1, config=cfg, num_workers=2, seed=0,
        family="retinanet_v2", device="cpu")
    _, model, mcfg, labels = inference.load_inference_model(model_dir,
                                                            device="cpu")
    assert mcfg == model_config_from_dict(dataclasses.asdict(
        jax_retinanet_v2_config(dataclasses.replace(
            jcfg.model, num_classes=2, trainable_backbone_stages=5))))
    assert (mcfg.family, mcfg.retinanet_head_norm, mcfg.retinanet_box_loss,
            mcfg.retinanet_p6_on_c5) == ("retinanet", True, "giou", True)
    assert "head.classification_head.conv.3.1.weight" in model.state_dict()
    assert os.path.exists(os.path.join(model_dir, "results.txt"))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A JAX-saved lifted RetinaNet v1 model directory and a project of
    which two images are labelled."""
    root = tmp_path_factory.mktemp("retinanet_infer")
    fam = setup_family("retinanet")
    model_dir = str(root / "model")
    jax_ckpt.save_model(model_dir, fam["variables"]["params"],
                        fam["variables"]["frozen"], fam["jcfg"].model,
                        LABELS)
    jax_ckpt.save_labels(model_dir, LABELS)
    project = make_project(str(root / "images"), num_images=5,
                           labels=LABELS, seed=1)
    return dict(model_dir=model_dir, project=project, fam=fam)


def test_infer_evaluate_and_serve(saved, tmp_path):
    jp = copy.deepcopy(saved["project"])
    for k in list(jp.image_dict)[2:]:
        jp.image_dict[k].boxes = []
    model_file = os.path.join(saved["model_dir"], "model.msgpack")
    want = jax_inference.infer(jp, model_file, threshold=0.6, batch_size=2,
                               num_workers=2)
    got = inference.infer(port_project(jp), model_file, threshold=0.6,
                          batch_size=2, num_workers=2, device="cpu")
    assert assert_same_annotations(got, want) > 0
    stats = port_train.evaluate_model(port_project(saved["project"]),
                                      saved["model_dir"], batch_size=2,
                                      num_workers=2, device="cpu")
    want_stats = jax_train.evaluate_model(saved["project"],
                                          saved["model_dir"], batch_size=2,
                                          num_workers=2)
    np.testing.assert_allclose(stats, want_stats, rtol=0, atol=1e-3)
    server = DetectionServer(saved["model_dir"], batch_size=2, device="cpu")
    try:
        img = images(9, 1)[0]
        out = server.detect_array(img, 0.6)
    finally:
        server.close()
    want_det = cached_eval_step(saved["fam"]["jmodel"])(
        saved["fam"]["variables"]["params"],
        saved["fam"]["variables"]["frozen"], jnp.asarray(
            np.stack([img, np.zeros_like(img)])))
    keep = np.asarray(want_det.valid[0]) & (np.asarray(want_det.scores[0])
                                            > 0.6)
    assert len(out["detections"]) == int(keep.sum()) > 0
    for d, box, score in zip(out["detections"],
                             np.asarray(want_det.boxes[0])[keep],
                             np.asarray(want_det.scores[0])[keep]):
        np.testing.assert_allclose(d["box"], box, rtol=0, atol=1e-3)
        np.testing.assert_allclose(d["score"], score, rtol=0, atol=1e-4)
