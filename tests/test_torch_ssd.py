"""SSD300-VGG16 in podtpu_torch against podtpu (CPU, float32, 4 classes,
small capacities; VGG16's widths are its own, having no width knob).

* The configs (``ssd_config``, ``ssdlite_config`` and their grids at every
  canvas from 268 to 330) and the default boxes at 300x300 with the
  recipe's steps and at SSDLite's 320x320, exactly.
* ``match_ssd`` with two gts sharing a best box and an image without gts,
  exactly; ``ssd_losses`` with image weights and tied hard negatives,
  1e-6.
* ``ssd_postprocess`` at 4 classes, and at 32 with 8 candidates a class:
  the port's one NMS segment per (image, class), all in one launch,
  against JAX's merged pool of 31 x 8 candidates an image: boxes 1e-3,
  scores 1e-4, labels and validity exactly.
* The ``ssd`` policy on JAX's draws, JAX run eagerly (under jit XLA
  contracts the resample into FMAs), masks and keypoints included:
  images 1e-6, boxes 1e-5, validity exactly.
* VGG16SSD's six maps at 268x268, the smallest canvas whose maps are all
  non-empty, 1e-5 of their largest, and the eval forward there (one JAX
  compile for both); the class head's kernel is scaled by 30, so that a
  random model's scores do not tie within rounding.
* One train step under the ``ssd`` policy on JAX's draws with VGG16's
  five stages frozen (``trainable_backbone_stages=0``; fc6, fc7, the
  L2Norm scale, the extras and the heads train): losses 1e-5, gradients
  2e-3 of each tensor's largest, parameters after the update 1e-6, the
  port's ReLUs given JAX's signs
  (``tests/test_torch_retinanet.py::forced_relus``).  With the 3x3 conv
  stages training their weight gradients part by 1e-3 of their largest
  between the packages: see ``vgg_step``.  JAX's optimiser mask names
  ResNet's modules; its ``"conv1"`` takes VGG16's ``conv1_1`` and
  ``conv1_2`` out of the update, while ``conv2_x`` to ``conv5_x``, frozen
  by the detach only, get zero gradients and are still decayed: the port
  does the same.
* The weight bridge both ways against ``ssd_vgg16_key_map``, and
  ``load_pretrained`` of synthetic ``ssd300_vgg16`` and ImageNet
  ``vgg16`` state dicts against the JAX package's.
* ``train()``'s SSD refusals as the JAX package's.

The SSDLite half is ``tests/test_torch_ssdlite.py``, which uses this
file's helpers.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from podtpu.core import config as jax_config_mod
from podtpu.data import presets as jax_presets
from podtpu.models import ssd as jax_ssd
from podtpu.models import vgg as jax_vgg
from podtpu.models import weights as jax_weights
from podtpu.models.detector import make_detector as jax_make_detector
from podtpu.models.resnet import FrozenBatchNorm
from podtpu.ops import anchors as jax_anchors
from podtpu.train import optim as jax_optim
from podtpu.train import train as jax_train
from podtpu.train.step import images_to_float
from podtpu_torch.core import config as port_config_mod
from podtpu_torch.core.config import config_from_dict
from podtpu_torch.data import presets
from podtpu_torch.models import ssd
from podtpu_torch.models.detector import init_parameters, make_detector
from podtpu_torch.models.weights import (flax_from_state_dict,
                                         load_pretrained,
                                         state_dict_from_flax)
from podtpu_torch.ops import anchors, nms
from podtpu_torch.ops import image_ops as T
from podtpu_torch.train import train as port_train
from podtpu_torch.train.optim import make_optimizer
from podtpu_torch.train.step import TrainDraws, make_train_step
from tests.conftest import tiny_config
from tests.synthetic import make_project
from tests.test_torch_augment import jax_photometric_draws, stack_photometric
from tests.test_torch_mask import torch_threads  # noqa: F401
from tests.test_torch_mobilenet import assert_same_detections, tree_equal
from tests.test_torch_retinanet import RecordingLinen, forced_relus
from tests.test_torch_train_ops import gt_batch
from tests.test_torch_v2 import canvas_batch

B, G, LR = 2, 8, 0.005
CANVAS = 268
# Gradients held absolutely: an exact zero's float32 rounding.
ZERO_GRADIENT = 1e-6


def t(a):
    return torch.from_numpy(np.array(a))


def jax_config(family="ssd", **model_kw):
    """The tiny config as ``family`` ("ssd" or "ssdlite") at ``CANVAS``
    (SSDLite at its 320), 4 classes, 16 detections, 32 candidates a class;
    ``model_kw`` overrides model fields."""
    cfg = tiny_config()
    make = {"ssd": jax_config_mod.ssd_config,
            "ssdlite": jax_config_mod.ssdlite_config}[family]
    size = (CANVAS, CANVAS) if family == "ssd" else (320, 320)
    model = make(dataclasses.replace(cfg.model, num_classes=4),
                 image_size=size, detections_per_image=16,
                 ssd_topk_per_class=32)
    return dataclasses.replace(cfg, model=dataclasses.replace(model,
                                                              **model_kw))


def port_config(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def start_variables(jcfg, seed, cls_scale=30.0):
    """Flax trees of a port model of ``jcfg`` from the port's seeded
    initialisation, every norm's vectors drawn near the identity and the
    class head's kernels scaled by ``cls_scale``."""
    model = make_detector(port_config(jcfg).model)
    init_parameters(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if hasattr(mod, "running_var"):
                for leaf in ("weight", "running_var"):
                    x = getattr(mod, leaf)
                    x.copy_(t(rng.uniform(0.8, 1.25, x.shape)))
                for leaf in ("bias", "running_mean"):
                    x = getattr(mod, leaf)
                    x.copy_(t(rng.normal(0, 0.05, x.shape)))
            elif name.startswith("head.classification_head.module_list"):
                if isinstance(mod, torch.nn.Conv2d):
                    mod.weight.mul_(cls_scale)
    params, frozen = flax_from_state_dict(model.state_dict())
    return {"params": params, "frozen": frozen}


def port_model(jcfg, variables):
    model = make_detector(port_config(jcfg).model)
    sd = state_dict_from_flax(variables["params"], variables["frozen"])
    model.load_state_dict({k: t(v) for k, v in sd.items()}, strict=False)
    return model.to(memory_format=torch.channels_last)


def jax_eval(jcfg, variables, images):
    """JAX's eval forward and the extractor's maps, as one compile."""
    model = jax_make_detector(jcfg.model)

    def run(v, x):
        return (model.apply(v, x, train=False),
                model.apply(v, x, method=lambda m, y: m._features(y)))

    return jax.jit(run)(variables, jnp.asarray(images))


def check_eval(jcfg, variables, images):
    """The port's maps and eval forward against JAX's; returns the port
    model."""
    model = port_model(jcfg, variables)
    want, feats = jax_eval(jcfg, variables, images)
    with torch.inference_mode():
        maps = model.features(t(images))
        got = model(t(images))
    assert [tuple(m.shape[2:]) for m in maps] == [
        tuple(s) for s in jcfg.model.ssd_feature_shapes]
    for g, w in zip(maps, feats):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    assert_same_detections(got, want)
    return model


# -- draws along JAX's split tree ------------------------------------------

def _zoom_crop(k_zoom, k_crop):
    zoom = None
    if k_zoom is not None:
        k_apply, k_out = k_zoom
        kr, kx, ky = jax.random.split(k_out, 3)
        zoom = dict(apply=float(jax.random.uniform(k_apply)),
                    ratio=float(jax.random.uniform(kr, (), minval=1.0,
                                                   maxval=4.0)),
                    x=float(jax.random.uniform(kx)),
                    y=float(jax.random.uniform(ky)))
    k0, k1, k2, k3, k4 = jax.random.split(k_crop, 5)
    trials = T.CROP_TRIALS
    crop = dict(option=int(jax.random.randint(k0, (), 0,
                                              len(T.CROP_MIN_IOUS))),
                w=np.asarray(jax.random.uniform(k1, (trials,), minval=0.3,
                                                maxval=1.0)),
                h=np.asarray(jax.random.uniform(k2, (trials,), minval=0.3,
                                                maxval=1.0)),
                x=np.asarray(jax.random.uniform(k3, (trials,))),
                y=np.asarray(jax.random.uniform(k4, (trials,))))
    return zoom, crop


def jax_ssd_draws(rng_aug, b, policy):
    """The ``ssd`` or ``ssdlite`` policy's draws for a batch: one key an
    image (``presets.py:213``); ``ssd_policy`` splits it into photometric,
    zoom decision, zoom-out, crop and flip keys, ``ssdlite_policy`` into
    crop and flip keys; the zoom-out splits into ratio, x and y
    (``image_ops.py:209``), the crop into the floor's index and the four
    trial vectors (``:233``), the flips into h and v."""
    hf, vf, photo, zooms, crops = [], [], [], [], []
    for r in jax.random.split(rng_aug, b):
        if policy == "ssd":
            k1, k2, k3, k4, k5 = jax.random.split(r, 5)
            photo.append(jax_photometric_draws(k1))
            zoom, crop = _zoom_crop((k2, k3), k4)
            zooms.append(zoom)
        else:
            k4, k5 = jax.random.split(r)
            _, crop = _zoom_crop(None, k4)
            # ``AugmentDraws`` carries photometric draws; ssdlite reads none.
            photo.append(jax_photometric_draws(k4))
        crops.append(crop)
        kh, kv = jax.random.split(k5)
        hf.append(float(jax.random.uniform(kh)))
        vf.append(float(jax.random.uniform(kv)))

    def stack(rows, cls):
        return cls(**{k: t(np.stack([np.asarray(r[k]) for r in rows]).astype(
            np.int64 if k == "option" else np.float32)) for k in cls._fields})

    return presets.AugmentDraws(
        hflip=t(np.float32(hf)), vflip=t(np.float32(vf)),
        photometric=stack_photometric(photo),
        zoom=stack(zooms, T.ZoomDraws) if policy == "ssd" else None,
        crop=stack(crops, T.CropDraws))


def check_policy(policy, targets):
    """``policy`` on JAX's draws against JAX's, eagerly, over 8 images."""
    img, boxes, masks, kps = canvas_batch(30, b=8, h=32, w=32, k=17)
    valid = np.random.default_rng(31).uniform(size=boxes.shape[:2]) > 0.2
    rng = jax.random.PRNGKey(32)
    m = masks if targets == "masks" else None
    k = kps if targets == "keypoints" else None
    kw = {"kp_hflip_inds": port_config_mod.COCO_17_HFLIP_INDS} \
        if k is not None else {}
    want = jax_presets.augment_batch_policy(
        jax_presets.get_policy(policy), rng, jnp.asarray(img),
        jnp.asarray(boxes), jnp.asarray(valid),
        masks=None if m is None else jnp.asarray(m),
        keypoints=None if k is None else jnp.asarray(k), **kw)
    draws = jax_ssd_draws(rng, 8, policy)
    got = presets.augment_batch_policy(
        presets.get_policy(policy), t(img), t(boxes), t(valid), draws,
        masks=None if m is None else t(m),
        keypoints=None if k is None else t(k), **kw)
    gi, gb, gv, gm, gk = got
    wi, wb, wv, wm, wk = want
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert (gm is None) == (m is None) and (gk is None) == (k is None)
    if m is not None:
        np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=0,
                                   atol=1e-6)
    if k is not None:
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(gk[..., 2].numpy(),
                                      np.asarray(wk)[..., 2])
    # The batch takes both branches of each decision.
    assert len(set(draws.crop.option.tolist())) > 2
    assert (draws.crop.option == len(T.CROP_MIN_IOUS) - 1).any()
    if policy == "ssd":
        zoomed = draws.zoom.apply < 0.5
        assert zoomed.any() and not zoomed.all()
    return draws


# -- one train step -----------------------------------------------------------

def jax_train_step(jcfg, variables, batch, key, relus=None):
    """The JAX step: its augmentation eagerly, losses and gradients as one
    compile (``frozen`` mutable, every norm's output captured; with
    ``relus``, a JAX module whose ``nn`` then records each ReLU input's
    sign), then the optimiser."""
    jmodel = jax_make_detector(jcfg.model)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rng_aug, rng_model = jax.random.split(key)
    images, boxes, valid, _, _ = jax_presets.augment_batch_policy(
        jax_presets.get_policy(jcfg.data.aug_policy), rng_aug,
        images_to_float(jb["image"]), jb["boxes"], jb["valid"],
        **jax_presets.policy_kwargs(jcfg))
    gt = {"boxes": boxes, "labels": jb["labels"], "valid": valid}
    frozen = variables["frozen"]

    def loss_fn(params):
        losses, muts = jmodel.apply(
            {"params": params, "frozen": frozen}, images, gt=gt, train=True,
            rng=rng_model, mutable=["frozen", "intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(
                mdl, FrozenBatchNorm))
        return sum(losses.values()), (losses, muts.get("frozen", {}),
                                      muts.get("intermediates", {}))

    linen = RecordingLinen()
    mp = pytest.MonkeyPatch()
    if relus is not None:
        mp.setattr(relus, "nn", linen)
    try:
        (total, (losses, new_frozen, norms)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
        jax.block_until_ready(grads)
        jax.effects_barrier()
    finally:
        mp.undo()
    tx = jax_optim.make_optimizer(jcfg.train, jcfg.model)
    params, _ = jax.jit(lambda g, s, p: jax_optim.apply_optimizer(
        tx, g, s, p, jnp.float32(LR)))(
        grads, tx.init(variables["params"]), variables["params"])
    as_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return dict(losses={k: float(v) for k, v in
                        dict(losses, loss=total).items()},
                grads=as_np(grads), frozen=as_np(new_frozen),
                params=as_np(params), norms=as_np(norms),
                relu_signs=[linen.signs[i] for i in range(linen.calls)])


def make_batch(seed, canvas):
    rng = np.random.default_rng(seed)
    boxes, labels, valid = gt_batch(rng, B, G, canvas=float(canvas))
    return {"image": rng.integers(0, 256, (B, canvas, canvas, 3),
                                  dtype=np.uint8),
            "boxes": boxes, "labels": labels, "valid": valid}


def run_step(jcfg, variables, seed, forced=None, relus=None):
    """One step of both packages from ``variables`` on batch ``seed`` and
    JAX key ``seed``'s draws; ``forced(model, norms)``: a context in which
    the port's norms take JAX's captured outputs; ``relus``: the JAX module
    whose ReLUs' signs the port's ReLUs then take (``forced_relus``, in
    the same order in both)."""
    batch = make_batch(seed, jcfg.model.image_size[0])
    key = jax.random.PRNGKey(seed)
    want = jax_train_step(jcfg, variables, batch, key, relus)
    model = port_model(jcfg, variables)
    cfg = port_config(jcfg)
    optimizer = make_optimizer(cfg.train, model)
    step = make_train_step(model, optimizer, cfg, device="cpu")
    draws = TrainDraws(augment=jax_ssd_draws(
        jax.random.split(key)[0], B, jcfg.data.aug_policy), model=None)
    signs = forced_relus(want["relu_signs"])
    with contextlib.ExitStack() as stack:
        gaps = stack.enter_context(forced(model, want["norms"])) \
            if forced else {}
        if relus is not None:
            stack.enter_context(signs)
        metrics = step({k: t(v) for k, v in batch.items()}, LR, draws=draws)
    assert signs.calls == (len(want["relu_signs"]) if relus else 0)
    return dict(want=want, model=model, optimizer=optimizer, gaps=gaps,
                variables=variables, flips=signs.flips,
                metrics={k: float(v) for k, v in metrics.items()
                         if k != "lr"})


def check_step(one, masked=(), detached=()):
    """Losses, gradients, parameters and running statistics of ``one``
    against JAX's.  Parameters under ``masked`` are out of both optimisers
    (no gradient, unchanged); under ``detached`` they get zero gradients
    and are still moved by weight decay."""
    want, model = one["want"], one["model"]
    assert set(one["metrics"]) == set(want["losses"])
    for k, w in want["losses"].items():
        np.testing.assert_allclose(one["metrics"][k], w, rtol=1e-5,
                                   err_msg=k)
    frozen = one["variables"]["frozen"]
    grads = state_dict_from_flax(want["grads"], frozen)
    params = state_dict_from_flax(want["params"], want["frozen"] or frozen)
    before = state_dict_from_flax(one["variables"]["params"], frozen)
    in_optimizer = {id(p) for g in one["optimizer"].param_groups
                    for p in g["params"]}
    counts = dict(masked=0, detached=0, checked=0)
    for name, p in model.named_parameters():
        if name.startswith(masked):
            counts["masked"] += 1
            assert id(p) not in in_optimizer and p.grad is None, name
            np.testing.assert_array_equal(p.detach().numpy(), before[name])
            np.testing.assert_array_equal(params[name], before[name])
            continue
        g = p.grad.numpy()
        scale = float(np.abs(grads[name]).max())
        if name.startswith(detached):
            counts["detached"] += 1
            assert not np.any(g) and not np.any(grads[name]), name
            # Decayed: moved unless zero.
            assert np.array_equal(p.detach().numpy(), before[name]) \
                == (not np.any(before[name])), name
        elif scale < ZERO_GRADIENT:
            # A bias whose every path runs into a training norm's mean has
            # an exact gradient of 0: both must be within rounding of it.
            assert float(np.abs(g).max()) < ZERO_GRADIENT, name
        else:
            np.testing.assert_allclose(g, grads[name], rtol=0,
                                       atol=2e-3 * scale, err_msg=name)
            counts["checked"] += 1
        np.testing.assert_allclose(p.detach().numpy(), params[name], rtol=0,
                                   atol=1e-6, err_msg=name)
    assert counts["masked"] == 2 * len(masked)
    assert (counts["detached"] > 0) == bool(detached)
    for name, b in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            w = params[name]
            np.testing.assert_allclose(b.numpy(), w, rtol=0,
                                       atol=1e-6 * max(1.0, np.abs(w).max()),
                                       err_msg=name)
    return counts


# -- configs, default boxes, matching, losses, postprocess ------------------

def test_configs_and_default_boxes():
    for make in ("ssd_config", "ssdlite_config"):
        for kw in ({}, {"image_size": (CANVAS, CANVAS)}):
            got = getattr(port_config_mod, make)(**kw)
            want = getattr(jax_config_mod, make)(**kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            boxes = anchors.default_boxes(
                got.image_size, got.ssd_feature_shapes, got.ssd_scales,
                got.ssd_aspect_ratios, got.ssd_steps)
            ref = jax_anchors.default_boxes(
                want.image_size, want.ssd_feature_shapes, want.ssd_scales,
                want.ssd_aspect_ratios, want.ssd_steps)
            assert len(boxes) == len(ref) == 6
            for g, w in zip(boxes, ref):
                np.testing.assert_array_equal(g, w)
    assert port_config_mod.ssd_config().ssd_steps == (8, 16, 32, 64, 100,
                                                      300)
    for s in range(CANVAS, 331):
        for fn in ("vgg_ssd_feature_shapes", "mobilenet_v3_feature_shapes"):
            assert getattr(port_config_mod, fn)((s, s + 3)) == \
                getattr(jax_config_mod, fn)((s, s + 3))
    assert min(min(s) for s in port_config_mod.vgg_ssd_feature_shapes(
        (CANVAS, CANVAS))) == 1
    assert min(min(s) for s in port_config_mod.vgg_ssd_feature_shapes(
        (CANVAS - 1, CANVAS - 1))) == 0


def test_match_ssd_collisions_and_empty_image():
    rng = np.random.default_rng(3)
    iou = rng.uniform(0, 0.6, (3, 40, 5)).astype(np.float32)
    valid = np.array([[1, 1, 1, 0, 1], [1, 1, 1, 1, 1], [0] * 5], bool)
    # Gts 1 and 4 share their best box 7 (the later one wins); gt 2's best
    # IoU ties between boxes 3 and 9 (the first argmax wins); box 11 ties
    # between gts 0 and 2.
    iou[0, 7, [1, 4]] = 0.95
    iou[0, [3, 9], 2] = 0.9
    iou[0, 11, [0, 2]] = 0.7
    iou[1, :, 3] = 0.0  # a valid gt that overlaps nothing forces nothing
    idx, labels = ssd.match_ssd(t(iou), t(valid), 0.5)
    for i in range(3):
        w = jax_ssd.match_ssd(jnp.asarray(iou[i]), jnp.asarray(valid[i]),
                              0.5)
        np.testing.assert_array_equal(idx[i].numpy(),
                                      np.asarray(w.matched_idx))
        np.testing.assert_array_equal(labels[i].numpy(), np.asarray(w.labels))
    assert int(idx[0, 7]) == 4 and int(labels[2].sum()) == 0


def random_head(seed, n, c, b=3, tie=True):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (b, n, c)).astype(np.float32)
    if tie:
        # Negatives with equal cross-entropy: the rank keeps index order.
        logits[:, 5:25] = logits[:, 4:5]
    deltas = rng.normal(0, 0.5, (b, n, 4)).astype(np.float32)
    return logits, deltas


def small_anchors(canvas=64):
    cfg = port_config_mod.ssd_config(image_size=(canvas, canvas))
    shapes = ((4, 4), (2, 2), (2, 2), (1, 1), (1, 1), (1, 1))
    grids = anchors.default_boxes((canvas, canvas), shapes, cfg.ssd_scales,
                                  cfg.ssd_aspect_ratios)
    return np.concatenate(grids), cfg


def test_ssd_losses_with_image_weights_and_ties():
    anc, pcfg = small_anchors()
    logits, deltas = random_head(4, len(anc), 4)
    rng = np.random.default_rng(5)
    boxes, labels, valid = gt_batch(rng, 3, 6, canvas=64.0)
    weight = np.float32([1.0, 0.0, 0.5])
    gt = dict(boxes=boxes, labels=labels, valid=valid, image_weight=weight)
    got = ssd.ssd_losses(t(logits), t(deltas), t(anc),
                         {k: t(v) for k, v in gt.items()}, pcfg)
    want = jax_ssd.ssd_losses(jnp.asarray(logits), jnp.asarray(deltas),
                              jnp.asarray(anc),
                              {k: jnp.asarray(v) for k, v in gt.items()},
                              jax_config_mod.ssd_config(
                                  image_size=(64, 64)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)
        assert float(want[k]) > 0


@pytest.mark.parametrize("classes, per_class", [(4, 40), (32, 8)])
def test_ssd_postprocess_per_class_segments(classes, per_class,
                                            monkeypatch):
    anc, _ = small_anchors()
    logits, deltas = random_head(6, len(anc), classes, b=2, tie=False)
    kw = dict(image_size=(64, 64), num_classes=classes,
              ssd_topk_per_class=per_class, detections_per_image=48,
              score_thresh=0.02)
    calls = []
    plain = nms.nms_keep_batched

    def recorded(boxes, valid, t_, order=None):
        keep = plain(boxes, valid, t_, order)
        calls.append((tuple(boxes.shape), int(valid.sum()), int(keep.sum())))
        return keep

    monkeypatch.setattr(nms, "nms_keep_batched", recorded)
    got = ssd.ssd_postprocess(t(logits), t(deltas), t(anc),
                              port_config_mod.ssd_config(**kw))
    want = jax_ssd.ssd_postprocess(jnp.asarray(logits), jnp.asarray(deltas),
                                   jnp.asarray(anc),
                                   jax_config_mod.ssd_config(**kw))
    # One launch of one segment per (image, foreground class), and NMS
    # suppressed some of the candidates.
    [(shape, candidates, kept)] = calls
    assert shape == (2 * (classes - 1), per_class, 4)
    assert 0 < kept < candidates
    assert_same_detections(got, want)


@pytest.mark.parametrize("targets", ["boxes", "masks", "keypoints"])
def test_ssd_policy(targets):
    draws = check_policy("ssd", targets)
    assert draws.zoom is not None and draws.crop.w.shape == (8, 20)


# -- the model ---------------------------------------------------------------

@pytest.fixture(scope="module")
def vgg_vars():
    return start_variables(jax_config(), 1)


def test_bridge_both_ways(vgg_vars):
    model = port_model(jax_config(), vgg_vars)
    sd = model.state_dict()
    assert set(sd) == set(jax_weights.ssd_vgg16_key_map()) - {
        k for k in jax_weights.ssd_vgg16_key_map() if k.startswith(
            "features.")}
    back, (loaded, skipped) = jax_weights.convert_torchvision_state_dict(
        sd, vgg_vars, return_stats=True)
    assert not skipped and loaded == len(sd)
    assert tree_equal(back, vgg_vars)
    params, frozen = flax_from_state_dict(sd)
    assert not frozen and tree_equal(params, vgg_vars["params"])
    assert float(sd["backbone.scale_weight"][0]) == 20.0


def test_load_pretrained_ssd300_and_vgg16(vgg_vars, tmp_path, capsys):
    rng = np.random.default_rng(7)
    jcfg = jax_config()
    own = port_model(jcfg, vgg_vars).state_dict()
    full = {k: t(rng.normal(0, 0.1, v.shape).astype(np.float32))
            for k, v in own.items()}
    # A COCO checkpoint's class-sized heads (91 classes) are skipped.
    for k in range(6):
        w = full[f"head.classification_head.module_list.{k}.weight"]
        full[f"head.classification_head.module_list.{k}.weight"] = \
            t(np.zeros((w.shape[0] // 4 * 91, *w.shape[1:]), np.float32))
    vgg = {f"features.{i}.{leaf}": t(rng.normal(0, 0.1, shape).astype(
        np.float32)) for i, cin, cout in zip(
            (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28),
            (3, 64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512),
            (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512))
        for leaf, shape in (("weight", (cout, cin, 3, 3)),
                            ("bias", (cout,)))}
    vgg["classifier.0.weight"] = t(np.zeros((8, 4), np.float32))
    for name, payload in (("ssd300.pth", full), ("vgg16.pth", vgg)):
        path = str(tmp_path / name)
        torch.save(payload, path)
        model = port_model(jcfg, vgg_vars)
        load_pretrained(model, path)
        want = jax_weights.load_pretrained(vgg_vars, path)
        params, _ = flax_from_state_dict(model.state_dict())
        assert tree_equal(params, want["params"])
        assert not tree_equal(params, vgg_vars["params"])
    printed = capsys.readouterr().out
    assert "torchvision ssd layout" in printed
    assert "torchvision vgg16 layout" in printed


def test_maps_and_eval_forward(vgg_vars):
    jcfg = jax_config()
    images = np.random.default_rng(8).integers(0, 256, (B, CANVAS, CANVAS, 3),
                                               dtype=np.uint8)
    check_eval(jcfg, vgg_vars, images)


@pytest.fixture(scope="module")
def vgg_step():
    """The step from the plain initialisation (a scaled class head's
    gradients are too large for the parameters to meet 1e-6) with VGG16's
    five stages frozen and the port's 23 ReLUs given JAX's signs.  With
    conv3_x to conv5_x training, the weight gradients of their 3x3
    convolutions (inputs of about 100 at the Caffe recipe's 0-255 scale,
    all non-negative, summed against gradients of either sign) part by up
    to 1e-3 of their largest between the packages, while fc6, fc7, the
    extras and the heads agree within 2e-6: past what 1e-6 on the
    parameters allows at lr 0.005."""
    jcfg = dataclasses.replace(
        jax_config(trainable_backbone_stages=0),
        data=dataclasses.replace(tiny_config().data, aug_policy="ssd"))
    return run_step(jcfg, start_variables(jcfg, 1, cls_scale=1.0), 11,
                    relus=jax_vgg)


def test_train_step(vgg_step):
    counts = check_step(
        vgg_step, masked=("backbone.features.0.", "backbone.features.2."),
        detached=tuple(f"backbone.features.{i}." for i in
                       (5, 7, 10, 12, 14, 17, 19, 21))
        + tuple(f"backbone.extra.0.{i}." for i in (1, 3, 5)))
    assert counts["detached"] == 22 and counts["checked"] >= 10
    assert len(vgg_step["want"]["relu_signs"]) == 23
    # Flips are rare: a few in some 30 million ReLU inputs.
    assert vgg_step["flips"] < 100


# -- train() ------------------------------------------------------------------

@pytest.fixture(scope="module")
def project(tmp_path_factory):
    return make_project(str(tmp_path_factory.mktemp("ssd") / "images"),
                        num_images=4, seed=3)


@pytest.mark.parametrize("kwargs", [
    dict(family="ssd", with_mask=True),
    dict(family="ssdlite", with_keypoints=True),
    dict(family="ssdlite", backbone="mobilenet_v2"),
    dict(family="ssd", backbone="mobilenet_v3"),
])
def test_train_refusals_as_in_jax(project, tmp_path, kwargs):
    from tests.test_torch_data import port_project

    with pytest.raises(ValueError) as want:
        jax_train.train(project, output_dir=str(tmp_path), **kwargs)
    with pytest.raises(ValueError) as got:
        port_train.train(port_project(project), output_dir=str(tmp_path),
                         device="cpu", **kwargs)
    assert str(got.value) == str(want.value)


def test_make_detector_refusals():
    """Masks, keypoints and a foreign backbone, as ``build_model`` (its
    refusals) and the SSD module (the backbone's) refuse them."""
    from podtpu.models.detector import build_model
    from podtpu_torch.core.config import ModelConfig, ssd_config

    for cfg in (ssd_config(with_mask=True), ssd_config(with_keypoints=True),
                ModelConfig(family="ssd")):
        with pytest.raises(ValueError) as got:
            make_detector(cfg)
        jcfg = jax_config_mod.ModelConfig(**dataclasses.asdict(cfg))
        with pytest.raises(ValueError) as want:
            model, _ = build_model(4, jcfg)
            model.init(jax.random.PRNGKey(0), jnp.zeros((1, 300, 300, 3)))
        assert str(got.value) == str(want.value)
