"""Mask R-CNN and copy-paste in podtpu_torch against podtpu (CPU).

At ``tests/conftest.py::tiny_config`` sizes with ``with_mask=True`` (4
classes, float32): the mask head through the weight bridge (1e-5
relative), ``mask_loss`` (1e-5), the eval forward's masks on valid slots
(1e-4; boxes 1e-3, scores 1e-4, valid slots and labels equal), and one
train step with masks and copy-paste fed the draws of the JAX step's key
(losses 1e-5, each gradient 2e-3 of its tensor's largest, parameters
1e-6).  Copy-paste in both forms, the policies with masks, the dataset's
mask targets and ``collate`` agree exactly; the mask head's names agree
with ``podtpu.models.weights.convert_torchvision_state_dict``.  The
weights are the port's seeded initialisation (``port_init_variables``:
flax's initialisers, without JAX's ``init_variables`` compile).
"""
import dataclasses
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from podtpu.data import presets as jax_presets
from podtpu.data.annotation import PolygonAnnotation as JaxPolygon
from podtpu.data.annotation import RectangleAnnotation as JaxRect
from podtpu.data import dataset as jax_dataset
from podtpu.models import roi_heads as jax_rh
from podtpu.models.detector import make_detector as jax_make_detector
from podtpu.models.weights import convert_torchvision_state_dict
from podtpu.ops import image_ops as jax_T
from podtpu.train.optim import apply_optimizer
from podtpu.train.optim import make_optimizer as jax_make_optimizer
from podtpu.train.step import images_to_float
from podtpu_torch.core.config import config_from_dict
from podtpu_torch.data import dataset
from podtpu_torch.data import presets
from podtpu_torch.data.annotation import (PolygonAnnotation,
                                          RectangleAnnotation)
from podtpu_torch.data.image import ImageMetadata
from podtpu_torch.data.project import Project
from podtpu_torch.models import roi_heads as rh
from podtpu_torch.models.detector import (ModelDraws, init_parameters,
                                          make_detector, num_anchors)
from podtpu_torch.models.weights import (flax_from_state_dict, key_map,
                                         state_dict_from_flax)
from podtpu_torch.ops import image_ops as T
from podtpu_torch.train.optim import make_optimizer
from podtpu_torch.train.step import TrainDraws, make_train_step
# Defined before this file's imports of other test files, which import
# it back.
# Torch's CPU threads in the port's heaviest test files.  Run in 6 xdist
# workers on 8 cores, each worker's default of one thread a core
# oversubscribes the machine: capped at 2, the port's test files took 235 s
# instead of 796 s under ``-n 6``.
TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """``TORCH_THREADS`` CPU threads for torch while the module's tests
    run; the worker's setting after."""
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(before)


def port_init_variables(mcfg, seed):
    """Flax trees (numpy) of the port's seeded initialisation of the
    JAX config ``mcfg``'s model: ``models.detector.init_parameters`` draws
    from flax's initialisers, and JAX's own ``init_variables`` compiles the
    model, some 12 s a config."""
    model = make_detector(config_from_dict(
        {"model": dataclasses.asdict(mcfg)}).model)
    init_parameters(model, torch.Generator().manual_seed(seed))
    params, frozen = flax_from_state_dict(model.state_dict())
    return {"params": params, "frozen": frozen}


from tests.conftest import tiny_config
from tests.synthetic import make_project
from tests.test_torch_augment import jax_augment_draws
from tests.test_torch_train_ops import batch_sampler_draws, gt_batch

B, G, LR = 2, 8, 0.005


def t(a):
    return torch.from_numpy(np.array(a))


def jax_config(copy_paste=False):
    cfg = tiny_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, num_classes=4,
                                       with_mask=True),
        data=dataclasses.replace(cfg.data, photometric_distort=True,
                                 copy_paste=copy_paste))


def gt_masks(rng, boxes, valid, hm, wm, stride):
    """An ellipse inside each valid gt box, on the ``[hm, wm]`` grid of
    ``stride`` px cells, float32; a few cells of noise around it."""
    yy, xx = np.mgrid[0:hm, 0:wm] + 0.5
    out = np.zeros(boxes.shape[:2] + (hm, wm), np.float32)
    for i, j in zip(*np.nonzero(valid)):
        x1, y1, x2, y2 = boxes[i, j] / stride
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        rx, ry = max((x2 - x1) / 2, 0.5), max((y2 - y1) / 2, 0.5)
        out[i, j] = (((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2) <= 1
    out[rng.uniform(size=out.shape) < 0.02] = 1.0
    return out


def make_batch(seed, b=B, size=128):
    rng = np.random.default_rng(seed)
    boxes, labels, valid = gt_batch(rng, b, G, canvas=float(size))
    return {"image": rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
            "boxes": boxes, "labels": labels, "valid": valid,
            "masks": gt_masks(rng, boxes, valid, size // 8, size // 8, 8)}


@pytest.fixture(scope="module")
def pair():
    """(JAX config, its variables as numpy, the port's config, model)."""
    jcfg = jax_config(copy_paste=True)
    variables = port_init_variables(jcfg.model, 0)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    return jcfg, variables, cfg


def port_model(cfg, variables):
    model = make_detector(cfg.model)
    sd = state_dict_from_flax(variables["params"], variables["frozen"])
    model.load_state_dict({k: t(v) for k, v in sd.items()})
    return model.to(memory_format=torch.channels_last)


# -- the head, the bridge, the loss -------------------------------------------

class TestMaskHead:
    def test_head_through_bridge(self, pair):
        jcfg, variables, cfg = pair
        model = port_model(cfg, variables)
        pooled = np.random.default_rng(1).normal(
            size=(6, 14, 14, 256)).astype(np.float32)
        want = jax_rh.MaskHead(num_classes=4, dtype=jnp.float32).apply(
            {"params": variables["params"]["mask_head"]}, jnp.asarray(pooled))
        with torch.no_grad():
            got = model.roi_heads.mask_logits(
                t(pooled).permute(0, 3, 1, 2))
        assert got.shape == (6, 4, 28, 28) and got.dtype == torch.float32
        want = np.asarray(want).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())

    def test_bridge_round_trip_and_torchvision_names(self, pair):
        _, variables, cfg = pair
        sd = state_dict_from_flax(variables["params"], variables["frozen"])
        model = make_detector(cfg.model)
        assert set(sd) == set(model.state_dict())
        names = {k for k, *_ in key_map(with_mask=True)} - {
            k for k, *_ in key_map()}
        assert len(names) == 12 and all(
            k.startswith(("roi_heads.mask_head.mask_fcn",
                          "roi_heads.mask_predictor.")) for k in names)
        back = convert_torchvision_state_dict(
            {k: torch.from_numpy(v.copy()) for k, v in sd.items()}, variables)
        assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back,
                                                variables)))
        # Newer torchvision spells the tower mask_head.{i-1}.0: both
        # packages read it.
        renamed = {re.sub(r"mask_fcn(\d)", lambda m: f"{int(m[1]) - 1}.0",
                          k): torch.from_numpy(v.copy())
                   for k, v in sd.items()}
        assert any(".mask_head.0.0." in k for k in renamed)
        back = convert_torchvision_state_dict(renamed, variables)
        assert all(jax.tree.leaves(jax.tree.map(
            np.array_equal, back["params"]["mask_head"],
            variables["params"]["mask_head"])))
        params, frozen = flax_from_state_dict(
            {k: torch.from_numpy(v) for k, v in sd.items()})
        assert all(jax.tree.leaves(jax.tree.map(
            np.array_equal, {"params": params, "frozen": frozen}, variables)))

    def test_pretrained_state_dict_aliases(self, pair, tmp_path):
        _, variables, cfg = pair
        from podtpu_torch.models.weights import load_pretrained

        sd = state_dict_from_flax(variables["params"], variables["frozen"])
        renamed = {k.replace("mask_head.mask_fcn1.", "mask_head.0.0."):
                   torch.from_numpy(v.copy()) for k, v in sd.items()}
        renamed["roi_heads.mask_predictor.mask_fcn_logits.weight"] = \
            torch.zeros(7, 256, 1, 1)
        path = tmp_path / "maskrcnn.pth"
        torch.save(renamed, path)
        model = load_pretrained(make_detector(cfg.model), str(path),
                                verbose=False)
        path.unlink()
        got = model.state_dict()
        for k, v in sd.items():
            if k == "roi_heads.mask_predictor.mask_fcn_logits.weight":
                assert not torch.equal(got[k], torch.from_numpy(v)), k
            else:
                np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)

    def test_mask_loss(self, pair):
        jcfg, _, cfg = pair
        rng = np.random.default_rng(5)
        batch = make_batch(5, b=3)
        s, m, c = 24, 28, 4
        props = np.concatenate([batch["boxes"] + rng.normal(
            0, 3, batch["boxes"].shape), rng.uniform(0, 100, (3, s, 4))], 1)
        props = np.sort(props.reshape(3, -1, 2, 2), axis=2).reshape(
            3, -1, 4).clip(0, 128).astype(np.float32)
        key = jax.random.PRNGKey(5)
        want_rois = jax.vmap(lambda r, pb, gb, gl, gv: jax_rh.sample_rois(
            r, pb, jnp.ones(pb.shape[0], bool), gb, gl, gv,
            dataclasses.replace(jcfg.model, box_batch_per_image=s)))(
            jax.random.split(key, 3), jnp.asarray(props),
            jnp.asarray(batch["boxes"]), jnp.asarray(batch["labels"]),
            jnp.asarray(batch["valid"]))
        rois = rh.SampledRois(*(t(x) for x in want_rois))
        rois = rois._replace(cls_targets=rois.cls_targets.long(),
                             gt_index=rois.gt_index.long())
        assert rois.is_pos.any() and (rois.valid & ~rois.is_pos).any()
        logits = rng.normal(0, 2, (3, s, m, m, c)).astype(np.float32)
        gm = batch["masks"]
        geom = {"offset": jnp.asarray([0], jnp.int32),
                "height": jnp.asarray([16], jnp.int32),
                "width": jnp.asarray([16], jnp.int32)}
        from podtpu.ops.roi_align import multilevel_roi_align

        def jax_loss_and_targets(ml, r, g):
            flat = g.reshape(g.shape[0], -1).T
            targets = jax.vmap(lambda box, i: multilevel_roi_align(
                flat[:, i][:, None], geom, box[None], strides=(8,),
                output_size=m, sampling_ratio=2)[0, :, :, 0])(
                r.boxes, r.gt_index)
            return jax_rh.mask_loss(ml, r, flat, geom, 8, jcfg.model), targets

        per_image, want_targets = jax.jit(jax.vmap(jax_loss_and_targets))(
            jnp.asarray(logits), want_rois, jnp.asarray(gm))
        weight = np.array([1.0, 0.0, 1.0], np.float32)
        logits_t = t(logits).permute(0, 1, 4, 2, 3)
        for w, want in ((None, per_image.mean()),
                        (weight, (per_image * weight).sum() / weight.sum())):
            got = rh.mask_loss(logits_t, rois, t(gm), cfg.model,
                               None if w is None else t(w))
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        # The targets alone, against the crop of JAX's XLA RoIAlign (under
        # jit XLA contracts the bilinear sums into FMAs: 1.3e-6 apart).
        targets = rh.crop_mask_targets(t(gm), rois.boxes, rois.gt_index, 8, m)
        assert 0 < float((targets > 0.5).float().mean()) < 1
        np.testing.assert_allclose(targets.numpy(), np.asarray(want_targets),
                                   rtol=0, atol=1e-5)


# -- the eval forward ---------------------------------------------------------

def test_eval_forward_masks(pair):
    jcfg, variables, cfg = pair
    from podtpu.train.step import make_eval_step

    jmodel = jax_make_detector(jcfg.model)
    images = np.random.default_rng(2).integers(0, 256, (2, 128, 128, 3),
                                               dtype=np.uint8)
    want_det, want_masks = make_eval_step(jmodel)(
        variables["params"], variables["frozen"], jnp.asarray(images))
    model = port_model(cfg, variables).eval()
    with torch.inference_mode():
        det, masks = model(t(images))
    v = np.asarray(want_det.valid)
    assert v.sum() > 4 and masks.shape == (2, 16, 28, 28)
    np.testing.assert_array_equal(det.valid.numpy(), v)
    np.testing.assert_array_equal(det.labels.numpy(),
                                  np.asarray(want_det.labels))
    np.testing.assert_allclose(det.boxes.numpy()[v],
                               np.asarray(want_det.boxes)[v], atol=1e-3)
    np.testing.assert_allclose(det.scores.numpy()[v],
                               np.asarray(want_det.scores)[v], atol=1e-4)
    np.testing.assert_allclose(masks.numpy()[v], np.asarray(want_masks)[v],
                               rtol=0, atol=1e-4)


# -- one train step -----------------------------------------------------------

def jax_step_draws(key, cfg, b=B):
    """The port's draws of one step with copy-paste, along the JAX step's
    split tree (``step.py:86`` and ``:94``, ``detector.py:177``)."""
    rng_aug, rng_model = jax.random.split(key)
    rng_cp, rng_aug = jax.random.split(rng_aug)
    rng_rpn, rng_roi = jax.random.split(rng_model)
    rp, rn = batch_sampler_draws(rng_rpn, b, num_anchors(cfg.model))
    qp, qn = batch_sampler_draws(
        rng_roi, b, cfg.model.rpn_post_nms_topk_train + G)
    return TrainDraws(augment=jax_augment_draws(rng_aug, b),
                      model=ModelDraws(t(rp), t(rn), t(qp), t(qn)),
                      copy_paste=t(jax.random.uniform(rng_cp, (b, G))))


@pytest.fixture(scope="module")
def one_step(pair):
    jcfg, variables, cfg = pair
    jmodel = jax_make_detector(jcfg.model)
    batch = make_batch(1)
    key = jax.random.PRNGKey(2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    # The JAX step's augmentation, loss and gradients (``step.py:83-134``)
    # as one compile; the optimiser update runs eagerly.
    def loss_fn(params):
        rng_aug, rng_model = jax.random.split(key)
        rng_cp, rng_aug = jax.random.split(rng_aug)
        images, boxes, labels, valid, masks = jax_T.copy_paste_batch(
            rng_cp, images_to_float(jbatch["image"]), jbatch["boxes"],
            jbatch["labels"], jbatch["valid"], jbatch["masks"])
        images, boxes, valid, masks, _ = jax_presets.augment_batch_policy(
            jax_presets.get_policy("miso"), rng_aug, images, boxes, valid,
            masks=masks, **jax_presets.policy_kwargs(jcfg))
        gt = {"boxes": boxes, "labels": labels, "valid": valid,
              "masks": masks}
        losses = jmodel.apply({"params": params,
                               "frozen": variables["frozen"]}, images,
                              gt=gt, train=True, rng=rng_model)
        return sum(losses.values()), losses

    (total, jlosses), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    tx = jax_make_optimizer(jcfg.train, jcfg.model)
    jparams, _ = apply_optimizer(tx, jgrads, tx.init(variables["params"]),
                                 variables["params"], jnp.float32(LR))
    jmetrics = dict(jlosses, loss=total, lr=LR)

    model = port_model(cfg, variables)
    step = make_train_step(model, make_optimizer(cfg.train, model), cfg,
                           device="cpu")
    metrics = step({k: t(v) for k, v in batch.items()}, LR,
                   draws=jax_step_draws(key, cfg))
    return dict(jgrads=jax.tree.map(np.asarray, jgrads),
                jparams=jax.tree.map(np.asarray, jparams),
                jmetrics={k: float(v) for k, v in jmetrics.items()},
                model=model, metrics={k: float(v) for k, v in metrics.items()})


class TestTrainStep:
    def test_losses(self, one_step):
        got, want = one_step["metrics"], one_step["jmetrics"]
        assert set(got) == set(want) and "loss_mask" in got
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        assert all(np.isfinite(v) and v > 0 for v in got.values())

    def test_gradients(self, one_step, pair):
        _, variables, _ = pair
        model = one_step["model"]
        want = state_dict_from_flax(one_step["jgrads"], variables["frozen"])
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
        assert len(checked) == 84  # the box model's 72, the mask head's 12
        assert sum("mask_" in n for n in checked) == 12

    def test_parameters_after_update(self, one_step, pair):
        _, variables, _ = pair
        want = state_dict_from_flax(one_step["jparams"], variables["frozen"])
        for name, p in one_step["model"].named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       rtol=0, atol=1e-6, err_msg=name)


# -- copy-paste and the policies ----------------------------------------------

def float_batch(seed, b=3, size=32, g=5):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    xy = rng.uniform(0, size - 8, (b, g, 2))
    wh = rng.uniform(2, 12, (b, g, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, size)], -1).astype(
        np.float32)
    valid = rng.uniform(size=(b, g)) > 0.3
    valid[0] = True                    # a full image: compaction drops some
    labels = np.where(valid, rng.integers(1, 4, (b, g)), 0).astype(np.int32)
    masks = gt_masks(rng, boxes, valid, size // 4, size // 4, 4)
    return img, boxes, labels, valid, masks


@pytest.mark.parametrize("with_masks", [False, True])
def test_copy_paste_batch(with_masks):
    img, boxes, labels, valid, masks = float_batch(3)
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda *a: jax_T.copy_paste_batch(*a, region_stride=4))(
        key, jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(labels),
        jnp.asarray(valid), jnp.asarray(masks) if with_masks else None)
    draw = t(jax.random.uniform(key, valid.shape))
    got = T.copy_paste_batch(draw, t(img), t(boxes), t(labels), t(valid),
                             t(masks) if with_masks else None,
                             region_stride=4)
    assert (got[4] is None) == (not with_masks)
    for g, w, name in zip(got, want, ("images", "boxes", "labels", "valid",
                                      "masks")):
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
    pasted = (got[0] != t(img)).any(-1)
    assert pasted.any() and not pasted.all()
    assert got[3].sum() > t(valid).sum()


@pytest.mark.parametrize("policy", ["miso", "hflip", "none"])
def test_policies_with_masks(policy):
    img, boxes, _, valid, masks = float_batch(4, b=6)
    rng = jax.random.PRNGKey(4)
    kw = {"distort": True} if policy == "miso" else {}
    wi, wb, wv, wm, _ = jax.jit(
        lambda *a: jax_presets.augment_batch_policy(
            jax_presets.get_policy(policy), *a, **kw))(
        rng, jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(valid),
        jnp.asarray(masks))
    draws = jax_augment_draws(rng, 6, policy)
    gi, gb, gv, gm, gk = presets.augment_batch_policy(
        presets.get_policy(policy), t(img), t(boxes), t(valid), draws,
        masks=t(masks), **kw)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-5)
    assert gk is None
    for g, w in ((gb, wb), (gv, wv), (gm, wm)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if policy != "none":
        assert not np.array_equal(gm.numpy(), masks)


def test_unported_policies_name_their_item():
    """No policy is left unported: each JAX policy name has the port's,
    and an unknown name is refused as in JAX."""
    for name in jax_presets.POLICIES:
        assert presets.get_policy(name) is presets.POLICIES[name]
    with pytest.raises(ValueError, match="Unknown augmentation policy"):
        presets.get_policy("ssd300")


# -- dataset mask targets -----------------------------------------------------

def port_project(jp):
    """The port's copy of a JAX project, polygons and rectangles alike."""
    p = Project()
    p.task_names = dict(jp.task_names)
    for label in jp.label_dict.values():
        p.add_label(label.id, label.name, label.colour)
    for im in jp.image_dict.values():
        m = ImageMetadata(im.path, im.container, im.dataset_id, im.frame_id)
        for b in im.boxes:
            if isinstance(b, JaxPolygon):
                m.add_annotation(PolygonAnnotation(list(b.xs), list(b.ys),
                                                   b.label, score=b.score))
            else:
                m.add_annotation(RectangleAnnotation(
                    b.x, b.y, b.width, b.height, b.label, score=b.score))
        p.add_image(m)
    return p


def test_dataset_mask_targets_and_collate(tmp_path, capsys):
    jp = make_project(str(tmp_path), num_images=5, max_boxes=4, seed=6,
                      polygons=True)
    # A rectangle (filled box) beside the polygons, and an unreadable file.
    first = next(iter(jp.image_dict.values()))
    first.add_annotation(JaxRect(10.3, 20.7, 30.2, 18.9, "particle"))
    (tmp_path / "broken.jpg").write_bytes(b"not an image")
    from podtpu.data.image import ImageMetadata as JaxImage
    bad = JaxImage("broken.jpg", str(tmp_path), dataset_id=1, frame_id=99)
    bad.add_annotation(JaxRect(1, 2, 30, 40, "particle"))
    jp.add_image(bad)
    kw = dict(image_size=(128, 128), max_gt=6, with_masks=True,
              mask_stride=8)
    jds = jax_dataset.DetectionDataset(jp, **kw)
    pds = dataset.DetectionDataset(port_project(jp), **kw)
    for i in range(len(jds)):
        got, want = pds.load(i), jds.load(i)
        assert got.masks.dtype == np.float32 and got.ok == want.ok
        np.testing.assert_array_equal(got.masks, want.masks)
    assert not pds.load(5).ok and not pds.load(5).masks.any()
    assert pds.load(0).masks.sum() > 10
    idx = [5, 0, 3, 3]
    got = dataset.collate(pds.load_batch(idx))
    want = jax_dataset.collate(jds.load_batch(idx))
    assert set(got) == set(want) and "masks" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    capsys.readouterr()
    # The cache budget counts the mask planes.
    small = 6 * (128 * 128 * 3 + 6 * 16) + 1
    assert dataset.DetectionDataset(port_project(jp), cache_budget_bytes=small,
                                    **dict(kw, with_masks=False))._cache \
        is not None
    assert dataset.DetectionDataset(port_project(jp), cache_budget_bytes=small,
                                    **kw)._cache is None
