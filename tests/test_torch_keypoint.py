"""Keypoint R-CNN in podtpu_torch against podtpu (CPU).

At ``tests/conftest.py::tiny_config`` sizes with ``with_keypoints=True``,
5 keypoints, a chiral flip permutation and a 32-channel head (float32):

* the keypoint head through the weight bridge to 1e-5 relative, also at
  the published 512 channels on 4 RoIs (the transposed convolution's taps
  and padding at full width), and its 2x bilinear upsample against
  ``jax.image.resize``, border cells included;
* ``keypoints_to_heatmap``, ``expand_rois`` and ``heatmaps_to_keypoints``
  on JAX's inputs: cells, validity, boxes and positions exactly, scores to
  1e-6 relative (the softmax sums its 3136 terms in another order), with
  the edge rule, border argmaxes, a flat heatmap and ties;
* ``keypoint_loss`` to 1e-5, with and without image weights;
* the eval forward's heatmap logits to 1e-4 of their largest, and its
  keypoints where the heatmap's peak clears its runner-up by ten times
  that;
* one train step under the miso policy with the chiral permutation
  (vertical flip off) and copy-paste, fed the draws of the JAX step's key:
  losses with ``loss_keypoint`` to 1e-5, each gradient to 2e-3 of its
  tensor's largest, parameters to 1e-6;
* the policies with keypoints and the permutation, dataset keypoint
  targets and ``collate``, exactly; the bridge's names against
  ``podtpu.models.weights.convert_torchvision_state_dict``.

One JAX ``init_variables`` compile serves the file.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from podtpu.core.config import COCO_17_HFLIP_INDS as JAX_COCO_17
from podtpu.data import dataset as jax_dataset
from podtpu.data import presets as jax_presets
from podtpu.data.annotation import RectangleAnnotation as JaxRect
from podtpu.models import roi_heads as jax_rh
from podtpu.models.detector import init_variables
from podtpu.models.detector import make_detector as jax_make_detector
from podtpu.models.weights import convert_torchvision_state_dict
from podtpu.ops import image_ops as jax_T
from podtpu.train.optim import apply_optimizer
from podtpu.train.optim import make_optimizer as jax_make_optimizer
from podtpu.train.step import images_to_float, make_eval_step
from podtpu_torch.core.config import COCO_17_HFLIP_INDS, config_from_dict
from podtpu_torch.data import dataset, presets
from podtpu_torch.data.annotation import RectangleAnnotation
from podtpu_torch.data.image import ImageMetadata
from podtpu_torch.data.project import Project
from podtpu_torch.models import roi_heads as rh
from podtpu_torch.models.detector import make_detector
from podtpu_torch.models.weights import (flax_from_state_dict, key_map,
                                         load_pretrained,
                                         state_dict_from_flax)
from podtpu_torch.train.optim import make_optimizer
from podtpu_torch.train.step import make_train_step
from tests.conftest import tiny_config
from tests.synthetic import make_project
from tests.test_torch_augment import jax_augment_draws
from tests.test_torch_mask import (B, G, LR, jax_step_draws,  # noqa: F401
                                   port_model, t, torch_threads)
from tests.test_torch_train_ops import gt_batch

K = 5
CHIRAL = (0, 2, 1, 4, 3)   # the centre, then two left/right pairs


def jax_config(channels=32):
    cfg = tiny_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(
            cfg.model, num_classes=4, with_keypoints=True, num_keypoints=K,
            keypoint_head_channels=channels, keypoint_hflip_inds=CHIRAL,
            keypoint_roi_expand=1.3),
        data=dataclasses.replace(cfg.data, photometric_distort=True,
                                 copy_paste=True))


def gt_keypoints(rng, boxes, valid, k=K):
    """``[B, G, k, 3]``: points drawn inside each valid box, a fifth of them
    invisible; one on a box's right edge and one on its bottom edge."""
    b, g = valid.shape
    u = rng.uniform(0, 1, (b, g, k, 2))
    lo, hi = boxes[..., None, :2], boxes[..., None, 2:]
    xy = lo + u * (hi - lo)
    vis = np.where(rng.uniform(size=(b, g, k)) < 0.2, 0.0, 2.0)
    out = np.concatenate([xy, vis[..., None]], -1).astype(np.float32)
    out[~valid] = 0.0
    i, j = np.argwhere(valid)[0]
    out[i, j, 1, 0] = boxes[i, j, 2]
    out[i, j, 2, 1] = boxes[i, j, 3]
    return out


def make_batch(seed, b=B, size=128):
    rng = np.random.default_rng(seed)
    boxes, labels, valid = gt_batch(rng, b, G, canvas=float(size))
    return {"image": rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
            "boxes": boxes, "labels": labels, "valid": valid,
            "keypoints": gt_keypoints(rng, boxes, valid)}


@pytest.fixture(scope="module")
def pair():
    """(JAX config, its variables as numpy, the port's config)."""
    jcfg = jax_config()
    variables = jax.tree.map(np.asarray, jax.device_get(dict(
        init_variables(jax_make_detector(jcfg.model),
                       jax.random.PRNGKey(0)))))
    return jcfg, variables, config_from_dict(dataclasses.asdict(jcfg))


# -- the head, the bridge -----------------------------------------------------

@pytest.mark.parametrize("channels, n", [(32, 6), (512, 4)])
def test_head_through_bridge(pair, channels, n):
    jcfg, variables, cfg = pair
    head = jax_rh.KeypointHead(num_keypoints=K, channels=channels,
                               dtype=jnp.float32)
    pooled = np.random.default_rng(channels).normal(
        size=(n, 14, 14, 256)).astype(np.float32)
    if channels == 32:
        params = variables["params"]
    else:  # the published width: a fresh head in the small model's tree
        params = dict(variables["params"], keypoint_head=jax.tree.map(
            np.asarray, head.init(jax.random.PRNGKey(3),
                                  jnp.asarray(pooled))["params"]))
    want = np.asarray(head.apply({"params": params["keypoint_head"]},
                                 jnp.asarray(pooled))).transpose(0, 3, 1, 2)
    mcfg = dataclasses.replace(cfg.model, keypoint_head_channels=channels)
    model = make_detector(mcfg)
    sd = state_dict_from_flax(params, variables["frozen"])
    model.load_state_dict({k: t(v) for k, v in sd.items()})
    with torch.no_grad():
        got = model.roi_heads.keypoint_logits(t(pooled).permute(0, 3, 1, 2))
    assert got.shape == (n, K, 56, 56) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_upsample_matches_jax_resize_at_the_border():
    x = np.random.default_rng(4).normal(size=(3, K, 28, 28)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                       (3, 56, 56, K), method="linear"))
    want = want.transpose(0, 3, 1, 2)
    pred = rh.KeypointRCNNPredictor(4, K)
    got = torch.nn.functional.interpolate(
        t(x), scale_factor=2, mode="bilinear", align_corners=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # Corner cells repeat the corner input to one rounding: the port clamps
    # the source index (its weights then sum two equal taps at the far
    # edge), JAX renormalises the edge weights; edge rows interpolate only
    # along the edge.
    for a in (got, want):
        for cy, cx in ((0, 0), (-1, -1), (0, -1), (-1, 0)):
            np.testing.assert_allclose(a[..., cy, cx], x[..., cy, cx],
                                       rtol=2.4e-7, atol=0)
    np.testing.assert_array_equal(got[..., 0, 0], x[..., 0, 0])
    np.testing.assert_allclose(got[..., 0, 1:-1:2],
                               0.75 * x[..., 0, :-1] + 0.25 * x[..., 0, 1:],
                               rtol=0, atol=1e-6)
    # The predictor upsamples its transposed convolution's output.
    with torch.no_grad():
        y = pred(torch.zeros(2, 4, 14, 14))
    assert y.shape == (2, K, 56, 56)


def test_bridge_names_and_torchvision(pair, tmp_path):
    _, variables, cfg = pair
    sd = state_dict_from_flax(variables["params"], variables["frozen"])
    model = make_detector(cfg.model)
    assert set(sd) == set(model.state_dict())
    names = {k for k, *_ in key_map(with_keypoints=True)} - {
        k for k, *_ in key_map()}
    assert names == {f"roi_heads.keypoint_head.{2 * i}.{p}"
                     for i in range(8) for p in ("weight", "bias")} | {
        f"roi_heads.keypoint_predictor.kps_score_lowres.{p}"
        for p in ("weight", "bias")}
    back = convert_torchvision_state_dict(
        {k: torch.from_numpy(v.copy()) for k, v in sd.items()}, variables)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back,
                                            variables)))
    params, frozen = flax_from_state_dict(
        {k: torch.from_numpy(v.copy()) for k, v in sd.items()})
    assert all(jax.tree.leaves(jax.tree.map(
        np.array_equal, {"params": params, "frozen": frozen}, variables)))
    # A torchvision checkpoint with 17 keypoints: the head's convolutions
    # load, the mis-sized predictor keeps the model's values.
    ck = {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
    ck["roi_heads.keypoint_predictor.kps_score_lowres.weight"] = \
        torch.ones(32, 17, 4, 4)
    ck["roi_heads.keypoint_head.0.weight"] = torch.full_like(
        ck["roi_heads.keypoint_head.0.weight"], 0.5)
    path = tmp_path / "keypointrcnn.pth"
    torch.save(ck, path)
    fresh = make_detector(cfg.model)
    before = fresh.state_dict()[
        "roi_heads.keypoint_predictor.kps_score_lowres.weight"].clone()
    got = load_pretrained(fresh, str(path), verbose=False).state_dict()
    assert torch.equal(got["roi_heads.keypoint_predictor.kps_score_lowres"
                           ".weight"], before)
    assert torch.equal(got["roi_heads.keypoint_head.0.weight"],
                       ck["roi_heads.keypoint_head.0.weight"])
    assert COCO_17_HFLIP_INDS == JAX_COCO_17


# -- the codec ----------------------------------------------------------------

def test_keypoints_to_heatmap_and_expand_rois():
    rng = np.random.default_rng(6)
    n = 40
    xy = rng.uniform(-10, 100, (n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(0.5, 60, (n, 2))],
                          1).astype(np.float32)
    rois[0, 2:] = rois[0, :2]                   # a degenerate box
    lo, hi = rois[:, None, :2], rois[:, None, 2:]
    kps = lo + rng.uniform(-0.3, 1.3, (n, 7, 2)) * (hi - lo)
    vis = rng.choice([0.0, 1.0, 2.0], (n, 7, 1))
    kps = np.concatenate([kps, vis], -1).astype(np.float32)
    kps[1:, 0, :2] = rois[1:, 2:]               # on the far corner
    kps[1:, 0, 2] = 2.0
    kps[2:, 1, 0] = rois[2:, 0]                 # on the near edge
    kps[2:, 1, 2] = 2.0
    for hm in (56, 7):
        got = rh.keypoints_to_heatmap(t(kps), t(rois), hm)
        want = jax_rh.keypoints_to_heatmap(jnp.asarray(kps),
                                           jnp.asarray(rois), hm)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[1][1:, 0].all()
        assert (got[0][1:, 0] == hm * hm - 1).all()
        assert got[1].any() and not got[1].all()
    for f in (1.0, 1.3, 0.7):
        want = np.asarray(jax_rh.expand_rois(jnp.asarray(rois), f))
        np.testing.assert_array_equal(rh.expand_rois(t(rois), f).numpy(),
                                      want)
    batched = rh.expand_rois(t(rois.reshape(4, 10, 4)), 1.3)
    assert batched.shape == (4, 10, 4)


def decode_cases(rng, d=12, k=K, h=56):
    """Heatmap logits ``[D, H, H, K]`` (JAX's layout) with Gaussian peaks
    inside and on every border, a flat map and tied maxima."""
    yy, xx = np.mgrid[0:h, 0:h]
    maps = rng.normal(0, 0.05, (d, h, h, k)).astype(np.float32)
    for i in range(d):
        for j in range(k):
            cy, cx = rng.uniform(-1, h, 2)
            maps[i, :, :, j] += 6 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                           / (2 * 1.5 ** 2))
    maps[0, :, :, 0] = 0.0                               # flat: argmax 0
    maps[0, :, :, 1] = 0.0
    maps[0, 10, 20, 1] = maps[0, 30, 5, 1] = 2.0         # a tie
    maps[1, 0, 30, 0] = 50.0                             # top border
    maps[1, 55, 55, 1] = 50.0                            # corner
    maps[1, 20, 0, 2] = 50.0                             # left border
    maps[1, 20, 33, 3] = maps[1, 20, 34, 3] = 50.0       # a flat ridge
    xy = rng.uniform(-20, 100, (d, 2))
    rois = np.concatenate([xy, xy + rng.uniform(1, 80, (d, 2))],
                          1).astype(np.float32)
    return maps, rois


def test_heatmaps_to_keypoints():
    maps, rois = decode_cases(np.random.default_rng(7))
    want = np.asarray(jax_rh.heatmaps_to_keypoints(jnp.asarray(maps),
                                                   jnp.asarray(rois)))
    got = rh.heatmaps_to_keypoints(t(maps).permute(0, 3, 1, 2).contiguous(),
                                   t(rois)).numpy()
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=1e-6,
                               atol=0)
    # Cell centres at the border and where the map is flat (an interior
    # axis of a border peak moves by the noise's parabola, under 2e-3 px).
    cell = (rois[:, 2:] - rois[:, :2]) / 56
    for (d, k), at in (((1, 0), [30.5, 0.5]), ((1, 1), [55.5, 55.5]),
                       ((1, 2), [0.5, 20.5]), ((0, 0), [0.5, 0.5]),
                       ((0, 1), [20.5, 10.5])):
        np.testing.assert_allclose(got[d, k, :2], rois[d, :2] + cell[d] * at,
                                   rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[0, 0, 2], 1 / 56 ** 2, rtol=1e-6)
    # The ridge's vertex lies half way between its two equal cells.
    np.testing.assert_allclose(got[1, 3, :2], rois[1, :2] + cell[1]
                               * [34.0, 20.5], rtol=0, atol=2e-3)


def test_keypoint_loss(pair):
    jcfg, _, cfg = pair
    rng = np.random.default_rng(5)
    batch = make_batch(5, b=3)
    s, h = 24, 56
    props = np.concatenate([batch["boxes"] + rng.normal(
        0, 3, batch["boxes"].shape), rng.uniform(0, 100, (3, s, 4))], 1)
    props = np.sort(props.reshape(3, -1, 2, 2), axis=2).reshape(
        3, -1, 4).clip(0, 128).astype(np.float32)
    want_rois = jax.vmap(lambda r, pb, gb, gl, gv: jax_rh.sample_rois(
        r, pb, jnp.ones(pb.shape[0], bool), gb, gl, gv,
        dataclasses.replace(jcfg.model, box_batch_per_image=s)))(
        jax.random.split(jax.random.PRNGKey(5), 3), jnp.asarray(props),
        jnp.asarray(batch["boxes"]), jnp.asarray(batch["labels"]),
        jnp.asarray(batch["valid"]))
    rois = rh.SampledRois(*(t(x) for x in want_rois))
    rois = rois._replace(cls_targets=rois.cls_targets.long(),
                         gt_index=rois.gt_index.long())
    kp_rois = jax_rh.expand_rois(want_rois.boxes, 1.3)
    logits = rng.normal(0, 2, (3, s, h, h, K)).astype(np.float32)
    per_image = jax.vmap(jax_rh.keypoint_loss)(
        jnp.asarray(logits), kp_rois, want_rois,
        jnp.asarray(batch["keypoints"]))
    weight = np.array([1.0, 0.0, 1.0], np.float32)
    got_rois = rh.expand_rois(rois.boxes, 1.3)
    np.testing.assert_array_equal(got_rois.numpy(), np.asarray(kp_rois))
    logits_t = t(logits).permute(0, 1, 4, 2, 3)
    for w, want in ((None, per_image.mean()),
                    (weight, (per_image * weight).sum() / weight.sum())):
        got = rh.keypoint_loss(logits_t, got_rois, rois,
                               t(batch["keypoints"]),
                               None if w is None else t(w))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # The third image has no gt: its loss is 0, the others' are not.
    assert float(per_image[:2].min()) > 0 and float(per_image[2]) == 0


# -- the eval forward ---------------------------------------------------------

def test_eval_forward_logits_and_keypoints(pair):
    jcfg, variables, cfg = pair
    params = variables["params"]
    jmodel = jax_make_detector(jcfg.model)
    images = np.random.default_rng(2).integers(0, 256, (2, 128, 128, 3),
                                               dtype=np.uint8)
    want_det, want_kps = make_eval_step(jmodel)(
        params, variables["frozen"], jnp.asarray(images))
    want_kps = np.asarray(want_kps.keypoints)

    def heatmaps(m, x, boxes):
        levels = m._features(x)[:len(jcfg.model.roi_strides)]
        kp_rois = jax_rh.expand_rois(boxes, jcfg.model.keypoint_roi_expand)
        pooled = jax_rh.pool_rois_batched(levels, kp_rois, jcfg.model,
                                          pool_size=14)
        b, d = pooled.shape[:2]
        out = m.keypoint_head(pooled.reshape(b * d, *pooled.shape[2:]))
        return out.reshape(b, d, *out.shape[1:])

    want_logits = np.asarray(jax.jit(lambda p, x, bx: jmodel.apply(
        {"params": p, "frozen": variables["frozen"]}, x, bx,
        method=heatmaps))(params, jnp.asarray(images), want_det.boxes))
    want_logits = want_logits.transpose(0, 1, 4, 2, 3)   # [B, D, K, H, H]

    model = make_detector(cfg.model)
    sd = state_dict_from_flax(params, variables["frozen"])
    model.load_state_dict({k: t(v) for k, v in sd.items()})
    model = model.to(memory_format=torch.channels_last).eval()
    with torch.inference_mode():
        det, out = model(t(images))
        _, logits = model._keypoint_logits(model.features(t(images)),
                                           t(want_det.boxes))
    v = np.asarray(want_det.valid)
    assert isinstance(out, rh.KeypointOutput)
    assert v.sum() > 4 and out.keypoints.shape == (2, 16, K, 3)
    np.testing.assert_array_equal(det.valid.numpy(), v)
    np.testing.assert_array_equal(det.labels.numpy(),
                                  np.asarray(want_det.labels))
    np.testing.assert_allclose(det.boxes.numpy()[v],
                               np.asarray(want_det.boxes)[v], atol=1e-3)
    np.testing.assert_allclose(det.scores.numpy()[v],
                               np.asarray(want_det.scores)[v], atol=1e-4)
    tol = 1e-4 * np.abs(want_logits[v]).max()
    np.testing.assert_allclose(logits.numpy()[v], want_logits[v], rtol=0,
                               atol=tol)
    # Keypoints where the peak clears its runner-up by 10x the tolerance.
    flat = np.sort(want_logits[v].reshape(int(v.sum()), K, -1), -1)
    clear = flat[..., -1] - flat[..., -2] > 10 * tol
    got_kps = out.keypoints.numpy()[v]
    print(f"keypoints held: {int(clear.sum())} of {clear.size}")
    assert clear.mean() > 0.5
    want_kps = want_kps[v][clear]
    np.testing.assert_allclose(got_kps[clear][:, :2], want_kps[:, :2],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got_kps[clear][:, 2], want_kps[:, 2],
                               rtol=1e-4, atol=1e-6)


# -- one train step -----------------------------------------------------------

@pytest.fixture(scope="module")
def one_step(pair):
    jcfg, variables, cfg = pair
    jmodel = jax_make_detector(jcfg.model)
    batch = make_batch(1)
    # Both images flip horizontally; the first would flip vertically too
    # were the skeleton not chiral.
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    kw = jax_presets.policy_kwargs(jcfg)
    assert kw["vflip_prob"] == 0.0 and kw["kp_hflip_inds"] == CHIRAL

    def loss_fn(params):
        rng_aug, rng_model = jax.random.split(key)
        rng_cp, rng_aug = jax.random.split(rng_aug)
        images, boxes, labels, valid, _ = jax_T.copy_paste_batch(
            rng_cp, images_to_float(jbatch["image"]), jbatch["boxes"],
            jbatch["labels"], jbatch["valid"], None)
        images, boxes, valid, _, kps = jax_presets.augment_batch_policy(
            jax_presets.get_policy("miso"), rng_aug, images, boxes, valid,
            keypoints=jbatch["keypoints"], **kw)
        gt = {"boxes": boxes, "labels": labels, "valid": valid,
              "keypoints": kps}
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
    assert presets.policy_kwargs(cfg) == kw
    step = make_train_step(model, make_optimizer(cfg.train, model), cfg,
                           device="cpu")
    draws = jax_step_draws(key, cfg)
    metrics = step({k: t(v) for k, v in batch.items()}, LR, draws=draws)
    # The chiral skeleton keeps the vertical flip's draw, and never flips.
    assert (draws.augment.vflip < 0.5).any() \
        and (draws.augment.hflip < 0.5).all()
    return dict(jgrads=jax.tree.map(np.asarray, jgrads),
                jparams=jax.tree.map(np.asarray, jparams),
                jmetrics={k: float(v) for k, v in jmetrics.items()},
                model=model, metrics={k: float(v) for k, v in metrics.items()})


class TestTrainStep:
    def test_losses(self, one_step):
        got, want = one_step["metrics"], one_step["jmetrics"]
        assert set(got) == set(want) and "loss_keypoint" in got
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
            checked.append(name)
            if name == "roi_heads.keypoint_predictor.kps_score_lowres.bias":
                # A constant added to a heatmap leaves its softmax as it
                # was (the upsample's weights sum to 1): the exact gradient
                # is 0.  Both packages' are the float32 rounding of a sum
                # of terms whose magnitudes add to at most 8 (2 per image's
                # loss, times the upsample's 4): about 1e-7 here.
                assert np.abs(want[name]).max() < 1e-6
                assert float(p.grad.abs().max()) < 1e-6
                continue
            scale = float(np.abs(want[name]).max())
            assert scale > 0, name
            np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0,
                                       atol=2e-3 * scale, err_msg=name)
        assert len(checked) == 90  # the box model's 72, the keypoint head's 18
        assert sum("keypoint_" in n for n in checked) == 18

    def test_parameters_after_update(self, one_step, pair):
        _, variables, _ = pair
        want = state_dict_from_flax(one_step["jparams"], variables["frozen"])
        for name, p in one_step["model"].named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       rtol=0, atol=1e-6, err_msg=name)


# -- the policies -------------------------------------------------------------

@pytest.mark.parametrize("policy, inds", [
    ("miso", CHIRAL), ("miso", ()), ("hflip", CHIRAL), ("none", CHIRAL)])
def test_policies_with_keypoints(policy, inds):
    rng = np.random.default_rng(8)
    b, size = 6, 32
    img = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    xy = rng.uniform(0, size - 8, (b, 4, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 8, (b, 4, 2))],
                           -1).astype(np.float32)
    valid = rng.uniform(size=(b, 4)) > 0.3
    kps = gt_keypoints(rng, boxes, valid)
    jcfg = dataclasses.replace(
        tiny_config(), model=dataclasses.replace(
            tiny_config().model, with_keypoints=True, num_keypoints=K,
            keypoint_hflip_inds=inds),
        data=dataclasses.replace(tiny_config().data, aug_policy=policy))
    kw = jax_presets.policy_kwargs(jcfg)
    assert presets.policy_kwargs(config_from_dict(
        dataclasses.asdict(jcfg))) == kw
    key = jax.random.PRNGKey(9)
    want = jax.jit(lambda *a: jax_presets.augment_batch_policy(
        jax_presets.get_policy(policy), *a, **kw))(
        key, jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(valid),
        None, jnp.asarray(kps))
    got = presets.augment_batch_policy(
        presets.get_policy(policy), t(img), t(boxes), t(valid),
        jax_augment_draws(key, b, policy), keypoints=t(kps), **kw)
    assert got[3] is None and want[3] is None
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    for i in (1, 2, 4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    if policy != "none":
        assert not np.array_equal(got[4].numpy(), kps)


# -- dataset keypoint targets -------------------------------------------------

def port_project(jp):
    """The port's copy of a JAX project of rectangles with keypoints."""
    p = Project()
    p.task_names = dict(jp.task_names)
    for label in jp.label_dict.values():
        p.add_label(label.id, label.name, label.colour)
    for im in jp.image_dict.values():
        m = ImageMetadata(im.path, im.container, im.dataset_id, im.frame_id)
        for b in im.boxes:
            m.add_annotation(RectangleAnnotation(
                b.x, b.y, b.width, b.height, b.label, score=b.score,
                keypoints=b.keypoints))
        p.add_image(m)
    return p


def test_dataset_keypoint_targets_and_collate(tmp_path, capsys):
    jp = make_project(str(tmp_path), num_images=5, max_boxes=4, seed=6,
                      image_size=(200, 160), keypoints=True)
    # A box without keypoints, one with a point off the image, one with
    # too many points, and an unreadable file.
    first = next(iter(jp.image_dict.values()))
    first.add_annotation(JaxRect(10.3, 20.7, 30.2, 18.9, "particle"))
    first.add_annotation(JaxRect(5, 6, 40, 30, "particle", keypoints=[
        (10.0, 10.0, 2.0), (-4.0, 12.0, 2.0), (300.0, 8.0, 1.0)]))
    first.add_annotation(JaxRect(50, 60, 40, 30, "particle", keypoints=[
        (60.0 + i, 70.0, 2.0) for i in range(7)]))
    (tmp_path / "broken.jpg").write_bytes(b"not an image")
    from podtpu.data.image import ImageMetadata as JaxImage
    bad = JaxImage("broken.jpg", str(tmp_path), dataset_id=1, frame_id=99)
    bad.add_annotation(JaxRect(1, 2, 30, 40, "particle"))
    jp.add_image(bad)
    kw = dict(image_size=(128, 128), max_gt=8, with_keypoints=True,
              num_keypoints=K)
    jds = jax_dataset.DetectionDataset(jp, **kw)
    pds = dataset.DetectionDataset(port_project(jp), **kw)
    for i in range(len(jds)):
        got, want = pds.load(i), jds.load(i)
        assert got.keypoints.dtype == np.float32 and got.ok == want.ok
        np.testing.assert_array_equal(got.keypoints, want.keypoints)
    assert not pds.load(5).ok and not pds.load(5).keypoints.any()
    first_kps = pds.load(0).keypoints
    assert (first_kps[..., 2] > 0).sum() > 10 and (
        first_kps[..., 2] == 0).any()
    idx = [5, 0, 3, 3]
    got = dataset.collate(pds.load_batch(idx))
    want = jax_dataset.collate(jds.load_batch(idx))
    assert set(got) == set(want) and "keypoints" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    capsys.readouterr()
