"""podtpu_torch training ops against the JAX package (CPU, float32).

The same numpy inputs, and the uniform draws JAX makes from its keys, go
through both.  Box encoding agrees to 1e-5; matching and sampling agree
exactly (indices, validity, labels: the port keeps ``lax.top_k``'s and
``argmax``'s tie order); the RPN and box-head losses agree to rtol 1e-5;
the RoIAlign backward agrees with the Pallas kernel in interpret mode and
with XLA autodiff to 1e-3, the tolerance of tests/test_pallas_roi_align.py.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from podtpu.models import roi_heads as jax_rh
from podtpu.models import rpn as jax_rpn
from podtpu.ops import boxes as jax_boxes
from podtpu.ops import matching as jax_matching
from podtpu.ops import roi_align as jax_roi
from podtpu.ops.anchors import grid_anchors
from podtpu.ops.pallas.roi_align_kernel import batched_roi_align_pallas
from podtpu_torch.core.config import model_config_from_dict
from podtpu_torch.models import roi_heads as rh
from podtpu_torch.models import rpn
from podtpu_torch.ops import _build, boxes, matching, roi_align
from tests.conftest import tiny_config
from tests.test_ops_boxes import random_boxes
from tests.test_torch_ops import (EDGE_ROIS, STRIDES, canonical_rois,
                                  feature_levels)


def t(a):
    return torch.from_numpy(np.array(a))


def sampler_draws(key, n):
    """The two uniform vectors ``balanced_sample_gather`` draws from
    ``key`` (``matching.py:210-212``)."""
    kp, kn = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kp, (n,))),
            np.asarray(jax.random.uniform(kn, (n,))))


def batch_sampler_draws(key, b, n):
    """Per-image sampler draws after ``jax.random.split(key, b)``, as the
    vmapped RPN loss and RoI sampler split (``rpn.py:245``,
    ``detector.py:183``): ``([b, n], [b, n])``."""
    pairs = [sampler_draws(k, n) for k in jax.random.split(key, b)]
    return (np.stack([p for p, _ in pairs]), np.stack([q for _, q in pairs]))


def gt_batch(rng, b, g, canvas=128.0, classes=3):
    """Padded gt: 0..g real boxes per image (one image has none)."""
    gtb = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    labels = np.zeros((b, g), np.int32)
    for i in range(b):
        n = 0 if i == b - 1 and b > 2 else int(rng.integers(1, g + 1))
        xy = rng.uniform(0, canvas - 24, (n, 2))
        wh = rng.uniform(8, 48, (n, 2))
        gtb[i, :n] = np.concatenate([xy, np.minimum(xy + wh, canvas)], 1)
        valid[i, :n] = True
        labels[i, :n] = rng.integers(1, classes + 1, n)
    return gtb, labels, valid


@pytest.fixture(scope="module")
def cfgs():
    jcfg = dataclasses.replace(tiny_config().model, num_classes=4)
    return jcfg, model_config_from_dict(dataclasses.asdict(jcfg))


# -- encoding and matching ----------------------------------------------------

class TestEncodeAndMatch:
    @pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0),
                                         (10.0, 10.0, 5.0, 5.0)])
    def test_encode_boxes(self, weights):
        rng = np.random.default_rng(0)
        ref, prop = random_boxes(rng, 64), random_boxes(rng, 64)
        prop[:4] = prop[:4, [0, 1, 0, 1]]   # degenerate proposals
        ref[4:8] = ref[4:8, [0, 1, 0, 1]]   # degenerate targets
        want = np.asarray(jax_boxes.encode_boxes(
            jnp.asarray(ref), jnp.asarray(prop), weights=weights))
        got = boxes.encode_boxes(t(ref), t(prop), weights=weights).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("low_quality", [False, True])
    @pytest.mark.parametrize("gt_case", ["some", "none"])
    def test_match(self, low_quality, gt_case):
        rng = np.random.default_rng(1)
        cand = random_boxes(rng, 300, size=80.0)
        gt = random_boxes(rng, 12, size=80.0)
        cand[10:20] = gt[3]                 # ties for the best IoU of gt 3
        gt[7] = gt[2]                       # duplicate gts: argmax takes 2
        gt_valid = rng.uniform(size=12) > 0.3
        gt_valid[[2, 3, 7]] = True
        if gt_case == "none":
            gt_valid[:] = False
        iou = np.asarray(jax_boxes.box_iou(jnp.asarray(cand),
                                           jnp.asarray(gt)))
        want = jax_matching.match(jnp.asarray(iou), jnp.asarray(gt_valid),
                                  0.7, 0.3, allow_low_quality=low_quality)
        got = matching.match(t(iou), t(gt_valid), 0.7, 0.3,
                             allow_low_quality=low_quality)
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(want.labels))
        np.testing.assert_array_equal(got.matched_idx.numpy(),
                                      np.asarray(want.matched_idx))
        if gt_case == "none":
            assert not got.labels.numpy().any()

    def test_match_batched_equals_per_image(self):
        rng = np.random.default_rng(2)
        iou = rng.uniform(0, 1, (3, 50, 6)).astype(np.float32)
        iou[..., 4] = iou[..., 1]           # ties across gts
        valid = rng.uniform(size=(3, 6)) > 0.3
        got = matching.match(t(iou), t(valid), 0.5, 0.4, True)
        for i in range(3):
            want = jax_matching.match(jnp.asarray(iou[i]),
                                      jnp.asarray(valid[i]), 0.5, 0.4, True)
            np.testing.assert_array_equal(got.labels[i].numpy(),
                                          np.asarray(want.labels))
            np.testing.assert_array_equal(got.matched_idx[i].numpy(),
                                          np.asarray(want.matched_idx))


# -- sampling -------------------------------------------------------------------

class TestSampling:
    @pytest.mark.parametrize("n,batch,frac,approx", [
        (4092, 256, 0.5, True),    # RPN at tiny_config: JAX's approx path
        (136, 32, 0.25, True),     # RoI head at tiny_config
        (50, 64, 0.25, False),     # fewer candidates than the batch
        (600, 128, 0.25, False),   # a larger pool, exact top-k
    ])
    def test_balanced_sample_gather(self, n, batch, frac, approx):
        rng = np.random.default_rng(n)
        labels = rng.choice([1, 0, 0, 0, -1], size=n).astype(np.int32)
        cvalid = rng.uniform(size=n) > 0.1
        key = jax.random.PRNGKey(n)
        u_pos, u_neg = sampler_draws(key, n)
        want = jax_matching.balanced_sample_gather(
            key, jnp.asarray(labels), jnp.asarray(cvalid), batch, frac,
            approx=approx)
        got = matching.balanced_sample_gather(t(labels), t(cvalid), batch,
                                              frac, t(u_pos), t(u_neg))
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        np.testing.assert_array_equal(got.is_pos.numpy(),
                                      np.asarray(want.is_pos))
        assert got.valid.any()


# -- losses ---------------------------------------------------------------------

def rpn_outputs(rng, cfg, b):
    """Random per-level RPN logits ``[B, Hl*Wl*A]`` and deltas."""
    anchors = grid_anchors(tuple(cfg.image_size), tuple(cfg.strides),
                           tuple(cfg.anchor_sizes), tuple(cfg.anchor_ratios))
    logits = [rng.normal(0, 2, (b, len(a))).astype(np.float32)
              for a in anchors]
    deltas = [rng.normal(0, 0.3, (b, len(a), 4)).astype(np.float32)
              for a in anchors]
    return anchors, logits, deltas


class TestLosses:
    @pytest.mark.parametrize("weighted", [False, True])
    def test_rpn_losses(self, cfgs, weighted):
        jcfg, cfg = cfgs
        rng = np.random.default_rng(6)
        b = 3
        anchors, logits, deltas = rpn_outputs(rng, jcfg, b)
        gtb, _, gtv = gt_batch(rng, b, 8)
        img_w = np.array([1.0, 0.0, 1.0], np.float32) if weighted else None
        all_anchors = np.concatenate(anchors)
        key = jax.random.PRNGKey(6)
        want = jax_rpn.rpn_losses(
            key, [jnp.asarray(x) for x in logits],
            [jnp.asarray(x) for x in deltas], jnp.asarray(all_anchors),
            jnp.asarray(gtb), jnp.asarray(gtv), jcfg,
            img_weight=None if img_w is None else jnp.asarray(img_w))
        u_pos, u_neg = batch_sampler_draws(key, b, len(all_anchors))
        tl = [t(x).requires_grad_() for x in logits]
        got = rpn.rpn_losses(tl, [t(x) for x in deltas], t(all_anchors),
                             t(gtb), t(gtv), cfg, t(u_pos), t(u_neg),
                             img_weight=None if img_w is None else t(img_w))
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g.detach()), float(w), rtol=1e-5)
        # Gradients reach the logits only through the sampled anchors.
        got[0].backward()
        want_g = jax.grad(lambda lg: jax_rpn.rpn_losses(
            key, lg, [jnp.asarray(x) for x in deltas],
            jnp.asarray(all_anchors), jnp.asarray(gtb), jnp.asarray(gtv),
            jcfg, img_weight=None if img_w is None
            else jnp.asarray(img_w))[0])([jnp.asarray(x) for x in logits])
        for g, w in zip(tl, want_g):
            np.testing.assert_allclose(g.grad.numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-8)

    def test_sample_rois_and_box_losses(self, cfgs):
        jcfg, cfg = cfgs
        rng = np.random.default_rng(7)
        b, p, g = 2, jcfg.rpn_post_nms_topk_train, 8
        gtb, gtl, gtv = gt_batch(rng, b, g)
        props = np.stack([random_boxes(rng, p, size=100.0)
                          for _ in range(b)])
        props[:, :20] = gtb[:, :1] + rng.normal(0, 3, (b, 20, 4))  # overlaps
        props = np.clip(props, 0, 128).astype(np.float32)
        pvalid = rng.uniform(size=(b, p)) > 0.2
        key = jax.random.PRNGKey(7)
        want = jax.vmap(lambda r, pb, pv, gb, gl, gv: jax_rh.sample_rois(
            r, pb, pv, gb, gl, gv, jcfg))(
            jax.random.split(key, b), jnp.asarray(props),
            jnp.asarray(pvalid), jnp.asarray(gtb), jnp.asarray(gtl),
            jnp.asarray(gtv))
        u_pos, u_neg = batch_sampler_draws(key, b, p + g)
        got = rh.sample_rois(t(props), t(pvalid), t(gtb), t(gtl), t(gtv),
                             cfg, t(u_pos), t(u_neg))
        for name in ("valid", "is_pos", "cls_targets"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                err_msg=name)
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                                   atol=1e-6)
        np.testing.assert_allclose(got.reg_targets.numpy(),
                                   np.asarray(want.reg_targets), rtol=1e-5,
                                   atol=1e-5)
        assert got.is_pos.any() and (got.valid & ~got.is_pos).any()

        s = got.valid.shape[1]
        c = cfg.num_classes
        logits = rng.normal(0, 1, (b * s, c)).astype(np.float32)
        deltas = rng.normal(0, 0.5, (b * s, 4 * c)).astype(np.float32)
        sw = np.repeat(np.array([1.0, 0.5], np.float32), s)
        jflat = jax.tree.map(lambda x: x.reshape((b * s,) + x.shape[2:]),
                             want)
        tflat = rh.SampledRois(*(x.reshape(b * s, *x.shape[2:])
                                 for x in got))
        for weight in (None, sw):
            wl = jax_rh.box_head_losses(
                jnp.asarray(logits), jnp.asarray(deltas), jflat,
                sample_weight=None if weight is None else jnp.asarray(weight))
            gl = rh.box_head_losses(t(logits), t(deltas), tflat,
                                    None if weight is None else t(weight))
            for x, y in zip(gl, wl):
                np.testing.assert_allclose(float(x), float(y), rtol=1e-5)


# -- RoIAlign backward ------------------------------------------------------------

def xla_grad(feats, rois, g):
    def f(fs):
        flat, geom = jax_roi.flatten_levels(list(fs))
        return jax.vmap(lambda x, r: jax_roi.multilevel_roi_align(
            x, geom, r, strides=STRIDES))(flat, jnp.asarray(rois))

    _, vjp = jax.vjp(f, tuple(jnp.asarray(x) for x in feats))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))[0]]


def pallas_grad(feats, rois, g):
    _, vjp = jax.vjp(lambda fs: batched_roi_align_pallas(
        fs, jnp.asarray(rois), STRIDES), tuple(jnp.asarray(x) for x in feats))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))[0]]


class TestRoIAlignBackward:
    @pytest.mark.parametrize("batch", [1, 2])
    def test_matches_pallas_and_xla(self, batch):
        rng = np.random.default_rng(20 + batch)
        feats = feature_levels(20 + batch, batch)
        rois = np.stack([np.concatenate([canonical_rois(rng, 10), EDGE_ROIS])
                         for _ in range(batch)])
        g = rng.normal(size=(batch, rois.shape[1], 7, 7, 8)).astype(
            np.float32)
        got = roi_align.batched_roi_align_backward(
            t(g), [t(f) for f in feats], t(rois), STRIDES)
        want_xla = xla_grad(feats, rois, g)
        want_pallas = pallas_grad(feats, rois, g)
        for lvl, (x, w, pl) in enumerate(zip(got, want_xla, want_pallas)):
            assert x.shape == feats[lvl].shape and x.dtype == torch.float32
            np.testing.assert_allclose(x.numpy(), w, atol=1e-3)
            np.testing.assert_allclose(x.numpy(), pl, atol=1e-3)
        assert any(float(x.abs().sum()) > 0 for x in got)

    def test_equals_autograd_of_forward(self):
        rng = np.random.default_rng(23)
        feats = feature_levels(23, 2)
        rois = np.stack([canonical_rois(rng, 6) for _ in range(2)])
        g = rng.normal(size=(2, 6, 7, 7, 8)).astype(np.float32)
        tf = [t(f).requires_grad_() for f in feats]
        roi_align.batched_roi_align(tf, t(rois), STRIDES).backward(t(g))
        got = roi_align.batched_roi_align_backward_plain(
            t(g), [t(f) for f in feats], t(rois), STRIDES)
        for a, x in zip(got, tf):
            np.testing.assert_allclose(a.numpy(), x.grad.numpy(), atol=1e-6)

    def test_autograd_function_wiring(self):
        """The registered operators that carry the two kernels on the card
        (``podtpu::roi_align_fwd`` and its gradient
        ``podtpu::roi_align_bwd``), run here on their plain versions: the
        level gradients reach the levels in their dtype and layout, the
        boxes get none, and the launch counters stay at zero."""
        rng = np.random.default_rng(24)
        feats = feature_levels(24, 2)
        rois = np.stack([np.concatenate([canonical_rois(rng, 5), EDGE_ROIS])
                         for _ in range(2)])
        g = rng.normal(size=(2, rois.shape[1], 7, 7, 8)).astype(np.float32)
        _build.reset_launches()
        tb = t(rois).requires_grad_()
        tf = [t(f).requires_grad_() for f in feats]
        out = roi_align.batched_roi_align(tf, tb, STRIDES, 7, 2)
        out.backward(t(g))
        want = xla_grad(feats, rois, g)
        for x, w in zip(tf, want):
            assert x.grad.dtype == x.dtype and x.grad.shape == x.shape
            np.testing.assert_allclose(x.grad.numpy(), w, atol=1e-3)
        assert tb.grad is None and not _build.launches

    def test_backward_casts_to_level_dtype(self):
        rng = np.random.default_rng(25)
        feats = [torch.from_numpy(f).to(torch.bfloat16)
                 for f in feature_levels(25, 1)]
        rois = canonical_rois(rng, 4)[None]
        g = torch.from_numpy(rng.normal(size=(1, 4, 7, 7, 8)).astype(
            np.float32)).to(torch.bfloat16)
        got = roi_align.batched_roi_align_backward(g, feats, t(rois),
                                                   STRIDES)
        want = roi_align.batched_roi_align_backward_plain(
            g.float(), [f.float() for f in feats], t(rois), STRIDES)
        for x, w in zip(got, want):
            assert x.dtype == torch.bfloat16
            # one bf16 rounding of each float32 sum
            np.testing.assert_allclose(x.float().numpy(), w.numpy(),
                                       rtol=2 ** -8, atol=1e-6)
