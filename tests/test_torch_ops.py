"""podtpu_torch ops against the JAX package on the same numpy inputs (CPU).

Boxes and anchors agree to 1e-5; NMS keep masks are equal to podtpu's
``nms_keep``, to the Pallas kernel in interpret mode and to the python
oracle; RoIAlign agrees with ``multilevel_roi_align`` and the Pallas kernel
(interpret mode) to 2e-4, the tolerance of tests/test_pallas_roi_align.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from podtpu.ops import anchors as jax_anchors
from podtpu.ops import boxes as jax_boxes
from podtpu.ops import nms as jax_nms
from podtpu.ops import roi_align as jax_roi
from podtpu.ops.pallas.nms_kernel import nms_fixpoint_pallas
from podtpu.ops.pallas.roi_align_kernel import batched_roi_align_pallas
from podtpu_torch.ops import _build
from podtpu_torch.ops import anchors, boxes, nms, roi_align
from tests.test_ops_boxes import nms_oracle, random_boxes

STRIDES = (4, 8, 16, 32)


def t(a):
    return torch.from_numpy(np.array(a))


# -- (a) boxes and anchors ----------------------------------------------------

class TestBoxesAndAnchors:
    def test_box_iou(self):
        rng = np.random.default_rng(0)
        a, b = random_boxes(rng, 40), random_boxes(rng, 30)
        a[3] = a[3, [0, 1, 0, 1]]  # a zero-area box: IoU 0, not NaN
        want = np.asarray(jax_boxes.box_iou(jnp.asarray(a), jnp.asarray(b)))
        got = boxes.box_iou(t(a), t(b)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)

    @pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0),
                                         (10.0, 10.0, 5.0, 5.0)])
    def test_decode_and_clip(self, weights):
        rng = np.random.default_rng(1)
        anc = random_boxes(rng, 64)
        codes = rng.normal(0, 2, (64, 4)).astype(np.float32)
        codes[:8, 2:] = 30.0  # beyond BBOX_XFORM_CLIP
        want = jax_boxes.decode_boxes(jnp.asarray(codes), jnp.asarray(anc),
                                      weights=weights)
        got = boxes.decode_boxes(t(codes), t(anc), weights=weights)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        want_c = np.asarray(jax_boxes.clip_boxes(want, (90, 120)))
        got_c = boxes.clip_boxes(got, (90, 120)).numpy()
        np.testing.assert_allclose(got_c, want_c, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(
            boxes.small_box_mask(t(want_c), 3.0).numpy(),
            np.asarray(jax_boxes.small_box_mask(jnp.asarray(want_c), 3.0)))

    @pytest.mark.parametrize("image_size", [(128, 128), (1024, 1024),
                                            (96, 160)])
    def test_grid_anchors(self, image_size):
        want = jax_anchors.grid_anchors(image_size)
        got = anchors.grid_anchors(image_size)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-5)

    def test_cell_anchors_multi_size(self):
        sizes = (32.0, 64.0, 128.0)
        np.testing.assert_allclose(
            anchors.cell_anchors(sizes, (0.5, 1.0, 2.0)),
            jax_anchors.cell_anchors(sizes, (0.5, 1.0, 2.0)), atol=1e-5)

    def test_assign_levels_with_bump(self):
        rng = np.random.default_rng(2)
        bx = random_boxes(rng, 200, size=900.0)
        bx[:10] = [[0, 500, 1000, 530]]  # small area, long side: bumped
        bx[10:20] = 0.0                  # invalid slots
        want = np.asarray(jax_roi.assign_levels(jnp.asarray(bx), 4))
        got = roi_align.assign_levels(t(bx), 4).numpy()
        np.testing.assert_array_equal(got, want)
        strict = np.asarray(jax_roi.assign_levels(jnp.asarray(bx), 4,
                                                  max_span_cells=None))
        assert (want[:10] > strict[:10]).all()


# -- (b) NMS ------------------------------------------------------------------

def pallas_keep(sorted_boxes, valid, thresh):
    """Keep mask of the Pallas kernel (interpret mode), padding to 128."""
    n = len(sorted_boxes)
    pad = (-n) % 128
    pb = np.pad(sorted_boxes, ((0, pad), (0, 0)))
    pv = np.pad(valid, (0, pad))
    return np.asarray(nms_fixpoint_pallas(jnp.asarray(pb), jnp.asarray(pv),
                                          thresh))[:n]


def chain_boxes(n):
    x = 4.0 * np.arange(n, dtype=np.float32)
    return np.stack([x, np.zeros(n, np.float32), x + 10,
                     np.full(n, 10, np.float32)], axis=1)


def cluster_boxes(rng, n):
    cx = rng.uniform(40, 60, n).astype(np.float32)
    cy = rng.uniform(40, 60, n).astype(np.float32)
    w = rng.uniform(20, 40, n).astype(np.float32)
    return np.stack([cx - w / 2, cy - w / 2, cx + w / 2, cy + w / 2], 1)


class TestNMS:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
    def test_matches_jax_and_oracle(self, seed, thresh):
        rng = np.random.default_rng(seed)
        n = 160
        bx = random_boxes(rng, n, size=80.0)
        scores = rng.uniform(0, 1, n).astype(np.float32)
        scores[::7] = scores[0]  # ties: the lower index goes first
        valid = rng.uniform(size=n) > 0.1
        got = nms.nms_keep(t(bx), t(scores), thresh, t(valid)).numpy()
        want = np.asarray(jax_nms.nms_keep(jnp.asarray(bx),
                                           jnp.asarray(scores), thresh,
                                           valid=jnp.asarray(valid)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, nms_oracle(bx, scores, thresh, valid))

    @pytest.mark.parametrize("case", ["random", "validity", "chain",
                                      "identical", "cross_tile"])
    def test_plain_matches_pallas_interpret(self, case):
        rng = np.random.default_rng(11)
        thresh = 0.5
        if case == "random":
            sb, valid = random_boxes(rng, 256, size=60.0), np.ones(256, bool)
        elif case == "validity":
            sb = random_boxes(rng, 256, size=50.0)
            valid = np.arange(256) < 100
        elif case == "chain":  # greedy keeps every other box
            sb, valid, thresh = chain_boxes(384), np.ones(384, bool), 0.3
        elif case == "identical":
            sb = np.tile(np.array([[10, 10, 50, 50]], np.float32), (130, 1))
            valid = np.ones(130, bool)
        else:  # dense cluster whose chains straddle the 128-box tiles
            sb, valid = cluster_boxes(rng, 384), np.ones(384, bool)
        got = nms.nms_keep_batched(t(sb)[None], t(valid)[None],
                                   thresh)[0].numpy()
        np.testing.assert_array_equal(got, pallas_keep(sb, valid, thresh))
        if case == "chain":
            assert got[0] and not got[1] and got[2]
        if case == "identical":
            assert got[0] and not got[1:].any()

    def test_multi_segment_batch(self):
        """One call over S segments equals S separate podtpu NMS calls."""
        rng = np.random.default_rng(3)
        s, n = 6, 96
        bx = np.stack([random_boxes(rng, n, size=70.0) for _ in range(s)])
        bx[2] = cluster_boxes(rng, n)
        scores = rng.uniform(0, 1, (s, n)).astype(np.float32)
        valid = rng.uniform(size=(s, n)) > 0.2
        valid[4, 40:] = False  # a padded segment
        got = nms.nms_keep_segments(t(bx), t(scores), 0.6, t(valid)).numpy()
        for i in range(s):
            want = np.asarray(jax_nms.nms_keep(
                jnp.asarray(bx[i]), jnp.asarray(scores[i]), 0.6,
                valid=jnp.asarray(valid[i])))
            np.testing.assert_array_equal(got[i], want)

    def test_topk_by_score_ties(self):
        rng = np.random.default_rng(4)
        scores = np.round(rng.uniform(0, 1, 300), 1).astype(np.float32)
        keep = rng.uniform(size=300) > 0.3
        idx, valid = nms.topk_by_score(t(scores), t(keep), 250)
        widx, wvalid = jax_nms.topk_by_score(jnp.asarray(scores),
                                             jnp.asarray(keep), 250)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))
        np.testing.assert_array_equal(idx.numpy()[valid.numpy()],
                                      np.asarray(widx)[np.asarray(wvalid)])

    def test_nms_select_with_categories(self):
        rng = np.random.default_rng(5)
        n = 120
        bx = random_boxes(rng, n, size=60.0)
        scores = rng.uniform(0, 1, n).astype(np.float32)
        cats = rng.integers(0, 3, n)
        valid = rng.uniform(size=n) > 0.1
        got = nms.nms_select(t(bx), t(scores), 0.5, 40, valid=t(valid),
                             idxs=t(cats))
        want = jax_nms.nms_select(jnp.asarray(bx), jnp.asarray(scores), 0.5,
                                  40, valid=jnp.asarray(valid),
                                  idxs=jnp.asarray(cats))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)

    def test_cpu_runs_plain_and_counts_no_launch(self):
        _build.reset_launches()
        bx = t(chain_boxes(70))[None]
        keep = nms.nms_keep_batched(bx, torch.ones(1, 70, dtype=torch.bool),
                                    0.3)
        np.testing.assert_array_equal(
            keep.numpy(), nms.nms_keep_plain(bx, torch.ones(1, 70, dtype=bool),
                                             0.3).numpy())
        assert not _build.launches

    def test_rejects_bad_input(self):
        with pytest.raises(ValueError):
            nms.nms_keep_batched(torch.zeros(3, 4), torch.ones(3, dtype=bool),
                                 0.5)
        with pytest.raises(ValueError, match="boxes must be float32"):
            nms.nms_keep_batched(torch.zeros(1, 3, 4, dtype=torch.float64),
                                 torch.ones(1, 3, dtype=bool), 0.5)


# -- (c) RoIAlign -------------------------------------------------------------

def feature_levels(seed, batch, c=8, size=32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(batch, size >> i, size >> i, c))
            .astype(np.float32) for i in range(4)]


def canonical_rois(rng, n, canvas=128.0):
    size = rng.uniform(20, 300, n)
    ar = rng.uniform(0.5, 2.0, n)
    w, h = size * np.sqrt(ar), size / np.sqrt(ar)
    x = rng.uniform(0, np.maximum(canvas - w, 1))
    y = rng.uniform(0, np.maximum(canvas - h, 1))
    return np.stack([x, y, x + w, y + h], -1).astype(np.float32)


EDGE_ROIS = np.asarray([
    [0, 0, 0, 0],            # degenerate / invalid slot
    [0, 0, 127, 127],        # whole canvas
    [-10, -10, 20, 20],      # partly outside
    [120, 120, 140, 140],    # off the edge
    [0, 50, 127, 56],        # long and thin: bumped to a coarser level
    [60, 0, 64, 127],        # tall and thin: bumped
    [3.3, 7.7, 3.4, 7.9],    # sub-pixel
], np.float32)


def jax_reference(feats, rois):
    flat, geom = jax_roi.flatten_levels([jnp.asarray(f) for f in feats])
    return np.asarray(jax.vmap(
        lambda f, r: jax_roi.multilevel_roi_align(f, geom, r,
                                                  strides=STRIDES)
    )(flat, jnp.asarray(rois)))


class TestRoIAlign:
    @pytest.mark.parametrize("batch", [1, 3])
    def test_matches_xla_and_pallas(self, batch):
        rng = np.random.default_rng(batch)
        feats = feature_levels(batch, batch)
        rois = np.stack([np.concatenate([canonical_rois(rng, 12), EDGE_ROIS])
                         for _ in range(batch)])
        got = roi_align.batched_roi_align([t(f) for f in feats], t(rois),
                                          STRIDES).numpy()
        assert got.shape == (batch, rois.shape[1], 7, 7, 8)
        np.testing.assert_allclose(got, jax_reference(feats, rois),
                                   atol=2e-4)
        pallas = np.asarray(batched_roi_align_pallas(
            tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois),
            STRIDES))
        np.testing.assert_allclose(got, pallas, atol=2e-4)

    def test_output_size_14_and_chunking(self):
        rng = np.random.default_rng(7)
        feats = feature_levels(7, 1, c=4)
        rois = canonical_rois(rng, 40)[None]
        got = roi_align.batched_roi_align_plain(
            [t(f) for f in feats], t(rois), STRIDES, output_size=14,
            roi_chunk=16).numpy()
        flat, geom = jax_roi.flatten_levels([jnp.asarray(f) for f in feats])
        want = np.asarray(jax_roi.multilevel_roi_align(
            flat[0], geom, jnp.asarray(rois[0]), strides=STRIDES,
            output_size=14))
        np.testing.assert_allclose(got[0], want, atol=2e-4)

    def test_plain_is_differentiable_like_jax(self):
        rng = np.random.default_rng(8)
        feats = feature_levels(8, 2)
        rois = np.stack([canonical_rois(rng, 6) for _ in range(2)])
        tf = [t(f).requires_grad_() for f in feats]
        out = roi_align.batched_roi_align_plain(tf, t(rois), STRIDES)
        (out ** 2).sum().backward()

        def loss(fs):
            flat, geom = jax_roi.flatten_levels(list(fs))
            o = jax.vmap(lambda f, r: jax_roi.multilevel_roi_align(
                f, geom, r, strides=STRIDES))(flat, jnp.asarray(rois))
            return jnp.sum(o ** 2)

        want = jax.grad(loss)(tuple(jnp.asarray(f) for f in feats))
        for g, w in zip(tf, want):
            np.testing.assert_allclose(g.grad.numpy(), np.asarray(w),
                                       atol=1e-3)

    def test_cpu_counts_no_launch(self):
        _build.reset_launches()
        feats = feature_levels(9, 1)
        roi_align.batched_roi_align([t(f) for f in feats],
                                    t(EDGE_ROIS[None]), STRIDES)
        assert not _build.launches
