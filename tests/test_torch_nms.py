"""The NMS wrapper's score-order forms against podtpu (CPU).

``nms_keep_segments(..., presorted=True)`` on RPN-like segments (scores
already descending, with ties, invalid entries among the valid ones, a
padded segment) is equal to the sorted path and to ``podtpu``'s
``nms_keep`` flag for flag; ``nms_keep_batched`` with an ``order`` equals
the sorted boxes' mask scattered back; ``select_proposals`` on levels with
invalid entries among the valid ones equals its JAX counterpart; the
wrapper's argument checks raise naming the argument.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from podtpu.models import rpn as jax_rpn
from podtpu.ops import nms as jax_nms
from podtpu.ops.anchors import grid_anchors
from podtpu_torch.core.config import model_config_from_dict
from podtpu_torch.models import rpn
from podtpu_torch.ops import nms
from tests.conftest import tiny_config
from tests.test_ops_boxes import random_boxes
from tests.test_torch_mask import torch_threads  # noqa: F401


def rpn_like(seed, s=5, n=256):
    """Boxes, descending scores with ties, and validity with holes; the last
    segment padded like the RPN's P6 (NEG_INF scores, invalid tail)."""
    rng = np.random.default_rng(seed)
    boxes = np.stack([random_boxes(rng, n, size=90.0) for _ in range(s)])
    scores = -np.sort(-np.round(rng.uniform(0, 1, (s, n)), 2), axis=1)
    valid = rng.uniform(size=(s, n)) > 0.2
    scores[-1, n - 100:] = nms.NEG_INF
    valid[-1, n - 100:] = False
    return boxes, scores.astype(np.float32), valid


@pytest.mark.parametrize("seed,thresh", [(0, 0.7), (1, 0.5), (2, 0.3)])
def test_presorted_equals_sorted_and_jax(seed, thresh):
    bx, sc, v = rpn_like(seed)
    args = (torch.from_numpy(bx), torch.from_numpy(sc), thresh,
            torch.from_numpy(v))
    got = nms.nms_keep_segments(*args, presorted=True).numpy()
    np.testing.assert_array_equal(got, nms.nms_keep_segments(*args).numpy())
    for i in range(len(bx)):
        want = np.asarray(jax_nms.nms_keep(
            jnp.asarray(bx[i]), jnp.asarray(sc[i]), thresh,
            valid=jnp.asarray(v[i])))
        np.testing.assert_array_equal(got[i], want)
    assert got.any() and (v & ~got).any()   # some kept, some suppressed


def test_order_path_scatters_back():
    rng = np.random.default_rng(3)
    bx, _, v = rpn_like(3, s=3, n=200)
    order = np.stack([rng.permutation(200) for _ in range(3)])
    sboxes = np.take_along_axis(bx, order[..., None], 1)
    svalid = np.take_along_axis(v, order, 1)
    want_sorted = nms.nms_keep_plain(torch.from_numpy(sboxes),
                                     torch.from_numpy(svalid), 0.5).numpy()
    want = np.zeros_like(want_sorted)
    np.put_along_axis(want, order, want_sorted, 1)
    got = nms.nms_keep_batched(torch.from_numpy(bx), torch.from_numpy(v), 0.5,
                               torch.from_numpy(order)).numpy()
    np.testing.assert_array_equal(got, want)


def test_select_proposals_with_invalid_among_valid():
    """Some anchors decode to boxes below ``rpn_min_size``: invalid entries
    sit among the valid ones of each level's top-k, where the port's NMS
    takes them without sorting."""
    jcfg = dataclasses.replace(tiny_config().model, num_classes=4)
    cfg = model_config_from_dict(dataclasses.asdict(jcfg))
    anc = grid_anchors(tuple(jcfg.image_size), tuple(jcfg.strides),
                       tuple(jcfg.anchor_sizes), tuple(jcfg.anchor_ratios))
    rng = np.random.default_rng(7)
    logits, deltas = [], []
    for a in anc:
        n = a.shape[0]
        logits.append(np.round(rng.normal(0, 1, (2, n)), 1).astype(np.float32))
        d = rng.normal(0, 0.3, (2, n, 4)).astype(np.float32)
        tiny = rng.uniform(size=(2, n)) < 0.25
        d[tiny, 2:] = -20.0             # width and height below rpn_min_size
        deltas.append(d)
        if n >= jcfg.rpn_pre_nms_topk_test:
            top = np.argsort(-logits[-1][0], kind="stable")[
                :jcfg.rpn_pre_nms_topk_test]
            flags = tiny[0, top]
            assert flags.any() and (~flags[np.argmax(flags):]).any()
    janc = [jnp.asarray(a) for a in anc]
    want = jax.jit(lambda lg, dl: jax_rpn.select_proposals(
        lg, dl, janc, jcfg, train=False))(
        [jnp.asarray(x) for x in logits], [jnp.asarray(x) for x in deltas])
    got = rpn.select_proposals([torch.from_numpy(x) for x in logits],
                               [torch.from_numpy(x) for x in deltas],
                               [torch.from_numpy(np.asarray(a)) for a in anc],
                               cfg)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4)


def _bad(case):
    boxes, valid = torch.zeros(2, 8, 4), torch.ones(2, 8, dtype=torch.bool)
    order = torch.arange(8).repeat(2, 1)
    if case == "order_dtype":
        return lambda: nms.nms_keep_batched(boxes, valid, 0.5, order.int())
    if case == "order_shape":
        return lambda: nms.nms_keep_batched(boxes, valid, 0.5, order[:, :4])
    if case == "boxes_dtype":
        return lambda: nms.nms_keep_batched(boxes.double(), valid, 0.5)
    if case == "too_many_boxes":
        n = nms.MAX_BOXES + 1
        return lambda: nms._check_kernel_inputs(
            torch.zeros(1, n, 4), torch.ones(1, n, dtype=torch.bool), None)
    if case == "order_not_contiguous":
        return lambda: nms._check_kernel_inputs(
            boxes, valid, torch.arange(8).repeat(2, 2)[:, ::2])
    raise AssertionError(case)


@pytest.mark.parametrize("case,match", [
    ("order_dtype", "order"), ("order_shape", "order"),
    ("boxes_dtype", "boxes"), ("too_many_boxes", "MAX_BOXES"),
    ("order_not_contiguous", "order")])
def test_rejects_bad_input(case, match):
    with pytest.raises(ValueError, match=match):
        _bad(case)()
