"""The podtpu_torch detector against the JAX FasterRCNN (CPU, float32).

One set of weights (flax ``init_variables`` at ``tiny_config`` sizes, 4
classes) drives both models through the weight bridge.  Backbone, FPN and
RPN outputs agree to rtol/atol 1e-4; proposal selection and postprocess, fed
the JAX stage's own inputs, agree exactly in validity and labels and to 1e-4
in boxes and scores; the whole eval forward agrees to 1e-3 in boxes.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from podtpu.models import roi_heads as jax_rh
from podtpu.models import rpn as jax_rpn
from podtpu.models.detector import init_variables
from podtpu.models.detector import make_detector as jax_make_detector
from podtpu.models.weights import convert_torchvision_state_dict
from podtpu.ops.anchors import grid_anchors
from podtpu.train import checkpoints as jax_ckpt
from podtpu.train.step import make_eval_step
from podtpu_torch.core.config import ModelConfig, model_config_from_dict
from podtpu_torch.models import roi_heads as rh
from podtpu_torch.models import rpn
from podtpu_torch.models.detector import (FasterRCNN, init_parameters,
                                          make_detector)
from podtpu_torch.models.weights import (flax_from_state_dict,
                                         state_dict_from_flax)
from podtpu_torch.shared import msgpack
from podtpu_torch.train import checkpoints
from tests.conftest import tiny_config


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax variables as numpy, port model, port config)."""
    jcfg = dataclasses.replace(tiny_config().model, num_classes=4)
    jmodel = jax_make_detector(jcfg)
    variables = init_variables(jmodel, jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, jax.device_get(dict(variables)))
    cfg = model_config_from_dict(dataclasses.asdict(jcfg))
    model = make_detector(cfg)
    sd = state_dict_from_flax(variables["params"], variables["frozen"])
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in sd.items()})
    model = model.to(memory_format=torch.channels_last).eval()
    return jmodel, variables, model, cfg


def images(seed, b=2, size=128):
    return np.random.default_rng(seed).integers(
        0, 256, (b, size, size, 3)).astype(np.uint8)


def nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


# -- (d) weights --------------------------------------------------------------

class TestWeights:
    def test_round_trip_through_torchvision_bridge(self, pair):
        _, variables, model, _ = pair
        sd = state_dict_from_flax(variables["params"], variables["frozen"])
        assert set(sd) == set(model.state_dict())
        back = convert_torchvision_state_dict(
            {k: torch.from_numpy(v.copy()) for k, v in sd.items()}, variables)
        same = jax.tree.map(np.array_equal, back, variables)
        assert all(jax.tree.leaves(same))

    def test_inverse_is_exact(self, pair):
        _, variables, model, _ = pair
        params, frozen = flax_from_state_dict(model.state_dict())
        same = jax.tree.map(np.array_equal, {"params": params,
                                             "frozen": frozen}, variables)
        assert all(jax.tree.leaves(same))

    def test_layouts(self, pair):
        _, variables, model, _ = pair
        sd = model.state_dict()
        fc6 = variables["params"]["box_head"]["fc6"]["kernel"]  # (H,W,C),out
        w = sd["roi_heads.box_head.fc6.weight"].numpy()         # out,(C,H,W)
        c = w.shape[1] // 49
        assert w[5, 3 * 49 + 2 * 7 + 4] == fc6[(2 * 7 + 4) * c + 3, 5]
        conv = variables["params"]["rpn_head"]["deltas"]["kernel"]  # HWIO
        np.testing.assert_array_equal(
            sd["rpn.head.bbox_pred.weight"].numpy(),
            np.transpose(conv, (3, 2, 0, 1)))
        np.testing.assert_array_equal(
            sd["backbone.body.layer1.0.downsample.1.running_var"].numpy(),
            variables["frozen"]["backbone"]["layer1_0"]["bn_down"]["var"])


# -- (e) backbone, FPN and RPN head -------------------------------------------

@pytest.fixture(scope="module")
def jax_features(pair):
    """A float input and the JAX C2..C5, P2..P6 and RPN head outputs."""
    jmodel, variables, _, _ = pair
    x = np.random.default_rng(1).normal(
        size=(2, 128, 128, 3)).astype(np.float32)

    def run(m, x):
        cs = m.backbone(x)
        ps = m.fpn(cs)
        return cs, ps, m.rpn_head(ps)

    out = jmodel.apply(variables, jnp.asarray(x), method=run)
    return x, jax.tree.map(np.asarray, out)


class TestFeatures:
    def test_backbone_fpn_rpn(self, pair, jax_features):
        _, _, model, _ = pair
        x, (cs, ps, (logits, deltas)) = jax_features
        with torch.inference_mode():
            tcs = model.backbone.body(nchw(x))
            tps = model.backbone.fpn(tcs)
            tlogits, tdeltas = model.rpn.head(tps)
        assert len(tcs) == 4 and len(tps) == 5
        for got, want in zip(tcs + tps, list(cs) + list(ps)):
            np.testing.assert_allclose(nhwc(got), want, rtol=1e-4, atol=1e-4)
        for got, want in zip(tlogits + tdeltas, list(logits) + list(deltas)):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                       atol=1e-4)

    def test_compute_dtype_policy(self, pair):
        _, _, model, cfg = pair
        bf = FasterRCNN(dataclasses.replace(cfg, compute_dtype="bfloat16"))
        bf.load_state_dict(model.state_dict())
        bf = bf.to(memory_format=torch.channels_last).eval()
        assert all(p.dtype == torch.float32 for p in bf.parameters())
        with torch.inference_mode():
            pyramid = bf.features(torch.from_numpy(images(2, b=1)))
            logits, deltas = bf.rpn.head(pyramid)
            pooled = rh.pool_rois_batched(
                pyramid, torch.tensor([[[8.0, 8.0, 60.0, 90.0]]]), bf.cfg)
            cls, reg = bf.roi_heads(pooled[0])
        assert pyramid[0].dtype == torch.bfloat16
        assert pyramid[0].is_contiguous(memory_format=torch.channels_last)
        assert logits[0].dtype == deltas[0].dtype == torch.bfloat16
        assert pooled.dtype == torch.bfloat16
        assert cls.dtype == reg.dtype == torch.float32


# -- (f) proposal selection and postprocess -----------------------------------

def jax_anchor_list(cfg):
    return [jnp.asarray(a) for a in grid_anchors(
        tuple(cfg.image_size), tuple(cfg.strides), tuple(cfg.anchor_sizes),
        tuple(cfg.anchor_ratios))]


class TestSelection:
    @pytest.mark.parametrize("ties", [False, True])
    def test_select_proposals(self, pair, jax_features, ties):
        jmodel, _, model, cfg = pair
        _, (_, _, (logits, deltas)) = jax_features
        if ties:  # coarse logits: many equal scores, as bf16 logits have
            logits = [np.round(a, 1) for a in logits]
        anchors = jax_anchor_list(jmodel.cfg)
        want = jax.jit(lambda lg, dl: jax_rpn.select_proposals(
            lg, dl, anchors, jmodel.cfg, train=False))(
            [jnp.asarray(a) for a in logits], [jnp.asarray(a) for a in deltas])
        got = rpn.select_proposals(
            [torch.from_numpy(a) for a in logits],
            [torch.from_numpy(a) for a in deltas], model.rpn.anchors(), cfg)
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                                   atol=1e-4)
        np.testing.assert_allclose(got.scores.numpy(),
                                   np.asarray(want.scores), atol=1e-4)

    def test_postprocess_detections(self, pair):
        jmodel, variables, _, cfg = pair
        rng = np.random.default_rng(4)
        b, p, c = 2, 64, cfg.num_classes
        logits = rng.normal(0, 2, (b, p, c)).astype(np.float32)
        deltas = rng.normal(0, 0.5, (b, p, 4 * c)).astype(np.float32)
        props = np.stack([np.concatenate([
            rng.uniform(0, 80, (p, 2)), rng.uniform(20, 48, (p, 2))], -1)
            for _ in range(b)]).astype(np.float32)
        props[..., 2:] += props[..., :2]
        pvalid = rng.uniform(size=(b, p)) > 0.15
        want = jax.jit(jax.vmap(
            lambda lg, dl, pb, pv: jax_rh.postprocess_detections(
                lg, dl, pb, pv, jmodel.cfg)))(jnp.asarray(logits),
                                         jnp.asarray(deltas),
                                         jnp.asarray(props),
                                         jnp.asarray(pvalid))
        got = rh.postprocess_detections(
            torch.from_numpy(logits), torch.from_numpy(deltas),
            torch.from_numpy(props), torch.from_numpy(pvalid), cfg)
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want[3]))
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want[0]),
                                   atol=1e-4)
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want[1]),
                                   atol=1e-4)


# -- (g) the whole eval forward -----------------------------------------------

class TestEvalForward:
    def test_matches_eval_step(self, pair):
        jmodel, variables, model, _ = pair
        img = images(5)
        want = make_eval_step(jmodel)(variables["params"],
                                      variables["frozen"], jnp.asarray(img))
        scores = np.sort(np.asarray(want.scores)[np.asarray(want.valid)])
        assert scores.size > 10
        # A near tie would make the slot order depend on rounding: fail
        # loudly instead of flaking.
        assert np.diff(scores).min() > 1e-5
        with torch.inference_mode():
            got = model(torch.from_numpy(img))
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(want.labels))
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                                   atol=1e-3)
        np.testing.assert_allclose(got.scores.numpy(),
                                   np.asarray(want.scores), atol=1e-4)

    def test_make_detector_refuses_unported_models(self):
        from podtpu.core.config import fasterrcnn_v2_config, mobilenet_config

        for jcfg in (mobilenet_config(), fasterrcnn_v2_config()):
            cfg = model_config_from_dict(dataclasses.asdict(jcfg))
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                make_detector(cfg)
        for kw in (dict(family="retinanet"), dict(with_mask=True),
                   dict(with_keypoints=True)):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                make_detector(ModelConfig(**kw))

    def test_seeded_init_is_reproducible(self):
        cfg = ModelConfig(image_size=(64, 64))
        a, b = make_detector(cfg), make_detector(cfg)
        init_parameters(a, torch.Generator().manual_seed(3))
        init_parameters(b, torch.Generator().manual_seed(3))
        for (k, va), vb in zip(a.state_dict().items(),
                               b.state_dict().values()):
            assert torch.equal(va, vb), k
        w = a.backbone.body.layer2[0].conv2.weight
        assert abs(float(w.detach().std()) - (1 / (128 * 9)) ** 0.5) < 0.01


# -- (h) model directories ----------------------------------------------------

class TestCheckpoints:
    def test_jax_directory_loads_in_port(self, pair, tmp_path):
        jmodel, variables, _, _ = pair
        jax_ckpt.save_model(str(tmp_path), variables["params"],
                            variables["frozen"], jmodel.cfg, ["a", "b", "c"])
        params, frozen, cfg, labels = checkpoints.load_model(str(tmp_path))
        assert labels == ["a", "b", "c"]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jmodel.cfg)
        same = jax.tree.map(np.array_equal,
                            {"params": params, "frozen": frozen}, variables)
        assert all(jax.tree.leaves(same))

    def test_port_directory_loads_in_jax(self, pair, tmp_path):
        jmodel, variables, model, cfg = pair
        checkpoints.save_model(str(tmp_path), model, cfg, ["x", "y", "z"])
        checkpoints.save_labels(str(tmp_path), ["x", "y", "z"])
        params, frozen, jcfg, labels = jax_ckpt.load_model(str(tmp_path))
        assert labels == ["x", "y", "z"] == checkpoints.read_labels(
            str(tmp_path / "labels.txt"))
        assert jcfg == jmodel.cfg
        same = jax.tree.map(np.array_equal,
                            {"params": params, "frozen": frozen}, variables)
        assert all(jax.tree.leaves(same))

    def test_msgpack_subset_matches_flax(self):
        from flax import serialization

        rng = np.random.default_rng(6)
        tree = {f"k{i}": {"a": rng.normal(size=(3, i + 1)).astype(np.float32)}
                for i in range(20)}  # map16 at the top
        tree["big"] = rng.normal(size=(300, 300)).astype(np.float32)
        tree["ints"] = np.arange(7, dtype=np.int32)
        tree["scalar"] = np.asarray(2.5, np.float64)
        tree["empty"] = np.zeros((0, 4), np.uint8)
        ours = msgpack.unpackb(serialization.to_bytes(tree))
        theirs = serialization.msgpack_restore(msgpack.packb(tree))
        for back in (ours, theirs):
            same = jax.tree.map(
                lambda a, b: a.dtype == b.dtype and np.array_equal(a, b),
                back, tree)
            assert all(jax.tree.leaves(same))

    def test_msgpack_rejects_outside_subset(self):
        import msgpack as reference

        with pytest.raises(ValueError, match="subset"):
            msgpack.unpackb(reference.packb({"a": 1.5}))
        with pytest.raises(ValueError, match="subset"):
            msgpack.unpackb(reference.packb({"a": True}))
        with pytest.raises(TypeError):
            msgpack.packb({"a": [1, 2]})
