"""The v2 recipe (Faster and Mask R-CNN R50-FPN v2) and its scale-jitter
policies in podtpu_torch against podtpu (CPU).

* The resample (``scale_and_place`` with its mask and keypoint forms,
  ``scale_jitter``) against the JAX package's eager functions at scales
  0.1 to 2.0, with and without a translation, and with boundary samples on
  -0.5 and ``n - 0.5``: 1e-6.
* ``lsj`` and ``multiscale`` with masks and keypoints (the COCO flip
  permutation) on the draws of the JAX policy's key: images and masks to
  1e-6, boxes and keypoints to 1e-5, validity and visibility exactly.
* The weight bridge: the port's v2 keys are those of
  ``podtpu.models.weights.fasterrcnn_v2_key_map`` (box and mask), the JAX
  package's converter reads the port's state dict as
  ``flax_from_state_dict`` does, and ``load_pretrained`` reads torchvision
  checkpoints of either layout into either model as the JAX package does.
* The v2 modules (normed FPN, 2-deep RPN tower, ConvFC box head, normed
  mask tower) through the bridge: 1e-5 of their largest output; the eval
  forward of both v2 models at ``tests/conftest.py::tiny_config`` sizes
  (boxes 1e-3, scores 1e-4, masks 1e-4, valid slots and labels equal);
  ``infer`` and ``DetectionServer`` on a JAX-saved v2 model directory
  against JAX's ``infer``.

Frozen norms carry random statistics (a pretrained model's would not be
the identity), so that a norm applied in the wrong place shows.  One JAX
eval step compile per config serves the file.
"""
import copy
import dataclasses
import re
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from podtpu.core.config import COCO_17_HFLIP_INDS
from podtpu.core.config import fasterrcnn_v2_config as jax_v2_config
from podtpu.data import presets as jax_presets
from podtpu.infer import inference as jax_inference
from podtpu.models import fpn as jax_fpn
from podtpu.models import roi_heads as jax_rh
from podtpu.models import rpn as jax_rpn
from podtpu.models import weights as jax_weights
from podtpu.models.detector import build_model as jax_build_model
from podtpu.models.detector import make_detector as jax_make_detector
from podtpu.ops import image_ops as jax_T
from podtpu.train import checkpoints as jax_ckpt
from podtpu.train import step as jax_step
from podtpu_torch.core.config import (ModelConfig, config_from_dict,
                                      fasterrcnn_v2_config)
from podtpu_torch.data import presets
from podtpu_torch.infer import inference
from podtpu_torch.infer.server import DetectionServer
from podtpu_torch.models.detector import make_detector
from podtpu_torch.models.weights import (flax_from_state_dict, key_map,
                                         load_pretrained, state_dict_from_flax)
from podtpu_torch.ops import image_ops as T
from tests.conftest import tiny_config
from tests.synthetic import make_project
from tests.test_torch_augment import jax_augment_draws
from tests.test_torch_data import port_project
from tests.test_torch_mask import (port_init_variables,  # noqa: F401
                                   torch_threads)

LABELS = ["particle", "bubble", "bead"]


def t(a):
    return torch.from_numpy(np.array(a))


def jax_config(with_mask=False):
    cfg = tiny_config()
    return dataclasses.replace(cfg, model=jax_v2_config(dataclasses.replace(
        cfg.model, num_classes=4, with_mask=with_mask)))


def random_frozen(frozen, seed):
    """Each frozen BatchNorm's four vectors drawn near the identity, as a
    pretrained model's statistics."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name in ("weight", "var"):
            return rng.uniform(0.8, 1.25, x.shape).astype(np.float32)
        return rng.normal(0, 0.05, x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, frozen)


@pytest.fixture(scope="module")
def pairs():
    """Per model ("faster", "mask"): the JAX config, its variables (numpy,
    random frozen statistics) and the port's config."""
    out = {}
    for i, name in enumerate(("faster", "mask")):
        jcfg = jax_config(with_mask=name == "mask")
        v = port_init_variables(jcfg.model, i)
        v["frozen"] = random_frozen(v["frozen"], i)
        out[name] = (jcfg, v, config_from_dict(dataclasses.asdict(jcfg)))
    return out


def port_model(cfg, variables):
    model = make_detector(cfg.model)
    sd = state_dict_from_flax(variables["params"], variables["frozen"])
    model.load_state_dict({k: t(v) for k, v in sd.items()})
    return model.to(memory_format=torch.channels_last).eval()


# -- the resample -------------------------------------------------------------

def canvas_batch(seed, b=2, h=40, w=48, g=6, k=4):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    xy = rng.uniform(0, [w - 6, h - 6], (b, g, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 20, (b, g, 2))],
                           -1).astype(np.float32)
    masks = rng.uniform(0, 1, (b, g, h // 4, w // 4)).astype(np.float32)
    kps = np.concatenate([rng.uniform(0, [w, h], (b, g, k, 2)),
                          rng.choice([0.0, 2.0], (b, g, k, 1))],
                         -1).astype(np.float32)
    return img, boxes, masks, kps


def check_scale_and_place(scale, tx, ty, seed):
    img, boxes, masks, kps = canvas_batch(seed, b=len(scale))
    b, h, w = img.shape[:3]
    args = [t(np.float32(v)) for v in (scale, tx, ty)]
    gi, gb = T.scale_and_place(t(img), t(boxes), *args)
    gm = T.scale_and_place_masks(t(masks), *args, h, w)
    gk = T.scale_and_place_keypoints(t(kps), *args, h, w)
    for i in range(b):
        s, x0, y0 = (jnp.float32(v[i]) for v in (scale, tx, ty))
        wi, wb = jax_T.scale_and_place(jnp.asarray(img[i]),
                                       jnp.asarray(boxes[i]), s, x0, y0)
        wm = jax_T.scale_and_place_masks(jnp.asarray(masks[i]), s, x0, y0,
                                         h, w)
        wk = jax_T.scale_and_place_keypoints(jnp.asarray(kps[i]), s, x0, y0,
                                             h, w)
        for got, want in ((gi, wi), (gb, wb), (gm, wm), (gk, wk)):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6)
        np.testing.assert_array_equal(gk[i, ..., 2].numpy(),
                                      np.asarray(wk)[..., 2])
    return gi, gm, gk


class TestResample:
    @pytest.mark.parametrize("scale", [0.1, 0.37, 1.0, 1.25, 2.0])
    def test_scale_and_place(self, scale):
        # The first image in place, the second translated.
        gi, gm, gk = check_scale_and_place([scale, scale], [0.0, 5.25],
                                           [0.0, -3.5], seed=int(scale * 100))
        assert gi.abs().sum() > 0 and gm.abs().sum() > 0
        if scale != 1.0:
            assert not torch.equal(gi[0], t(canvas_batch(
                int(scale * 100))[0][0]))

    def test_boundary_samples(self):
        """Translations of half a pixel put the first output's sample on
        -0.5 and the last one's on ``n - 0.5``, the edges of the range that
        keeps a column."""
        gi, _, _ = check_scale_and_place([1.0, 1.0, 2.0], [0.5, -0.5, 0.5],
                                         [-0.5, 0.5, 0.5], seed=7)
        w = T._resample_weights(48, 48, t(np.float32([1.0, 1.0])),
                                t(np.float32([0.5, -0.5])))
        sample = (torch.arange(48.0) + 0.5) - t(np.float32([0.5, -0.5]))[
            :, None] - 0.5
        assert sample[0, 0] == -0.5 and sample[1, -1] == 47.5
        assert w[0, 0, 0] == 1.0 and w[1, -1, -1] == 1.0

    def test_scale_jitter(self):
        img, boxes, masks, kps = canvas_batch(11, b=3)
        h, w = img.shape[1:3]
        scale = np.float32([0.1, 1.0, 2.0])
        gi, gb, gm, gk = T.scale_jitter(t(img), t(boxes), t(scale),
                                        masks=t(masks), keypoints=t(kps))
        for i in range(3):
            # ``T.scale_jitter`` draws its scale from a key: the same
            # transform at a fixed scale.
            wi, wb = jax_T.scale_and_place(jnp.asarray(img[i]),
                                           jnp.asarray(boxes[i]),
                                           jnp.float32(scale[i]), 0.0, 0.0)
            wb = jnp.stack([jnp.clip(wb[:, 0], 0, w), jnp.clip(wb[:, 1], 0, h),
                            jnp.clip(wb[:, 2], 0, w),
                            jnp.clip(wb[:, 3], 0, h)], -1)
            wm = jax_T.scale_and_place_masks(jnp.asarray(masks[i]),
                                             jnp.float32(scale[i]), 0.0, 0.0,
                                             h, w)
            wk = jax_T.scale_and_place_keypoints(jnp.asarray(kps[i]),
                                                 jnp.float32(scale[i]), 0.0,
                                                 0.0, h, w)
            for got, want in ((gi, wi), (gb, wb), (gm, wm), (gk, wk)):
                np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                           rtol=0, atol=1e-6)
        assert float(gb[2].max()) == w and float(gb[0].max()) < 0.1 * w + 3
        # At 0.1 every point lands in the top-left tenth: all stay visible.
        assert torch.equal(gk[0, ..., 2], t(kps[0, ..., 2]))
        assert (gk[2, ..., 2] < t(kps[2, ..., 2])).any()


# -- the policies ---------------------------------------------------------------

@pytest.mark.parametrize("policy", ["lsj", "multiscale"])
@pytest.mark.parametrize("targets", ["boxes", "masks", "keypoints"])
def test_scale_jitter_policies(policy, targets):
    img, boxes, masks, kps = canvas_batch(20, b=8, h=32, w=32, k=17)
    valid = np.random.default_rng(21).uniform(size=boxes.shape[:2]) > 0.2
    rng = jax.random.PRNGKey(22)
    kw = {"kp_hflip_inds": COCO_17_HFLIP_INDS} if targets == "keypoints" \
        else {}
    m = masks if targets == "masks" else None
    k = kps if targets == "keypoints" else None
    want = jax_presets.augment_batch_policy(
        jax_presets.get_policy(policy), rng, jnp.asarray(img),
        jnp.asarray(boxes), jnp.asarray(valid),
        masks=None if m is None else jnp.asarray(m),
        keypoints=None if k is None else jnp.asarray(k), **kw)
    draws = jax_augment_draws(rng, 8, policy)
    lo, hi = presets.SCALE_RANGES[policy]
    assert bool(((draws.scale >= lo) & (draws.scale < hi)).all())
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
    flipped = draws.hflip < 0.5
    assert flipped.any() and not flipped.all()
    # Boxes that shrink under a pixel lose their validity.
    assert gv.sum() <= t(valid).sum()


def test_draws_and_policy_names():
    from podtpu_torch.core.config import Config, DataConfig
    from podtpu_torch.train.step import draw_train

    batch = {"image": torch.zeros(4, 8, 8, 3, dtype=torch.uint8),
             "boxes": torch.zeros(4, 5, 4)}
    gen = torch.Generator().manual_seed(0)
    for policy, (lo, hi) in presets.SCALE_RANGES.items():
        cfg = Config(data=DataConfig(aug_policy=policy))
        scale = draw_train(gen, cfg, batch).augment.scale
        assert scale.shape == (4,) and bool(((scale >= lo) & (scale < hi))
                                            .all())
        assert presets.get_policy(policy) is presets.scale_jitter_policy
    # Other policies draw no scale, and their draws are what they were.
    a = draw_train(torch.Generator().manual_seed(1), Config(), batch)
    assert a.augment.scale is None
    b = presets.draw_augment(torch.Generator().manual_seed(1), 4, (0.5, 1.0))
    assert torch.equal(a.augment.hflip, b.hflip)
    assert torch.equal(a.augment.photometric.hue, b.photometric.hue)


# -- the bridge -----------------------------------------------------------------

def relevant_v2_keys(with_mask):
    """The keys of the JAX package's v2 key map that name a tensor of the
    model: its bottleneck map lists a downsample for every block."""
    keys = {k for k in jax_weights.fasterrcnn_v2_key_map()
            if not re.search(r"layer\d\.[1-9]\d*\.downsample", k)}
    return keys if with_mask else {k for k in keys if "mask_" not in k}


@pytest.mark.parametrize("name", ["faster", "mask"])
def test_bridge_against_the_v2_key_map(pairs, name):
    jcfg, variables, cfg = pairs[name]
    model = make_detector(cfg.model)
    own = model.state_dict()
    assert set(own) == relevant_v2_keys(name == "mask")
    assert not any(k.endswith("num_batches_tracked") for k in own)
    sd = state_dict_from_flax(variables["params"], variables["frozen"])
    assert set(sd) == set(own)
    # The JAX package's converter reads the port's state dict as the
    # inverse bridge does.
    sd_t = {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
    back, (loaded, skipped) = jax_weights.convert_torchvision_state_dict(
        sd_t, variables, return_stats=True)
    assert not skipped and loaded == len(sd)
    params, frozen = flax_from_state_dict(sd_t)
    for got in (back, {"params": params, "frozen": frozen}):
        assert all(jax.tree.leaves(jax.tree.map(np.array_equal, got,
                                                variables)))
    kinds = {k: kind for k, _, _, kind in key_map(
        with_mask=name == "mask", rpn_conv_depth=2, box_head_type="convfc",
        fpn_norm=True, mask_head_norm=True)}
    assert kinds["roi_heads.box_head.5.weight"] == "fc6"


def start_variables(mcfg, seed):
    """Flax trees of a port model of ``mcfg`` initialised from ``seed``."""
    from podtpu_torch.models.detector import init_parameters

    model = make_detector(config_from_dict(
        {"model": dataclasses.asdict(mcfg)}).model)
    init_parameters(model, torch.Generator().manual_seed(seed))
    params, frozen = flax_from_state_dict(model.state_dict())
    return {"params": params, "frozen": frozen}


def port_from(variables, mcfg):
    model = make_detector(config_from_dict(
        {"model": dataclasses.asdict(mcfg)}).model)
    model.load_state_dict({k: t(v) for k, v in state_dict_from_flax(
        variables["params"], variables["frozen"]).items()})
    return model


def assert_same_trees(model, want):
    params, frozen = flax_from_state_dict(model.state_dict())
    assert all(jax.tree.leaves(jax.tree.map(
        np.array_equal, {"params": params, "frozen": frozen},
        jax.tree.map(np.asarray, dict(want)))))


def test_load_pretrained_reads_either_layout(pairs, tmp_path, capsys):
    """A torchvision v2 checkpoint is recognised by its 2-deep RPN tower
    and loads whole into a v2 model; into a v1 model, and a v1 checkpoint
    in newer torchvision's nested spelling into a v2 model, the tensors
    both layouts share load as the JAX package's key maps load them; the
    nested v1 checkpoint loads whole into a v1 model."""
    jcfg, variables, cfg = pairs["mask"]
    sd = {k: t(v) for k, v in state_dict_from_flax(
        variables["params"], variables["frozen"]).items()}
    v2_path = str(tmp_path / "maskrcnn_v2.pth")
    torch.save(sd, v2_path)
    model = load_pretrained(make_detector(cfg.model), v2_path)
    out = capsys.readouterr().out
    assert "torchvision v2 layout" in out
    assert f"{len(sd)} tensors loaded, 0 skipped" in out
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k

    # The v2 checkpoint into a v1 mask model.
    v1 = dataclasses.replace(jcfg.model, rpn_conv_depth=1,
                             box_head_type="mlp", fpn_norm=False,
                             mask_head_norm=False)
    start = start_variables(v1, 3)
    got = load_pretrained(port_from(start, v1), v2_path, verbose=False)
    assert_same_trees(got, jax_weights.load_pretrained(
        copy.deepcopy(start), v2_path, verbose=False))
    # A v1 checkpoint in the nested spelling into the v2 model.
    nested = {}
    for k, x in got.state_dict().items():
        k = re.sub(r"(_blocks\.\d)\.", r"\1.0.", k)
        k = k.replace("rpn.head.conv.", "rpn.head.conv.0.0.")
        nested[re.sub(r"mask_fcn(\d)", lambda m: f"{int(m[1]) - 1}.0",
                      k)] = x
    assert "backbone.fpn.inner_blocks.0.0.bias" in nested
    assert "rpn.head.conv.1.0.weight" not in nested
    v1_path = str(tmp_path / "maskrcnn_v1.pth")
    torch.save(nested, v1_path)
    start = start_variables(jcfg.model, 4)
    got = load_pretrained(port_from(start, jcfg.model), v1_path)
    assert "torchvision v1 layout" in capsys.readouterr().out
    assert_same_trees(got, jax_weights.load_pretrained(
        copy.deepcopy(start), v1_path, verbose=False))
    # ... and into a v1 model, which reads all of it.
    start = start_variables(v1, 5)
    got = load_pretrained(port_from(start, v1), v1_path)
    assert f"{len(nested)} tensors loaded, 0 skipped" in \
        capsys.readouterr().out
    assert_same_trees(got, jax_weights.load_pretrained(
        copy.deepcopy(start), v1_path, verbose=False))


def test_v2_needs_resnet50_fpn():
    """The JAX package's ``ValueError``, word for word; the v2 recipe
    builds with and without a mask head, and with a keypoint head."""
    with pytest.raises(ValueError) as want:
        jax_build_model(3, family="faster_rcnn_v2", backbone="mobilenet_v2")
    with pytest.raises(ValueError) as got:
        make_detector(fasterrcnn_v2_config(ModelConfig(
            backbone="mobilenet_v2")))
    assert str(got.value) == str(want.value)
    for kw in ({}, {"with_mask": True}, {"with_keypoints": True}):
        model = make_detector(fasterrcnn_v2_config(ModelConfig(
            image_size=(64, 64), **kw)))
        assert "rpn.head.conv.1.0.weight" in model.state_dict()


# -- the v2 modules through the bridge ------------------------------------------

def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_modules_through_the_bridge(pairs):
    jcfg, v, cfg = pairs["mask"]
    model = port_model(cfg, v)
    rng = np.random.default_rng(30)
    sub = lambda name: {"params": v["params"][name],  # noqa: E731
                        "frozen": v["frozen"].get(name, {})}
    # FPN with norms.
    feats = [rng.normal(size=(1, 32 // 2 ** i, 32 // 2 ** i, c)).astype(
        np.float32) for i, c in enumerate((256, 512, 1024, 2048))]
    want = jax_fpn.FPN(dtype=jnp.float32, norm=True).apply(
        sub("fpn"), [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = model.backbone.fpn([t(f).permute(0, 3, 1, 2) for f in feats])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        close(g.permute(0, 2, 3, 1).numpy(), w)
    # The 2-deep RPN tower.
    levels = [rng.normal(size=(2, s, s, 256)).astype(np.float32)
              for s in (16, 8)]
    want = jax_rpn.RPNHead(num_anchors=3, conv_depth=2,
                           dtype=jnp.float32).apply(
        sub("rpn_head"), [jnp.asarray(x) for x in levels])
    with torch.no_grad():
        got = model.rpn.head([t(x).permute(0, 3, 1, 2) for x in levels])
    for g_lvls, w_lvls in zip(got, want):
        for g, w in zip(g_lvls, w_lvls):
            close(g.numpy(), w)
    # The ConvFC box head and the normed mask tower.
    pooled = rng.normal(size=(6, 7, 7, 256)).astype(np.float32)
    want = jax_rh.ConvFCBoxHead(num_classes=4, dtype=jnp.float32).apply(
        sub("box_head"), jnp.asarray(pooled))
    with torch.no_grad():
        got = model.roi_heads(t(pooled).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        close(g.numpy(), w)
    pooled = rng.normal(size=(6, 14, 14, 256)).astype(np.float32)
    want = jax_rh.MaskHead(num_classes=4, norm=True,
                           dtype=jnp.float32).apply(
        sub("mask_head"), jnp.asarray(pooled))
    with torch.no_grad():
        got = model.roi_heads.mask_logits(t(pooled).permute(0, 3, 1, 2))
    close(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2))


# -- the eval forward -------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_eval_steps():
    """One jitted JAX eval step per model config, shared by the file."""
    steps = {}

    def make_eval_step(model):
        if model.cfg not in steps:
            steps[model.cfg] = jax_step.make_eval_step(model)
        return steps[model.cfg]

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_inference, "make_eval_step", make_eval_step)
    yield make_eval_step
    mp.undo()


@pytest.mark.parametrize("name", ["faster", "mask"])
def test_eval_forward(pairs, jax_eval_steps, name):
    jcfg, variables, cfg = pairs[name]
    images = np.random.default_rng(40).integers(0, 256, (2, 128, 128, 3),
                                                dtype=np.uint8)
    want = jax_eval_steps(jax_make_detector(jcfg.model))(
        variables["params"], variables["frozen"], jnp.asarray(images))
    with torch.inference_mode():
        got = port_model(cfg, variables)(t(images))
    if name == "mask":
        (want, want_masks), (got, masks) = want, got
    v = np.asarray(want.valid)
    assert v.sum() > 4
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy()[v],
                               np.asarray(want.boxes)[v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy()[v],
                               np.asarray(want.scores)[v], rtol=0, atol=1e-4)
    if name == "mask":
        assert masks.shape == (2, 16, 28, 28)
        np.testing.assert_allclose(masks.numpy()[v],
                                   np.asarray(want_masks)[v], rtol=0,
                                   atol=1e-4)


# -- the entry points on a JAX-saved v2 model directory ---------------------------

@pytest.fixture(scope="module")
def model_dir(pairs, tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_v2")
    jcfg, v, _ = pairs["faster"]
    assert jcfg.model.num_classes == len(LABELS) + 1
    path = str(root / "model")
    jax_ckpt.save_model(path, v["params"], v["frozen"], jcfg.model, LABELS)
    jax_ckpt.save_labels(path, LABELS)
    project = make_project(str(root / "images"), num_images=4,
                           labels=LABELS[:2], seed=3)
    for im in project.image_dict.values():
        im.boxes = []
    yield dict(path=path, project=project)
    shutil.rmtree(root, ignore_errors=True)


def test_infer_and_server(model_dir, jax_eval_steps):
    jp = model_dir["project"]
    want = jax_inference.infer(copy.deepcopy(jp), model_dir["path"],
                               threshold=0.0, batch_size=2, num_workers=2)
    got = inference.infer(port_project(jp), model_dir["path"], threshold=0.0,
                          batch_size=2, num_workers=2, device="cpu")
    assert set(got.image_dict) == set(want.image_dict)
    kept = 0
    for k, im in want.image_dict.items():
        gb = got.image_dict[k].boxes
        assert [b.label for b in gb] == [b.label for b in im.boxes], k
        for g, w in zip(gb, im.boxes):
            np.testing.assert_allclose(g.bounds, w.bounds, rtol=0, atol=1e-3)
            np.testing.assert_allclose(g.score, w.score, rtol=0, atol=1e-4)
        kept += len(gb)
    assert kept > 0
    from podtpu_torch.data import imageio

    server = DetectionServer(model_dir["path"], batch_size=2, device="cpu")
    try:
        for k, im in list(want.image_dict.items())[:2]:
            out = server.detect_array(imageio.read_rgb(im.full_path), 0.0)
            dets = out["detections"]
            assert len(dets) == len(im.boxes) > 0
            for d, w in zip(dets, im.boxes):
                assert d["label"] == w.label
                np.testing.assert_allclose(d["score"], w.score, rtol=0,
                                           atol=1e-4)
    finally:
        server.close()
