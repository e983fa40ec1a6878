"""podtpu_torch augmentation and optimisers against the JAX package (CPU).

Augmentation is fed the draws JAX makes from its keys (the split tree of
``presets.py`` and ``image_ops.py``): flips agree exactly, the HSV round
trip and ``photometric_distort`` to 1e-5 (float32 sums in another order in
the contrast's grey mean).  Each optimiser takes three updates from the
same gradients as its optax chain; parameters agree to rtol 1e-5 and
atol 1e-6 (torch's Adam groups the bias corrections differently: about
1e-5 of an update of size lr).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from torch import nn

from podtpu.core.config import Config as JaxConfig
from podtpu.core.config import DataConfig as JaxDataConfig
from podtpu.core.config import ModelConfig as JaxModelConfig
from podtpu.core.config import TrainConfig as JaxTrainConfig
from podtpu.data import presets as jax_presets
from podtpu.ops import image_ops as jax_T
from podtpu.train import optim as jax_optim
from podtpu.train import step as jax_step
from podtpu_torch.core import config as port_config
from podtpu_torch.data import presets
from podtpu_torch.ops import image_ops as T
from podtpu_torch.train import optim, step


def t(a):
    return torch.from_numpy(np.array(a))


def jax_photometric_draws(keys_rng):
    """The values ``image_ops.photometric_distort`` draws from its key:
    ``split(k, 12)``, keys 1-11 (``image_ops.py:89-126``)."""
    keys = jax.random.split(keys_rng, 12)

    def u(k, lo=0.0, hi=1.0):
        return float(jax.random.uniform(k, (), minval=lo, maxval=hi))

    return dict(brightness=u(keys[1], *T.BRIGHTNESS),
                contrast=u(keys[2], *T.CONTRAST),
                saturation=u(keys[3], *T.SATURATION),
                hue=u(keys[4], *T.HUE),
                apply_brightness=u(keys[5]), contrast_first=u(keys[6]),
                apply_contrast=u(keys[7]), apply_saturation=u(keys[8]),
                apply_hue=u(keys[9]),
                permutation=np.asarray(jax.random.permutation(keys[10], 3)),
                apply_permutation=u(keys[11]))


def stack_photometric(per_image):
    return T.PhotometricDraws(**{
        k: t(np.stack([d[k] for d in per_image]).astype(
            np.int64 if k == "permutation" else np.float32))
        for k in T.PhotometricDraws._fields})


def jax_augment_draws(rng_aug, b, policy="miso"):
    """A policy's draws for a batch (``presets.py:213`` splits per image;
    miso splits into flips and distortion at ``:82``, lsj and multiscale
    into the scale jitter's uniform and flips at ``:100`` and ``:110``;
    ``_flips`` into h and v at ``:55``)."""
    hf, vf, photo, scale = [], [], [], []
    jitter = presets.SCALE_RANGES.get(policy)
    for r in jax.random.split(rng_aug, b):
        k1, k2 = jax.random.split(r) if policy == "miso" else (r, r)
        if jitter:
            ks, k1 = jax.random.split(r)
            scale.append(float(jax.random.uniform(
                ks, (), minval=jitter[0], maxval=jitter[1])))
        kh, kv = jax.random.split(k1)
        hf.append(float(jax.random.uniform(kh)))
        vf.append(float(jax.random.uniform(kv)))
        photo.append(jax_photometric_draws(k2))
    return presets.AugmentDraws(hflip=t(np.float32(hf)),
                                vflip=t(np.float32(vf)),
                                photometric=stack_photometric(photo),
                                scale=t(np.float32(scale)) if jitter
                                else None)


def images_and_boxes(seed, b=4, size=32):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    img[0, :4, :4] = 0.5          # grey pixels: hue undefined, s = 0
    img[1, :2] = 1.0              # saturated white
    xy = rng.uniform(0, size - 8, (b, 5, 2))
    wh = rng.uniform(2, 8, (b, 5, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.uniform(size=(b, 5)) > 0.2
    return img, boxes, valid


# -- image ops ------------------------------------------------------------------

class TestImageOps:
    def test_flips(self):
        img, boxes, _ = images_and_boxes(0)
        for port_fn, jax_fn, extent in ((T.hflip, jax_T.hflip, 32.0),
                                        (T.vflip, jax_T.vflip, 30.0)):
            gi, gb = port_fn(t(img), t(boxes), extent)
            for i in range(img.shape[0]):
                wi, wb = jax_fn(jnp.asarray(img[i]), jnp.asarray(boxes[i]),
                                extent)
                np.testing.assert_array_equal(gi[i].numpy(), np.asarray(wi))
                np.testing.assert_array_equal(gb[i].numpy(), np.asarray(wb))

    def test_hsv_round_trip(self):
        img, _, _ = images_and_boxes(1)
        hsv = T.rgb_to_hsv(t(img))
        np.testing.assert_allclose(
            hsv.numpy(), np.asarray(jax_T.rgb_to_hsv(jnp.asarray(img))),
            atol=1e-6)
        back = T.hsv_to_rgb(hsv)
        np.testing.assert_allclose(
            back.numpy(), np.asarray(jax_T.hsv_to_rgb(jnp.asarray(
                hsv.numpy()))), atol=1e-6)
        np.testing.assert_allclose(back.numpy(), img, atol=1e-5)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_photometric_distort(self, seed):
        img, _, _ = images_and_boxes(seed, b=6)
        keys = jax.random.split(jax.random.PRNGKey(seed), 6)
        draws = stack_photometric([jax_photometric_draws(k) for k in keys])
        got = T.photometric_distort(t(img), draws).numpy()
        for i in range(img.shape[0]):
            want = np.asarray(jax_T.photometric_distort(keys[i],
                                                        jnp.asarray(img[i])))
            np.testing.assert_allclose(got[i], want, atol=1e-5)

    def test_draws_from_generator(self):
        d = T.draw_photometric(torch.Generator().manual_seed(0), 64)
        assert ((d.brightness >= 0.875) & (d.brightness <= 1.125)).all()
        assert ((d.hue >= -0.05) & (d.hue <= 0.05)).all()
        assert (d.permutation.sort(-1).values == torch.arange(3)).all()


class TestPolicies:
    @pytest.mark.parametrize("policy,kw", [("miso", dict(distort=True)),
                                           ("miso", dict(distort=False)),
                                           ("hflip", {}), ("none", {})])
    def test_policy_batch(self, policy, kw):
        img, boxes, valid = images_and_boxes(3, b=8)
        rng = jax.random.PRNGKey(3)
        wi, wb, wv, _, _ = jax_presets.augment_batch_policy(
            jax_presets.get_policy(policy), rng, jnp.asarray(img),
            jnp.asarray(boxes), jnp.asarray(valid), **kw)
        draws = jax_augment_draws(rng, 8, policy)
        gi, gb, gv, gm, gk = presets.augment_batch_policy(
            presets.get_policy(policy), t(img), t(boxes), t(valid), draws,
            **kw)
        np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-5)
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        assert gm is None and gk is None
        if policy != "none":  # some images flipped, some not
            flipped = draws.hflip < 0.5
            if policy == "miso":
                flipped |= draws.vflip < 0.5
            assert flipped.any() and not flipped.all()

    def test_get_policy_and_kwargs(self):
        # Every JAX policy is ported (SSD's are held in test_torch_ssd.py).
        assert set(presets.POLICIES) == set(jax_presets.POLICIES)
        assert presets.get_policy("ssd") is presets.ssd_policy
        assert presets.get_policy("ssdlite") is presets.ssdlite_policy
        with pytest.raises(ValueError):
            presets.get_policy("nope")
        assert presets.get_policy("none") is presets.none_policy
        # Copy-paste is ported: its draws are part of a step's.
        copy_paste = port_config.Config(
            data=port_config.DataConfig(copy_paste=True))
        batch = {"image": torch.zeros(2, 8, 8, 3, dtype=torch.uint8),
                 "boxes": torch.zeros(2, 5, 4)}
        draws = step.draw_train(torch.Generator().manual_seed(0), copy_paste,
                                batch)
        assert draws.copy_paste.shape == (2, 5)
        assert step.draw_train(torch.Generator().manual_seed(0),
                               port_config.Config(), batch).copy_paste is None
        for aug, distort in (("miso", False), ("hflip", True)):
            jcfg = JaxConfig(data=JaxDataConfig(aug_policy=aug,
                                                photometric_distort=distort))
            cfg = port_config.config_from_dict(dataclasses.asdict(jcfg))
            assert presets.policy_kwargs(cfg) == \
                jax_presets.policy_kwargs(jcfg)


# -- config, warmup -------------------------------------------------------------

class TestConfigAndWarmup:
    def test_config_round_trip(self):
        jcfg = JaxConfig(train=JaxTrainConfig(lr=0.01, lr_steps=(3, 5),
                                              clip_grad_norm=10.0),
                         data=JaxDataConfig(aug_policy="hflip"))
        cfg = port_config.config_from_dict(dataclasses.asdict(jcfg))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        for port_cls, jax_cls in ((port_config.TrainConfig, JaxTrainConfig),
                                  (port_config.DataConfig, JaxDataConfig),
                                  (port_config.CvatConfig,
                                   type(JaxConfig().cvat))):
            assert dataclasses.asdict(port_cls()) == \
                dataclasses.asdict(jax_cls())

    @pytest.mark.parametrize("epoch,iters", [(0, 5), (0, 2000), (1, 50)])
    def test_warmup_factor(self, epoch, iters):
        jcfg = JaxConfig(train=JaxTrainConfig(warmup_iters=100))
        cfg = port_config.config_from_dict(dataclasses.asdict(jcfg))
        for it in (0, 1, 3, 50, 99, 100, 1500):
            assert step.warmup_factor(cfg, epoch, it, iters) == \
                jax_step.warmup_factor(jcfg, epoch, it, iters)


# -- optimisers -------------------------------------------------------------------

# Port parameter name -> path in a flax-style tree.  Stem and layer1 are the
# frozen components at trainable_backbone_stages=3; box_head.gn1 stands for
# a GroupNorm (the norm_weight_decay group).
PARAMS = {
    "backbone.body.conv1.weight": ("backbone", "conv1", "kernel"),
    "backbone.body.layer1.0.conv1.weight": ("backbone", "layer1_0", "conv1",
                                            "kernel"),
    "backbone.body.layer2.0.conv1.weight": ("backbone", "layer2_0", "conv1",
                                            "kernel"),
    "backbone.fpn.inner_blocks.0.weight": ("fpn", "lateral2", "kernel"),
    "backbone.fpn.inner_blocks.0.bias": ("fpn", "lateral2", "bias"),
    "roi_heads.box_head.gn1.weight": ("box_head", "gn1", "scale"),
    "roi_heads.box_head.gn1.bias": ("box_head", "gn1", "bias"),
}
FROZEN = {"backbone.body.conv1.weight", "backbone.body.layer1.0.conv1.weight"}


class ToyModel(nn.Module):
    """Parameters under the detector's names, frozen as the detector
    freezes them."""

    def __init__(self, values, model_cfg):
        super().__init__()
        self.cfg = model_cfg
        self.names = sorted(values)
        self.params = nn.ParameterList(
            nn.Parameter(t(values[n]), requires_grad=n not in FROZEN)
            for n in self.names)

    def named_parameters(self, *args, **kwargs):
        return list(zip(self.names, self.params))


def nest(flat):
    tree = {}
    for name, path in PARAMS.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[name]
    return tree


def leaf(tree, name):
    for k in PARAMS[name]:
        tree = tree[k]
    return np.asarray(tree)


OPTIMISERS = {
    "sgd": dict(),
    "sgd_clip": dict(clip_grad_norm=0.5),
    "sgd_fused": dict(fused_sgd=True),
    "sgd_bf16_momentum": dict(momentum_dtype="bfloat16"),
    "sgd_norm_wd": dict(norm_weight_decay=0.0),
    "adam": dict(optimiser="adam"),
    "adam_clip": dict(optimiser="adam", clip_grad_norm=0.5),
    "adamw": dict(optimiser="adamw", weight_decay=0.05),
    "adamw_norm_wd": dict(optimiser="adamw", weight_decay=0.05,
                          norm_weight_decay=0.01),
}


class TestOptimisers:
    @pytest.mark.parametrize("name", sorted(OPTIMISERS))
    def test_three_updates_match_optax(self, name):
        rng = np.random.default_rng(len(name))
        values = {n: rng.normal(0, 0.1, (4, 3)).astype(np.float32)
                  for n in PARAMS}
        # Frozen components get zero gradient in JAX (stop_gradient) and
        # none in the port.
        grads = [{n: rng.normal(0, 1, (4, 3)).astype(np.float32)
                  * (n not in FROZEN) for n in PARAMS} for _ in range(3)]
        lrs = [0.01, 0.005, 0.02]
        jtrain = JaxTrainConfig(**OPTIMISERS[name])
        jmodel_cfg = JaxModelConfig()
        tx = jax_optim.make_optimizer(jtrain, jmodel_cfg)
        jparams = nest({n: jnp.asarray(v) for n, v in values.items()})
        state = tx.init(jparams)
        model = ToyModel(values, port_config.model_config_from_dict(
            dataclasses.asdict(jmodel_cfg)))
        train_cfg = port_config.TrainConfig(**OPTIMISERS[name])
        opt = optim.make_optimizer(train_cfg, model)
        for g, lr in zip(grads, lrs):
            jparams, state = jax_optim.apply_optimizer(
                tx, nest({n: jnp.asarray(v) for n, v in g.items()}), state,
                jparams, jnp.float32(lr))
            for n, p in model.named_parameters():
                p.grad = None if n in FROZEN else t(g[n])
            optim.apply_optimizer(opt, lr, train_cfg.clip_grad_norm)
        for n, p in model.named_parameters():
            want = leaf(jparams, n)
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-5,
                                       atol=1e-6, err_msg=n)
            if n in FROZEN:
                np.testing.assert_array_equal(p.detach().numpy(), values[n])
        if "norm_wd" in name:
            assert len(opt.param_groups) == 2
        if "bf16" in name:
            bufs = [s["momentum_buffer"] for s in opt.state.values()]
            assert bufs and all(b.dtype == torch.bfloat16 for b in bufs)

    def test_trainable_mask_and_refusals(self):
        mask = optim.trainable_mask_fn(
            port_config.ModelConfig(trainable_backbone_stages=2))
        assert not mask("backbone.body.conv1.weight")
        assert not mask("backbone.body.layer2.3.conv2.weight")
        assert mask("backbone.body.layer3.0.conv1.weight")
        assert mask("backbone.fpn.inner_blocks.0.weight")
        assert optim.norm_param_mask("roi_heads.box_head.gn1.weight")
        assert not optim.norm_param_mask("backbone.fpn.layer_blocks.0.bias")
        model = ToyModel({n: np.zeros((1,), np.float32) for n in PARAMS},
                         port_config.ModelConfig())
        for kw in (dict(fused_sgd=True, norm_weight_decay=0.0),
                   dict(optimiser="adam", norm_weight_decay=0.0),
                   dict(optimiser="lamb")):
            with pytest.raises(ValueError):
                optim.make_optimizer(port_config.TrainConfig(**kw), model)

    def test_clip_by_global_norm(self):
        ps = [nn.Parameter(torch.zeros(3)), nn.Parameter(torch.zeros(2))]
        ps[0].grad = torch.tensor([3.0, 0.0, 0.0])
        ps[1].grad = torch.tensor([0.0, 4.0])
        norm = optim.clip_by_global_norm_(ps, 1.0)
        want = optax.clip_by_global_norm(1.0).update(
            [jnp.asarray([3.0, 0, 0]), jnp.asarray([0, 4.0])], None)[0]
        assert float(norm) == 5.0
        for p, w in zip(ps, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                       rtol=1e-6)
        optim.clip_by_global_norm_(ps, 10.0)   # under the cap: unchanged
        np.testing.assert_allclose(ps[1].grad.numpy(), [0.0, 0.8], rtol=1e-6)
