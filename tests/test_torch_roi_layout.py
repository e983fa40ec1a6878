"""The channels-first layout of podtpu_torch's RoIAlign (CPU, float32).

``channels_first=True`` gives ``[B, K, C, out, out]``, the order
torchvision's box head flattens, so ``BoxHead`` needs no permuting copy.
The same numpy inputs go through the JAX package and the port: the forward
agrees to 2e-4 and the backward with the Pallas kernel in interpret mode to
1e-3 (the tolerances of tests/test_torch_ops.py and
tests/test_torch_train_ops.py); the box head's outputs equal those of the
old permute-and-reshape bit for bit.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from podtpu.ops.pallas.roi_align_kernel import batched_roi_align_pallas
from podtpu_torch.core.config import ModelConfig
from podtpu_torch.models import roi_heads as rh
from podtpu_torch.ops import _build, roi_align
from tests.test_torch_ops import (EDGE_ROIS, STRIDES, canonical_rois,
                                  feature_levels, jax_reference)
from tests.test_torch_train_ops import pallas_grad, xla_grad
from tests.test_torch_mask import torch_threads  # noqa: F401


def t(a):
    return torch.from_numpy(np.array(a))


def rois_for(seed, batch, n=10):
    rng = np.random.default_rng(seed)
    return np.stack([np.concatenate([canonical_rois(rng, n), EDGE_ROIS])
                     for _ in range(batch)])


class TestForwardLayout:
    @pytest.mark.parametrize("batch", [1, 2])
    def test_channels_first_is_the_permuted_default(self, batch):
        feats = feature_levels(40 + batch, batch)
        rois = rois_for(40 + batch, batch)
        tf = [t(f) for f in feats]
        default = roi_align.batched_roi_align_plain(tf, t(rois), STRIDES)
        first = roi_align.batched_roi_align_plain(tf, t(rois), STRIDES,
                                                  channels_first=True)
        assert first.shape == (batch, rois.shape[1], 8, 7, 7)
        assert first.is_contiguous()
        assert torch.equal(first, default.permute(0, 1, 4, 2, 3))
        want = jax_reference(feats, rois)
        np.testing.assert_allclose(first.permute(0, 1, 3, 4, 2).numpy(),
                                   want, atol=2e-4)

    def test_wrapper_passes_the_layout_on(self):
        feats = feature_levels(43, 2)
        rois = rois_for(43, 2)
        got = roi_align.batched_roi_align([t(f) for f in feats], t(rois),
                                          STRIDES, channels_first=True)
        pallas = np.asarray(batched_roi_align_pallas(
            tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois),
            STRIDES))
        np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(),
                                   pallas, atol=2e-4)

    def test_output_size_14(self):
        feats = feature_levels(44, 1)
        rois = rois_for(44, 1, n=4)
        tf = [t(f) for f in feats]
        default = roi_align.batched_roi_align_plain(tf, t(rois), STRIDES,
                                                    output_size=14)
        first = roi_align.batched_roi_align_plain(
            tf, t(rois), STRIDES, output_size=14, channels_first=True)
        assert first.shape == (1, rois.shape[1], 8, 14, 14)
        assert torch.equal(first, default.permute(0, 1, 4, 2, 3))


class TestBackwardLayout:
    @pytest.mark.parametrize("batch", [1, 2])
    def test_channels_first_gradient_matches_pallas(self, batch):
        rng = np.random.default_rng(50 + batch)
        feats = feature_levels(50 + batch, batch)
        rois = rois_for(50 + batch, batch)
        g = rng.normal(size=(batch, rois.shape[1], 7, 7, 8)).astype(
            np.float32)
        g_first = np.ascontiguousarray(g.transpose(0, 1, 4, 2, 3))
        tf = [t(f) for f in feats]
        got = roi_align.batched_roi_align_backward_plain(
            t(g_first), tf, t(rois), STRIDES, channels_first=True)
        default = roi_align.batched_roi_align_backward_plain(
            t(g), tf, t(rois), STRIDES)
        for x, d, p, w in zip(got, default, pallas_grad(feats, rois, g),
                              xla_grad(feats, rois, g)):
            assert torch.equal(x, d)
            np.testing.assert_allclose(x.numpy(), p, atol=1e-3)
            np.testing.assert_allclose(x.numpy(), w, atol=1e-3)

    def test_wrapper_checks_the_gradient_shape_on_the_cpu_path(self):
        rng = np.random.default_rng(53)
        feats = feature_levels(53, 1)
        rois = rois_for(53, 1, n=3)
        g = rng.normal(size=(1, rois.shape[1], 8, 7, 7)).astype(np.float32)
        tf = [t(f) for f in feats]
        got = roi_align.batched_roi_align_backward(
            t(g), tf, t(rois), STRIDES, channels_first=True)
        want = roi_align.batched_roi_align_backward_plain(
            t(np.ascontiguousarray(g.transpose(0, 1, 3, 4, 2))), tf, t(rois),
            STRIDES)
        for x, w in zip(got, want):
            assert torch.equal(x, w)

    def test_autograd_function_carries_the_layout(self, monkeypatch):
        """The registered operator's gradient, channels first: the forward
        and ``podtpu::roi_align_bwd`` run in that layout, the upstream
        gradient arrives in the output's layout and the level gradients
        equal XLA's."""
        rng = np.random.default_rng(54)
        feats = feature_levels(54, 2)
        rois = rois_for(54, 2, n=5)
        g = rng.normal(size=(2, rois.shape[1], 7, 7, 8)).astype(np.float32)
        seen = {}
        fwd = roi_align.batched_roi_align_plain
        bwd = roi_align.batched_roi_align_backward_plain

        def fwd_seen(*args, channels_first=False, **kwargs):
            seen["fwd"] = channels_first
            return fwd(*args, channels_first=channels_first, **kwargs)

        def bwd_seen(grad_out, *args):
            seen["bwd"] = (args[-1], tuple(grad_out.shape))
            return bwd(grad_out, *args)

        monkeypatch.setattr(roi_align, "batched_roi_align_plain", fwd_seen)
        monkeypatch.setattr(roi_align, "batched_roi_align_backward_plain",
                            bwd_seen)
        _build.reset_launches()
        tf = [t(f).requires_grad_() for f in feats]
        out = roi_align.batched_roi_align(tf, t(rois), STRIDES, 7, 2,
                                          channels_first=True)
        assert out.shape == (2, rois.shape[1], 8, 7, 7)
        out.backward(t(np.ascontiguousarray(g.transpose(0, 1, 4, 2, 3))))
        assert seen == {"fwd": True,
                        "bwd": (True, (2, rois.shape[1], 8, 7, 7))}
        for x, w in zip(tf, xla_grad(feats, rois, g)):
            np.testing.assert_allclose(x.grad.numpy(), w, atol=1e-3)
        assert not _build.launches


class TestBoxHeadLayout:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_equals_permute_and_reshape_bit_for_bit(self, dtype):
        torch.manual_seed(60)
        head = rh.BoxHead(8, 7, 4, hidden=32, compute_dtype=dtype)
        pooled = torch.randn(11, 7, 7, 8).to(dtype)      # [N, P, P, C]
        first = pooled.permute(0, 3, 1, 2).contiguous()  # [N, C, P, P]
        with torch.no_grad():
            logits, deltas = head(first)
            x = pooled.permute(0, 3, 1, 2).reshape(11, -1)
            want_logits, want_deltas = head.box_predictor(head.box_head(x))
        assert torch.equal(logits, want_logits.float())
        assert torch.equal(deltas, want_deltas.float())

    def test_flatten_is_a_view(self):
        first = torch.randn(5, 8, 7, 7)
        assert first.flatten(1).data_ptr() == first.data_ptr()

    def test_pool_rois_batched_is_channels_first(self):
        cfg = ModelConfig(image_size=(128, 128), fpn_channels=8)
        feats = feature_levels(61, 2)
        rois = rois_for(61, 2, n=4)
        pyramid = [t(f).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last) for f in feats]
        pooled = rh.pool_rois_batched(pyramid, t(rois), cfg)
        assert pooled.shape == (2, rois.shape[1], 8, 7, 7)
        assert pooled.is_contiguous()
        want = roi_align.batched_roi_align_plain(
            [t(f) for f in feats], t(rois), cfg.roi_strides,
            canonical_scale=cfg.roi_canonical_scale,
            canonical_level=cfg.roi_canonical_level)
        assert torch.equal(pooled, want.permute(0, 1, 4, 2, 3))


class TestKernelLimits:
    """What the CUDA kernels refuse is checked before any launch, with a
    message that names the argument."""

    def inputs(self, c=8):
        feats = [t(f) for f in feature_levels(70, 1, c=c)]
        return feats, t(rois_for(70, 1, n=2))

    def test_accepts_the_model_shapes(self):
        feats, rois = self.inputs()
        roi_align._check_inputs(feats, rois, STRIDES, 7, 2)
        roi_align._check_inputs(feats, rois, STRIDES, 14, 2)

    @pytest.mark.parametrize("case, match", [
        ("channels", "features: the channel count must be a multiple of 8"),
        ("output_size", "output_size must be one of"),
        ("sampling_ratio", "sampling_ratio must be positive"),
        ("alignment", r"features\[1\] must be 16-byte aligned"),
        ("contiguous", r"features\[0\] must be contiguous"),
        ("boxes", "boxes must be a"),
        ("strides", "features/strides"),
        ("dtype", "features must be float32 or bfloat16"),
    ])
    def test_names_the_offending_argument(self, case, match):
        feats, rois = self.inputs(c=4 if case == "channels" else 8)
        strides, out, ratio = STRIDES, 7, 2
        if case == "output_size":
            out = 5
        elif case == "sampling_ratio":
            ratio = 10
        elif case == "alignment":
            flat = torch.zeros(feats[1].numel() + 1)
            feats[1] = flat[1:].view(feats[1].shape)
        elif case == "contiguous":
            feats[0] = feats[0].transpose(1, 2)
        elif case == "boxes":
            rois = rois.double()
        elif case == "strides":
            strides = STRIDES[:3]
        elif case == "dtype":
            feats = [f.half() for f in feats]
        with pytest.raises((ValueError, TypeError), match=match):
            roi_align._check_inputs(feats, rois, strides, out, ratio)

    def test_pooled_shape(self):
        assert roi_align.pooled_shape(2, 3, 8, 7, False) == (2, 3, 7, 7, 8)
        assert roi_align.pooled_shape(2, 3, 8, 7, True) == (2, 3, 8, 7, 7)
