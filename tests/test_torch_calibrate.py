"""The port's FrozenBN calibration against ``podtpu.train.calibrate`` (CPU).

One set of weights (flax ``init_variables`` from ``PRNGKey(0)`` at
``tests/conftest.py::tiny_config`` sizes, bridged to the port) and two
seeded uint8 images go through ``needs_calibration`` and the default
12-pass ``calibrate_frozen_stats`` of both packages.  From the second pass
on, deep activations reach about 1e18 and the float32 variance of some
layers overflows: both packages must then skip the same layers (the
non-finite rule).

Each pass is held teacher-forced: the port starts it from the JAX state
before that pass, skips the layers JAX skipped in it and ends it with every
running mean and variance within 1e-3 of its tensor's largest absolute
value of the JAX state after it (both clamped as the last pass clamps).
The straight 12 passes are chaotic in float32: the port against itself at
1 and 8 CPU threads ends 4.3e-4 apart, against JAX 1.0e-3, and on
micrograph-like images 2.8e-3.  So the straight run is held to the same
skipped layers in every pass and its statistics to 5e-3.  The guard case
runs the port with the variance taken by ``torch.var``, which stays finite
where the reference's overflows, and must fail the forced hold at the first
pass in which JAX skips a layer.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from podtpu.models.detector import init_variables
from podtpu.models.detector import make_detector as jax_make_detector
from podtpu.train import calibrate as jax_calibrate
from podtpu_torch.core.config import model_config_from_dict
from podtpu_torch.models.detector import make_detector
from podtpu_torch.models.resnet import FrozenBatchNorm2d
from podtpu_torch.models.weights import key_map, state_dict_from_flax
from podtpu_torch.train import calibrate
from tests.conftest import tiny_config
from tests.test_torch_mask import torch_threads  # noqa: F401

TOL = 1e-3           # of each tensor's largest absolute value, per pass
STRAIGHT_TOL = 5e-3  # the same, after 12 straight (chaotic) passes
STATS = ("running_mean", "running_var")


def bn_names():
    """flax path tuple of each FrozenBN -> the port's module name."""
    return {tuple(flax.split("/")[:-1]): port.rsplit(".", 1)[0]
            for port, tree, flax, _ in key_map()
            if tree == "frozen" and flax.endswith("/mean")}


def nonfinite(stats):
    return sorted(k for k, (m, v) in stats.items()
                  if not (np.isfinite(m).all() and np.isfinite(v).all()))


def running_stats(variables):
    """The FrozenBN running statistics of flax variables, as fresh arrays
    under the port's state-dict keys."""
    sd = state_dict_from_flax(variables["params"], variables["frozen"])
    return {k: np.array(v) for k, v in sd.items() if k.endswith(STATS)}


def clamped(stats):
    """``stats`` bounded as the last pass of both packages bounds them."""
    return {k: np.clip(v, -1e3, 1e3) if k.endswith("mean")
            else np.clip(v, 1e-4, 1e4) for k, v in stats.items()}


@pytest.fixture(scope="module")
def reference():
    """The JAX package's calibration: its weights, its answer to
    ``needs_calibration``, its running statistics before each pass, the
    layers it skipped in each pass and its calibrated statistics."""
    mcfg = tiny_config().model
    jmodel = jax_make_detector(mcfg)
    variables = jax.tree.map(np.asarray, jax.device_get(
        dict(init_variables(jmodel, jax.random.PRNGKey(0)))))
    images = np.random.default_rng(0).integers(
        0, 256, (2, 128, 128, 3)).astype(np.uint8)
    names = bn_names()
    before, skipped = [], []
    make_capture = jax_calibrate._make_bn_capture

    def recording_capture(model, imgs):
        capture = make_capture(model, imgs)

        def run(v):
            before.append(running_stats(v))
            stats = capture(v)
            skipped.append(sorted(names[k] for k in nonfinite(stats)))
            return stats

        return run

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_calibrate, "_make_bn_capture", recording_capture)
    try:
        needs = jax_calibrate.needs_calibration(jmodel, variables, images)
        out = jax_calibrate.calibrate_frozen_stats(jmodel, variables, images)
    finally:
        mp.undo()
    return dict(cfg=model_config_from_dict(dataclasses.asdict(mcfg)),
                weights=state_dict_from_flax(variables["params"],
                                             variables["frozen"]),
                needs=needs, before=before, skipped=skipped,
                after=running_stats(out), images=images)


def torch_var_capture(model, images):
    """The variance as ``torch.var`` takes it: finite where the mean of
    squared deviations overflows."""
    stats, hooks = {}, []
    for name, mod in model.named_modules():
        if isinstance(mod, FrozenBatchNorm2d):
            def hook(_m, _inp, out, name=name):
                out = out.float()
                stats[name] = (out.mean((0, 2, 3)),
                               out.var((0, 2, 3), unbiased=False))
            hooks.append(mod.register_forward_hook(hook))
    try:
        calibrate._features(model, images)
    finally:
        for h in hooks:
            h.remove()
    return {k: (m.double().numpy(), v.double().numpy())
            for k, (m, v) in stats.items()}


def port_model(reference):
    model = make_detector(reference["cfg"])
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in reference["weights"].items()})
    return model.to(memory_format=torch.channels_last).eval()


def set_stats(model, stats):
    """Overwrite ``model``'s running statistics with ``stats``."""
    state = model.state_dict()
    for k, v in stats.items():
        state[k].copy_(torch.from_numpy(v))
    return model


def calibrated(model, images, capture, passes=12):
    """``calibrate_frozen_stats`` with ``capture`` taking the statistics;
    returns the running statistics and the layers skipped in each pass."""
    skipped = []

    def recording(m, imgs):
        stats = capture(m, imgs)
        skipped.append(nonfinite(stats))
        return stats

    mp = pytest.MonkeyPatch()
    mp.setattr(calibrate, "_capture_bn_stats", recording)
    try:
        calibrate.calibrate_frozen_stats(model, images, passes=passes)
    finally:
        mp.undo()
    return ({k: v.numpy().copy() for k, v in model.state_dict().items()
             if k.endswith(STATS)}, skipped)


def worst_stat_gap(got, want):
    """The largest difference of a running mean or variance, over its
    tensor's largest absolute value."""
    return max(float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30))
               for k, w in want.items())


@pytest.mark.parametrize("variance", ["mean_square", "torch_var"])
def test_calibration_matches_jax(reference, variance):
    capture = calibrate._capture_bn_stats if variance == "mean_square" \
        else torch_var_capture
    images = reference["images"]
    passes = len(reference["skipped"])
    assert passes == 12 and any(reference["skipped"]), \
        "no layer overflowed: the case does not test F1"
    # Teacher-forced: each pass from the JAX state before it.  The guard
    # stops after the first pass in which JAX skips a layer.
    first_skip = next(k for k, s in enumerate(reference["skipped"]) if s)
    forced = range(first_skip + 1) if variance == "torch_var" \
        else range(passes)
    forced_gaps, forced_skipped = [], []
    model = port_model(reference)
    for k in forced:
        got, skipped = calibrated(set_stats(model, reference["before"][k]),
                                  images, capture, passes=1)
        want = reference["before"][k + 1] if k + 1 < passes \
            else reference["after"]
        forced_gaps.append(worst_stat_gap(got, clamped(want)))
        forced_skipped += skipped
    if variance == "torch_var":
        # The guard: the old form updates layers the reference skips and
        # parts from it by far more than the tolerance.
        assert forced_skipped[first_skip] != reference["skipped"][first_skip]
        assert forced_gaps[first_skip] > 10 * TOL
        return
    model = set_stats(model, reference["before"][0])
    needs = calibrate.needs_calibration(model, images)
    got, skipped = calibrated(model, images, capture)
    assert needs is reference["needs"] is False
    assert forced_skipped == skipped == reference["skipped"]
    assert max(forced_gaps) <= TOL, forced_gaps
    assert worst_stat_gap(got, reference["after"]) <= STRAIGHT_TOL
