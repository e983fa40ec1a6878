"""The cached training path of podtpu_torch on the CPU: the device cache's
step, K steps a dispatch, ``train()`` on every data path, profiling.

On the CPU the port's K-step dispatch is a loop of K cached steps (on the
GPU it is one CUDA graph of them, held in ``chip_smoke.py``), so what holds
here holds the graph's inputs and arithmetic:

* the cached single step, gathering in the step (``take`` and ``slice``),
  gives the streamed step's losses, parameters and momentum bit for bit;
* a 3-step group, twice, gives 6 single cached steps' bit for bit, with
  its draws made before the group in step order;
* ``_dispatch_groups`` groups as JAX's does;
* ``train()`` on 18 images (one group of 8, then a tail step) with the
  cache on, off and windowed (a window of 8 samples) takes the same
  batches, image weights and learning rates at every step, ends with the
  same parameters bit for bit and writes the same ``results.txt``;
* each optimiser, given its learning rate as a 0-d tensor (the form a
  graph reads), matches its optax chain to the tolerances of
  ``tests/test_torch_augment.py``;
* ``StepTimer`` gives JAX's percentiles on the same durations, and
  ``trace`` writes a trace file.

The JAX step is not compiled here: the streamed step is held against JAX
in ``tests/test_torch_train.py`` and ``train()`` in
``tests/test_torch_driver.py``.
"""
import contextlib
import dataclasses
import io
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from podtpu.core import profiling as jax_profiling
from podtpu.core.config import ModelConfig as JaxModelConfig
from podtpu.core.config import TrainConfig as JaxTrainConfig
from podtpu.train import optim as jax_optim
from podtpu.train import train as jax_train
from podtpu_torch.core import profiling
from podtpu_torch.core.config import (TrainConfig, config_from_dict,
                                      model_config_from_dict)
from podtpu_torch.data import device_cache
from podtpu_torch.data.dataset import DetectionDataset
from podtpu_torch.data.loader import Loader
from podtpu_torch.models.detector import init_parameters, make_detector
from podtpu_torch.train import checkpoints
from podtpu_torch.train import optim
from podtpu_torch.train import train as port_train
from podtpu_torch.train.step import draw_train, make_train_step
from tests.conftest import tiny_config
from tests.synthetic import make_project
from tests.test_torch_augment import (FROZEN, OPTIMISERS, PARAMS, ToyModel,
                                      leaf, nest)
from tests.test_torch_data import port_project
from tests.test_torch_mask import torch_threads  # noqa: F401

LABELS = ["particle"]
N_TRAIN = 18


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cached_step")
    cfg = config_from_dict(dataclasses.asdict(tiny_config()))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_classes=len(LABELS) + 1))
    project = port_project(make_project(str(root / "train"),
                                        num_images=N_TRAIN, seed=1))
    test_project = port_project(make_project(str(root / "test"),
                                             num_images=2, seed=2))
    pretrained = str(root / "pretrained")
    model = make_detector(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(3))
    checkpoints.save_model(pretrained, model, cfg.model, LABELS)
    dataset = DetectionDataset(project, image_size=cfg.model.image_size,
                               max_gt=cfg.model.max_gt_boxes,
                               label_names=LABELS)
    yield dict(root=root, cfg=cfg, project=project, dataset=dataset,
               test_project=test_project, pretrained=pretrained,
               state=model.state_dict())
    shutil.rmtree(root, ignore_errors=True)


def fresh(setup):
    """The tiny model from the fixture's weights, its optimiser and step."""
    cfg = setup["cfg"]
    model = make_detector(cfg.model)
    model.load_state_dict(setup["state"])
    model = model.to(memory_format=torch.channels_last)
    opt = optim.make_optimizer(cfg.train, model)
    return model, opt, make_train_step(model, opt, cfg, device="cpu")


def assert_same_state(a, b):
    (ma, oa), (mb, ob) = a, b
    for (name, x), y in zip(ma.state_dict().items(),
                            mb.state_dict().values()):
        assert torch.equal(x, y), name
    bufs = [[s["momentum_buffer"] for s in o.state.values()]
            for o in (oa, ob)]
    assert len(bufs[0]) == len(bufs[1]) > 0
    assert all(torch.equal(x, y) for x, y in zip(*bufs))


def assert_same_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(torch.as_tensor(got[k]),
                           torch.as_tensor(want[k])), k


@pytest.mark.parametrize("gather", ["take", "slice"])
def test_cached_step_is_the_streamed_step(setup, gather, capsys):
    ds, cfg = setup["dataset"], setup["cfg"]
    kw = dict(shuffle=True, seed=1)
    cache = device_cache.DeviceDataCache(ds, device="cpu")
    raw = device_cache.DeviceLoader(cache, 2, raw=True, **kw)
    stream = Loader(ds, 2, num_workers=1, **kw)
    m1, o1, step = fresh(setup)
    m2, o2, base = fresh(setup)
    cached = device_cache.make_cached_train_step(base, gather)
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    for i, ((idx, v1), (batch, v2)) in enumerate(zip(raw, stream)):
        if i == 2:
            break
        np.testing.assert_array_equal(v1, v2)
        lr = 0.005 * (i + 1)
        want = step(dict(batch, image_weight=torch.from_numpy(
            v2.astype(np.float32))), lr, generator=g1)
        got = cached(cache.arrays, idx, v1.astype(np.float32), lr,
                     generator=g2)
        assert_same_metrics(got, want)
    assert_same_state((m2, o2), (m1, o1))
    capsys.readouterr()


def test_group_of_three_is_three_steps(setup, capsys):
    ds, cfg = setup["dataset"], setup["cfg"]
    cache = device_cache.DeviceDataCache(ds, device="cpu")
    batches = list(device_cache.DeviceLoader(cache, 2, raw=True, shuffle=True,
                                             seed=2))[:6]
    lrs = np.float32([0.001, 0.002, 0.004, 0.005, 0.005, 0.003])
    m1, o1, base1 = fresh(setup)
    single = device_cache.make_cached_train_step(base1, "slice")
    g1 = torch.Generator().manual_seed(9)
    want = [single(cache.arrays, idx, v.astype(np.float32), float(lr),
                   generator=g1) for (idx, v), lr in zip(batches, lrs)]
    m2, o2, base2 = fresh(setup)
    multi = device_cache.make_cached_multi_step(base2, 3, "slice")
    g2 = torch.Generator().manual_seed(9)
    shape = {"boxes": torch.empty((2, cfg.model.max_gt_boxes, 4),
                                  device="meta")}
    got = []
    for start in (0, 3):
        group = batches[start:start + 3]
        out = multi(cache.arrays, np.stack([i for i, _ in group]),
                    np.stack([v.astype(np.float32) for _, v in group]),
                    lrs[start:start + 3],
                    [draw_train(g2, cfg, shape) for _ in group])
        assert all(v.shape[0] == 3 for v in out.values())
        got += [{k: v[j] for k, v in out.items()} for j in range(3)]
    assert multi.calls == 2 and multi.captures == 0  # the CPU loops
    for g, w in zip(got, want):
        assert_same_metrics(g, w)
    assert_same_state((m2, o2), (m1, o1))
    with pytest.raises(ValueError, match="3 steps"):
        multi(cache.arrays, np.stack([i for i, _ in batches[:2]]),
              np.ones((2, 2), np.float32), lrs[:2], [None, None])
    capsys.readouterr()


@pytest.mark.parametrize("k", [4, 1])
def test_dispatch_groups(k):
    items = [(np.asarray([i]), np.asarray([True])) for i in range(10)]
    got = list(port_train._dispatch_groups(iter(items), k))
    want = list(jax_train._dispatch_groups(iter(items), k))
    assert [len(g) for g in got] == [len(g) for g in want]
    assert [[int(b[0]) for b, _ in g] for g in got] == \
        [[int(b[0]) for b, _ in g] for g in want]


def train_run(setup, name, mp, device_data_cache, budget=None):
    """One epoch of ``train()``; returns its steps (indices, weights, lrs),
    printout, final parameters and results."""
    cfg = dataclasses.replace(setup["cfg"], data=dataclasses.replace(
        setup["cfg"].data, device_data_cache=device_data_cache))
    steps = []
    make_step = port_train.make_train_step

    def recorded(model, optimizer, *args, **kwargs):
        step = make_step(model, optimizer, *args, **kwargs)

        def logged(batch, lr, **kw):
            steps.append((np.asarray(batch["index"]),
                          np.asarray(batch["image_weight"]),
                          np.float32(lr)))
            return step(batch, lr, **kw)

        return logged

    with mp.context() as m:
        m.setattr(port_train, "make_train_step", recorded)
        if budget is not None:
            m.setenv("PODTPU_DEVICE_CACHE_BYTES", str(budget))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            model_dir = port_train.train(
                setup["project"], labels=LABELS,
                output_dir=str(setup["root"]), name=name, batch_size=2,
                max_epochs=1, config=cfg, pretrained=setup["pretrained"],
                seed=4, num_workers=1, test_project=setup["test_project"],
                device="cpu")
    state = torch.load(os.path.join(model_dir, checkpoints.CHECKPOINT),
                       weights_only=False)["model"]
    with open(os.path.join(model_dir, "results.txt")) as fp:
        results = fp.read()
    return dict(steps=steps, printed=out.getvalue(), state=state,
                results=results)


@pytest.fixture(scope="module")
def train_runs(setup):
    per = device_cache.dataset_device_bytes(
        1, setup["cfg"].model.image_size, setup["cfg"].model.max_gt_boxes)
    mp = pytest.MonkeyPatch()
    return {"cached": train_run(setup, "cached", mp, "auto"),
            "streamed": train_run(setup, "streamed", mp, False),
            "windowed": train_run(setup, "windowed", mp, "auto",
                                  budget=2 * 8 * per + 1)}


@pytest.mark.parametrize("path", ["streamed", "windowed"])
def test_train_paths_agree(train_runs, path):
    want, got = train_runs["cached"], train_runs[path]
    assert "Training data pinned on device (" in want["printed"]
    assert "Training data pinned" not in got["printed"]
    windowed = "Streaming via windowed device cache (8 samples/window"
    assert (windowed in got["printed"]) == (path == "windowed")
    assert len(want["steps"]) == len(got["steps"]) == N_TRAIN // 2
    for (gi, gw, glr), (wi, ww, wlr) in zip(got["steps"], want["steps"]):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gw, ww)
        assert glr == wlr
    seen = np.concatenate([i for i, _, _ in want["steps"]])
    assert sorted(seen) == list(range(N_TRAIN))
    for name, x in want["state"].items():
        assert torch.equal(x, got["state"][name]), name
    assert got["results"] == want["results"]


@pytest.mark.parametrize("name", sorted(OPTIMISERS))
def test_tensor_lr_matches_optax(name):
    """``apply_optimizer`` with the learning rate as a 0-d tensor, three
    updates against the optax chain (``tests/test_torch_augment.py``'s
    check, same tolerances)."""
    rng = np.random.default_rng(len(name) + 100)
    values = {n: rng.normal(0, 0.1, (4, 3)).astype(np.float32)
              for n in PARAMS}
    grads = [{n: rng.normal(0, 1, (4, 3)).astype(np.float32)
              * (n not in FROZEN) for n in PARAMS} for _ in range(3)]
    lrs = [0.01, 0.005, 0.02]
    jtrain = JaxTrainConfig(**OPTIMISERS[name])
    tx = jax_optim.make_optimizer(jtrain, JaxModelConfig())
    jparams = nest({n: jnp.asarray(v) for n, v in values.items()})
    state = tx.init(jparams)
    model = ToyModel(values, model_config_from_dict(
        dataclasses.asdict(JaxModelConfig())))
    train_cfg = TrainConfig(**OPTIMISERS[name])
    opt = optim.make_optimizer(train_cfg, model)
    for g, lr in zip(grads, lrs):
        jparams, state = jax_optim.apply_optimizer(
            tx, nest({n: jnp.asarray(v) for n, v in g.items()}), state,
            jparams, jnp.float32(lr))
        for n, p in model.named_parameters():
            p.grad = None if n in FROZEN else torch.from_numpy(g[n])
        optim.apply_optimizer(opt, torch.tensor(lr, dtype=torch.float32),
                              train_cfg.clip_grad_norm)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), leaf(jparams, n),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
        if n in FROZEN:
            np.testing.assert_array_equal(p.detach().numpy(), values[n])


def test_step_timer_and_trace(tmp_path, capsys):
    durations = [0.5, 0.012, 0.011, 0.015, 0.010, 0.013, 0.02, 0.011]
    got, want = profiling.StepTimer(), jax_profiling.StepTimer()
    for timer in (got, want):
        with timer:
            pass
        assert len(timer._all) == 1 and timer.steady == timer._all
        timer._all = list(durations)
    assert got.steady == want.steady and len(got.steady) == 5
    for q in (0, 50, 90, 99, 100):
        assert got.percentile(q) == want.percentile(q)
    assert (got.p50, got.p90) == (want.p50, want.p90)
    assert got.summary(2, "images") == want.summary(2, "images")
    assert profiling.StepTimer().p50 == jax_profiling.StepTimer().p50 == 0.0
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("tiny"):
            torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "trace.json") > 0
    assert "trace written" in capsys.readouterr().out
    with profiling.trace(None):  # no directory, no trace
        pass
    assert 0 < profiling.slope_time(lambda i: torch.ones(8) * i,
                                    iters=(1, 3), reps=1) < 1


@pytest.mark.parametrize("shape", [(3, 4, 28, 28), (2, 1, 1, 5),
                                   (1, 2, 3, 1)])
def test_keypoint_upsample_backward(shape):
    """The keypoint head's 2x bilinear upsample: the interpolation's own
    forward, and as backward its transpose summed in a fixed order (the
    interpolation's own backward adds with atomics on the GPU), equal to
    the interpolation's gradient to float64 rounding."""
    from podtpu_torch.models.roi_heads import _Upsample2x

    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    want_y = torch.nn.functional.interpolate(
        x, scale_factor=2, mode="bilinear", align_corners=False)
    g = torch.randn(want_y.shape, dtype=torch.float64, generator=gen)
    want, = torch.autograd.grad(want_y, x, g)
    y = _Upsample2x.apply(x)
    got, = torch.autograd.grad(y, x, g)
    assert torch.equal(y, want_y)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
