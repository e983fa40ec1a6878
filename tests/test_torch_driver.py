"""The port's training driver against ``podtpu.train.train.train`` (CPU).

Both packages train the tiny float32 detector
(``tests/conftest.py::tiny_config``) on the same ten synthetic JPEGs for
two epochs (8 train and 2 test images, 4 steps an epoch), fine-tuning from
one model directory, so both start from the same weights and freeze the
same three backbone stages.  The directory is written by the port from its
own seeded initialisation (a JAX ``init_variables`` would cost this file
another model compile; the JAX package loading a port-written directory is
part of the contract).  The port is fed the draws the JAX step keys give
(``split(fold_in(loop_rng, epoch), iters)``, through
``tests/test_torch_train.py::jax_draws``), and both read the same canvases
(both packages' native decoders, equal byte for byte; see
``tests/test_torch_native.py``).
The port's runs go in a spawned process beside the JAX run.

What is held, and to what:

* every step's batch (dataset indices), image weights and learning rate:
  equal;
* the first epoch's mean loss to 1e-4 relative (measured 3e-6), its
  parameters to 1e-5 absolute (measured 4.8e-6: one step's update is held
  to 1e-6 in ``tests/test_torch_train.py``, and this epoch takes four steps
  whose learning rates sum to twice that step's), and its 12 eval stats to
  1e-3;
* the second epoch, teacher-forced: the port resumes from a
  ``checkpoint.pt`` built from the JAX run's first-epoch state
  (parameters, frozen statistics, the SGD momentum trace, step and ALRS
  state) and trains the second epoch with JAX's draws; before each of
  its later steps the JAX state before that step replaces the port's.
  Held to the first epoch's tolerances: every step's batch and lr, the
  parameters after each step's update (measured 8.2e-7), the epoch's
  mean loss and the eval stats; and the final model directory to the JAX
  run's: parameters to 1e-4 of each tensor's largest value,
  ``results.txt`` to 1e-3.  Forced only at the epoch's start, the port
  follows JAX for three steps and parts at the fourth, where a discrete
  choice in the box head's loss flips on parameter differences within
  the tolerance: from JAX's own state before that step it gives JAX's
  loss;
* the straight runs' second epoch: both losses fall below the first
  epoch's, every stat lies in [-1, 1] with -1 in the same slots, and the
  final model directory loads in the JAX package.  Run straight, the two
  cannot be held tighter: the trajectory is chaotic at this size and rate.
  Two port runs whose starting weights differ by 1e-6 relative differ by
  4 % in the loss of the second epoch's last step; port and JAX differ by
  2.4 % in the second epoch's mean loss and by 1.8e-2 of a tensor's
  largest value in the final parameters.  The teacher-forced epoch holds
  what the straight runs cannot: the second epoch's steps, the momentum
  carried across the epoch boundary (the first forced step's update uses
  it) and resuming from a checkpoint written by another run.

A run resumed from the straight run's first-epoch checkpoint ends with its
parameters, exactly (the port is deterministic on the CPU).
"""
import dataclasses
import json
import multiprocessing
import os
import pickle
import shutil
import time
from collections.abc import Mapping
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

import jax
import optax

from podtpu.data import device_cache as jax_device_cache
from podtpu.train import checkpoints as jax_ckpt
from podtpu.train import train as jax_train
from podtpu_torch.core.config import config_from_dict, model_config_from_dict
from podtpu_torch.models.detector import init_parameters, make_detector
from podtpu_torch.models.weights import state_dict_from_flax
from podtpu_torch.train import checkpoints
from podtpu_torch.train.optim import make_optimizer
from podtpu_torch.train import train as port_train
from tests.conftest import tiny_config
from tests.synthetic import make_project
from tests.test_torch_data import port_project
from tests.test_torch_mask import torch_threads  # noqa: F401
from tests.test_torch_train import jax_draws

SEED = 0
KW = dict(labels=["particle"], batch_size=2, max_epochs=2, alrs_epochs=2,
          alrs_startup_factor=1, seed=SEED, num_workers=2)
STEPS = 4  # an epoch: 8 train images at batch 2


def draws_from_jax_keys(cfg, seed=SEED):
    """The port's ``draws`` for ``train``: the JAX driver's step keys
    (``podtpu/train/train.py:487, 611``), made once per step."""
    loop_rng = jax.random.split(jax.random.key(seed))[1]
    memo = {}

    def draws(epoch, it, batch):
        if (epoch, it) not in memo:
            keys = jax.random.split(jax.random.fold_in(loop_rng, epoch),
                                    STEPS)
            memo[epoch, it] = jax_draws(keys[it], cfg)
        return memo[epoch, it]

    return draws


def fill_masked(params, trace):
    """``trace`` (an optax state tree over ``params``) with zeros for the
    leaves ``optax.masked`` left out (the frozen backbone stages)."""
    if isinstance(trace, Mapping):
        return {k: fill_masked(params[k], v) for k, v in trace.items()}
    if isinstance(trace, optax.MaskedNode):
        return np.zeros_like(params)
    return np.asarray(trace)


def save_jax_state(path, state, **extra):
    """The JAX run's parameters, frozen statistics and optimiser state as
    they are, with ``extra``, pickled atomically (the weight bridge runs in
    the reader, off the JAX run's time)."""
    payload = dict(zip(("params", "frozen", "opt_state"), jax.device_get(
        (state.params, state.frozen, state.opt_state))), **extra)
    with open(path + ".tmp", "wb") as fp:
        pickle.dump(payload, fp, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(path + ".tmp", path)


def load_jax_state(path, abandoned):
    """The port's state dict and momentum buffers (numpy, by the port's
    parameter names) of a state ``save_jax_state`` wrote, once it is there,
    and the payload: parameters and frozen statistics through the weight
    bridge, and the SGD momentum trace (optax's ``trace`` from zeros is
    PyTorch's ``momentum_buffer``)."""
    wait_for(path, abandoned)
    with open(path, "rb") as fp:
        payload = pickle.load(fp)
    params, frozen = payload["params"], payload["frozen"]
    trace = next(s for s in jax.tree_util.tree_leaves(
        payload["opt_state"],
        is_leaf=lambda s: isinstance(s, optax.TraceState))
        if isinstance(s, optax.TraceState)).trace
    return (state_dict_from_flax(params, frozen),
            state_dict_from_flax(fill_masked(params, trace), frozen),
            payload)


def port_checkpoint_from_jax(out_dir, path, abandoned, train_cfg):
    """The port's ``checkpoint.pt`` holding the JAX state at ``path``, saved
    after an epoch: parameters, frozen statistics, momentum, step count,
    epoch, ALRS state and model config."""
    sd, momentum, payload = load_jax_state(path, abandoned)
    pcfg = model_config_from_dict(payload["model_cfg"])
    model = make_detector(pcfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    optimizer = make_optimizer(train_cfg, model)
    names = {id(p): n for n, p in model.named_parameters()}
    for group in optimizer.param_groups:
        for p in group["params"]:
            optimizer.state[p]["momentum_buffer"] = torch.from_numpy(
                momentum[names[id(p)]])
    checkpoints.save_train_checkpoint(out_dir, model, optimizer,
                                      payload["step"], payload["epoch"],
                                      payload["alrs"], model_cfg=pcfg)


def force_state(model, optimizer, path, abandoned):
    """The largest absolute difference between the port's parameters and
    those of the JAX state saved at ``path``; then that state (parameters,
    frozen statistics, momentum) loaded into the port's model and
    optimiser."""
    names = {id(p): n for n, p in model.named_parameters()}
    want, momentum, _ = load_jax_state(path, abandoned)
    sd = model.state_dict()
    diff = max(float(np.abs(sd[k].numpy() - v).max())
               for k, v in want.items())
    with torch.no_grad():
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in want.items()})
        for group in optimizer.param_groups:
            for p in group["params"]:
                optimizer.state[p]["momentum_buffer"].copy_(
                    torch.from_numpy(momentum[names[id(p)]]))
    return diff


def wait_for(path, abandoned, seconds=300):
    """Block until ``path`` exists; raise if ``abandoned`` appears first or
    ``seconds`` pass."""
    deadline = time.monotonic() + seconds
    while not os.path.exists(path):
        if os.path.exists(abandoned) or time.monotonic() > deadline:
            raise RuntimeError(f"the JAX run wrote no {path}")
        time.sleep(0.1)


def record(mp, rec, train_module, ckpt_module, jax_side):
    """Record, in ``rec``, each scheduler step's ``(epoch, loss)``, each
    train step's (dataset indices, image weights, lr), each epoch's eval
    stats and the parameters each checkpoint saves.  With
    ``rec["forced"]``, a directory, the JAX side also writes there its
    state after the first epoch and before each later step, and the port
    side, from its second step on, loads that step's state first and
    records in ``rec["updates"]`` how far its own parameters were from
    it."""
    make_scheduler = train_module.make_scheduler

    def scheduler(train_cfg, base_lr):
        sched = make_scheduler(train_cfg, base_lr)
        step = sched.step

        def logged(epoch, loss):
            rec["losses"].append((epoch, loss))
            return step(epoch, loss)

        sched.step = logged
        return sched

    evaluate = train_module.evaluate

    def evaluated(*args, **kwargs):
        ev, stats = evaluate(*args, **kwargs)
        rec["stats"].append(list(stats))
        return ev, stats

    save = ckpt_module.save_train_checkpoint
    if jax_side:
        make_cached = jax_device_cache.make_cached_train_step

        def cached_step(*args, **kwargs):
            step = make_cached(*args, **kwargs)

            def logged(state, arrays, idx, bvalid, rng, lr):
                if rec.get("forced") and len(rec["steps"]) > STEPS:
                    save_jax_state(os.path.join(
                        rec["forced"], f"state{len(rec['steps'])}.pt"), state)
                rec["steps"].append((np.asarray(idx), np.asarray(bvalid),
                                     np.float32(lr)))
                return step(state, arrays, idx, bvalid, rng, lr)

            return logged

        def saved(out_dir, state, epoch, alrs_state, model_cfg=None):
            rec["params"].append(state_dict_from_flax(
                *jax.device_get((state.params, state.frozen))))
            if epoch == 0 and rec.get("forced"):
                save_jax_state(
                    os.path.join(rec["forced"], f"state{int(state.step)}.pt"),
                    state, step=int(state.step), epoch=epoch,
                    alrs=alrs_state, model_cfg=dataclasses.asdict(model_cfg))
            return save(out_dir, state, epoch, alrs_state,
                        model_cfg=model_cfg)

        mp.setattr(jax_device_cache, "make_cached_train_step", cached_step)
    else:
        make_step = train_module.make_train_step

        def cached_step(model, optimizer, *args, **kwargs):
            step = make_step(model, optimizer, *args, **kwargs)

            def logged(batch, lr, **kw):
                if rec.get("forced") and rec["steps"]:
                    k = STEPS + len(rec["steps"])
                    rec["updates"].append((k - 1, force_state(
                        model, optimizer,
                        os.path.join(rec["forced"], f"state{k}.pt"),
                        rec["abandoned"])))
                rec["steps"].append((np.asarray(batch["index"]),
                                     np.asarray(batch["image_weight"]),
                                     np.float32(lr)))
                return step(batch, lr, **kw)

            return logged

        def saved(out_dir, model, optimizer, step, epoch, *args, **kwargs):
            rec["params"].append({k: v.numpy().copy() for k, v
                                  in model.state_dict().items()})
            save(out_dir, model, optimizer, step, epoch, *args, **kwargs)
            if epoch == 0 and rec.get("snapshot"):
                # The checkpoint a run stopped after one epoch leaves.
                os.makedirs(rec["snapshot"], exist_ok=True)
                shutil.copy(os.path.join(out_dir, checkpoints.CHECKPOINT),
                            rec["snapshot"])

        mp.setattr(train_module, "make_train_step", cached_step)
    mp.setattr(train_module, "make_scheduler", scheduler)
    mp.setattr(train_module, "evaluate", evaluated)
    mp.setattr(ckpt_module, "save_train_checkpoint", saved)


def port_runs(root, project, cfg, pretrained):
    """The port's straight two-epoch run, a run resumed from its first
    epoch's checkpoint and the teacher-forced second epoch, all recorded.
    The forced run resumes from the JAX run's first epoch, written as a
    port checkpoint (``forced/checkpoint.pt``), and before each later step
    takes the JAX state before that step (``forced/state<step>.pt``).  It
    runs in a spawned process beside the JAX run, which traces and
    compiles for most of its 40 s: in one process the two would take turns
    at the interpreter lock."""
    jax.config.update("jax_platforms", "cpu")
    # Half the cores: the JAX run beside this one is the longer.  (At 2
    # threads the first epoch's parameters, 4.8e-6 from JAX's here, moved
    # 1.02e-5 from them: float32 sums in another order.)
    torch.set_num_threads(max(1, torch.get_num_threads() // 2))
    rec = {k: [] for k in ("losses", "stats", "steps", "params")}
    rec["snapshot"] = os.path.join(root, "resumed")
    mp = pytest.MonkeyPatch()
    try:
        record(mp, rec, port_train, checkpoints, jax_side=False)
        draws = draws_from_jax_keys(cfg)
        port_dir = port_train.train(project, output_dir=root, name="port",
                                    config=cfg, pretrained=pretrained,
                                    device="cpu", draws=draws, **KW)
        rec["snapshot"] = None
        straight = {k: list(rec[k]) for k in ("losses", "steps")}
        # The resumed run also writes the profiler trace of its first
        # epoch's steps 3 to 6 (that epoch has 4 steps: the trace ends with
        # it).
        trace_dir = os.path.join(root, "trace")
        mp.setenv("PODTPU_TRACE_DIR", trace_dir)
        resumed = port_train.train(project, output_dir=root, name="resumed",
                                   config=cfg, pretrained=pretrained,
                                   resume=True, device="cpu", draws=draws,
                                   **KW)
    finally:
        mp.undo()
    forced_rec = {k: [] for k in ("losses", "stats", "steps", "params",
                                  "updates")}
    forced_rec.update(forced=os.path.join(root, "forced"),
                      abandoned=os.path.join(root, "abandoned"))
    # The port's optimiser as ``train()`` makes it of ``cfg`` and ``KW``.
    train_cfg = dataclasses.replace(cfg.train, **{
        k: KW[k] for k in ("batch_size", "max_epochs", "alrs_epochs",
                           "alrs_startup_factor")})
    port_checkpoint_from_jax(forced_rec["forced"],
                             os.path.join(root, "forced", f"state{STEPS}.pt"),
                             forced_rec["abandoned"], train_cfg)
    mp = pytest.MonkeyPatch()
    try:
        record(mp, forced_rec, port_train, checkpoints, jax_side=False)
        forced = port_train.train(project, output_dir=root, name="forced",
                                  config=cfg, pretrained=pretrained,
                                  resume=True, device="cpu", draws=draws,
                                  **KW)
    finally:
        mp.undo()
    del rec["params"][1:]  # only the first epoch's are compared
    return dict(port_dir=port_dir, resumed=resumed, port=rec,
                straight=straight, trace=os.path.join(trace_dir, "trace.json"),
                forced=forced, forced_rec=forced_rec)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_driver")
    jcfg = tiny_config()
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    project = make_project(str(root / "images"), num_images=10)
    pretrained = str(root / "pretrained")
    model = make_detector(dataclasses.replace(cfg.model, num_classes=2))
    init_parameters(model, torch.Generator().manual_seed(7))
    checkpoints.save_model(pretrained, model, model.cfg, ["particle"])
    jax_rec = {k: [] for k in ("losses", "stats", "steps", "params")}
    jax_rec["forced"] = str(root / "forced")
    os.makedirs(jax_rec["forced"])
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(1, mp_context=ctx) as pool:
        port = pool.submit(port_runs, str(root), port_project(project), cfg,
                           pretrained)
        mp = pytest.MonkeyPatch()
        try:
            record(mp, jax_rec, jax_train, jax_ckpt, jax_side=True)
            jax_dir = jax_train.train(project, output_dir=str(root),
                                      name="jax", config=jcfg,
                                      pretrained=pretrained, **KW)
        except BaseException:
            (root / "abandoned").touch()
            raise
        finally:
            mp.undo()
        out = port.result(timeout=600)
    yield dict(out, project=project, cfg=cfg, jax_dir=jax_dir, jax=jax_rec)
    # Six model directories and checkpoints of the full-width backbone:
    # about 2.4 GB.
    shutil.rmtree(root, ignore_errors=True)


def model_state(model_dir):
    params, frozen, _, _ = jax_ckpt.load_model(model_dir)
    return state_dict_from_flax(params, frozen)


def read_results(model_dir):
    with open(os.path.join(model_dir, "results.txt")) as fp:
        return [float(line.rsplit("=", 1)[1]) for line in fp]


class TestAgainstJax:
    def test_same_steps(self, runs):
        got, want = runs["straight"]["steps"], runs["jax"]["steps"]
        assert len(got) == len(want) == 8
        forced = runs["forced_rec"]["steps"]
        assert len(forced) == 4
        for (gi, gw, glr), (wi, ww, wlr) in zip(got + forced,
                                                want + want[4:]):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gw, ww.astype(np.float32))
            assert glr == wlr

    def test_epoch_losses(self, runs):
        got, want = runs["straight"]["losses"], runs["jax"]["losses"]
        assert [e for e, _ in got] == [e for e, _ in want] == [0, 1]
        np.testing.assert_allclose(got[0][1], want[0][1], rtol=1e-4)
        for losses in (got, want):
            assert np.isfinite(losses[1][1]) and losses[1][1] < losses[0][1]
        forced = runs["forced_rec"]["losses"]
        assert [e for e, _ in forced] == [1]
        np.testing.assert_allclose(forced[0][1], want[1][1], rtol=1e-4)

    def test_first_epoch_parameters_and_stats(self, runs):
        got, want = runs["port"]["params"][0], runs["jax"]["params"][0]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(runs["port"]["stats"][0],
                                   runs["jax"]["stats"][0], rtol=0,
                                   atol=1e-3)

    def test_second_epoch_teacher_forced(self, runs):
        """The second epoch from JAX's states, at the first epoch's
        tolerances: each step's update from the JAX state before it, the
        parameters and stats after the epoch; then the final model
        directory, through the weight bridge, and ``results.txt``."""
        forced = runs["forced_rec"]
        assert [k for k, _ in forced["updates"]] == [4, 5, 6]
        for k, diff in forced["updates"]:
            assert diff <= 1e-5, (k, diff)
        got, want = forced["params"][0], runs["jax"]["params"][1]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(forced["stats"][0],
                                   runs["jax"]["stats"][1], rtol=0,
                                   atol=1e-3)
        got = model_state(runs["forced"])
        for k in want:
            np.testing.assert_allclose(
                got[k], want[k], rtol=0,
                atol=1e-4 * max(float(np.abs(want[k]).max()), 1e-30),
                err_msg=k)
        np.testing.assert_allclose(read_results(runs["forced"]),
                                   read_results(runs["jax_dir"]), rtol=0,
                                   atol=1e-3)
        ckpt = checkpoints.load_train_checkpoint(runs["forced"])
        assert ckpt["epoch"] == 1 and ckpt["step"] == 2 * STEPS

    def test_artifacts(self, runs):
        for name in ("labels.txt", "config.json", "model.msgpack",
                     "results.txt", "checkpoint.pt"):
            assert os.path.exists(os.path.join(runs["port_dir"], name)), name
        with open(os.path.join(runs["port_dir"], "labels.txt")) as a, \
                open(os.path.join(runs["jax_dir"], "labels.txt")) as b:
            assert a.read() == b.read()
        got, want = read_results(runs["port_dir"]), read_results(
            runs["jax_dir"])
        assert len(got) == len(want) == 12
        assert all(-1 <= v <= 1 for v in got)
        assert [v == -1 for v in got] == [v == -1 for v in want]
        # The port's model directory loads in the JAX package.
        params, frozen, jcfg, labels = jax_ckpt.load_model(runs["port_dir"])
        assert labels == ["particle"]
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(
            jax_ckpt.load_model(runs["jax_dir"])[2])
        assert all(np.isfinite(v).all() for v in state_dict_from_flax(
            params, frozen).values())


class TestResume:
    def test_resumed_run_ends_where_the_straight_run_ends(self, runs):
        straight = runs["straight"]["losses"]
        resumed = runs["port"]["losses"][len(straight):]
        assert resumed == straight[1:]
        got, want = model_state(runs["resumed"]), model_state(
            runs["port_dir"])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        ckpt = checkpoints.load_train_checkpoint(runs["resumed"])
        assert ckpt["epoch"] == 1 and ckpt["step"] == 8
        assert ckpt["alrs"]["buffer"] == [v for _, v in straight]

    def test_profiler_trace(self, runs):
        with open(runs["trace"]) as fp:
            trace = json.load(fp)
        names = {e.get("name") for e in trace["traceEvents"]}
        assert "aten::conv2d" in names

    def test_jax_checkpoint_is_refused(self, runs, tmp_path):
        (tmp_path / "old").mkdir()
        (tmp_path / "old" / "checkpoint.pkl").write_bytes(b"")
        with pytest.raises(ValueError, match="checkpoint.pkl"):
            port_train.train(port_project(runs["project"]),
                             output_dir=str(tmp_path), name="old",
                             resume=True, device="cpu", **KW)


@pytest.mark.parametrize("kwargs,item", [
    (dict(num_devices=2), "item 18"),
])
def test_unported_options_raise(runs, tmp_path, kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        port_train.train(port_project(runs["project"]),
                         output_dir=str(tmp_path), device="cpu",
                         **dict(KW, **kwargs))


@pytest.mark.parametrize("kwargs", [
    dict(family="ssd", backbone="resnet50_fpn"),
    dict(family="retinanet", backbone="mobilenet_v2"),
    dict(family="fcos", with_mask=True),
    dict(with_mask=True, with_keypoints=True),
    dict(family="retinanet", with_keypoints=True),
    dict(family="faster_rcnn_v2", backbone="mobilenet_v2"),
])
def test_invalid_combinations_raise_as_in_jax(runs, tmp_path, kwargs):
    with pytest.raises(ValueError) as want:
        jax_train.train(runs["project"], output_dir=str(tmp_path),
                        **dict(KW, **kwargs))
    with pytest.raises(ValueError) as got:
        port_train.train(port_project(runs["project"]),
                         output_dir=str(tmp_path), device="cpu",
                         **dict(KW, **kwargs))
    assert str(got.value) == str(want.value)


def test_train_needs_a_device_without_gpu(runs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.train(port_project(runs["project"]),
                         output_dir=str(tmp_path), **KW)


