"""The crop classifier of podtpu_torch against podtpu's (CPU).

A class-sorted crop tree (4 classes x 5 seeded crops of 20-50 px, PNG and
JPEG, with a file that is not an image) feeds both packages at a 32 px
image size, batch 8: 16 training crops (2 steps an epoch) and 4 held out.
Held here, and to what:

* ``scan_crop_folders`` and ``load_crop`` equal, on the OpenCV branch and
  on the Pillow branch (``cv2`` hidden from both packages through
  ``sys.modules``);
* ``CropClassifier`` through the weight bridge on JAX's ``model.init``
  parameters: float32 logits to 1e-5 (measured 2.3e-6 at logits of about
  2), the default bf16 to 5e-2 (measured 2.2e-2: both run bf16
  convolutions, whose roundings differ); the bridge is exact both ways and
  refuses a missing or an unknown tensor; the port's own initialisation
  has flax's distributions;
* ``train_classifier`` for two epochs with ``CropClassifier`` patched to
  float32 in both packages, the port started from JAX's initial parameters
  (``initial_params``) and teacher-forced: after each of its steps the
  JAX run's parameters and AdamW state after that step replace the
  port's, and each training forward takes the ReLU signs of JAX's step
  (``tests/test_torch_retinanet.py::forced_relus``; one of the 17 ReLUs'
  inputs flips in the four steps: unforced, it moves the stem's gradient
  by 0.5 %).  Adam's eps (1e-8) turns float32 rounding of gradients near
  0 into updates of up to the learning rate, so a straight run parts from
  JAX's at once.  Held: every step's batch loss to 1e-5 relative,
  accuracy and lr equal; the first step's gradients to 2e-3 of each
  tensor's largest (JAX's recovered from its first moment,
  ``mu / (1 - b1)``); the first update from JAX's gradients to 1e-6; the
  port's parameters after each of its own steps to 1e-6 wherever JAX's
  Adam denominator ``sqrt(v_hat)`` is at least 1e-5, and within twice the
  learning rate elsewhere (a first update moves an entry by at most the
  learning rate; measured 4.2e-4), with fewer than 1e-4 of the entries
  more than 1e-6 apart (measured at most 1.9e-5, every one of them at
  ``sqrt(v_hat)`` <= 1.1e-6); the held-out accuracy and the three files of
  the model directory (the parameters by the last step's rule);
* ``classify_crops`` labels equal on a directory written by JAX and on one
  written by the port, each read by the other package;
* ``train-crop-classifier`` dispatched equally by both CLIs (entry points
  replaced by recorders), and run by the port's; ``classify-crops``
  through both CLIs on that directory: the same JSON.

Classification runs both packages' ``CropClassifier`` in float32: in bf16
their logits differ by up to 2.2e-2, so an argmax between two close
classes may differ.

One JAX ``train_classifier`` run (in a module fixture), one compile each of
the float32 and bf16 forwards, and one ``classify_crops`` compile per call.
"""
import functools
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

import jax
import jax.numpy as jnp
import optax

import podtpu.cli as jax_cli
from podtpu.models import classifier as jax_classifier_module
from podtpu.models.classifier import CropClassifier as JaxClassifier
from podtpu.train import classify as jax_classify
import podtpu_torch.cli as port_cli
from podtpu_torch.models.classifier import CropClassifier, init_classifier
from podtpu_torch.models.weights import (classifier_flax_from_state_dict,
                                         classifier_state_dict_from_flax)
from podtpu_torch.shared import msgpack
from podtpu_torch.train import classify
from podtpu_torch.train.optim import apply_optimizer
from tests.test_torch_mask import torch_threads  # noqa: F401
from tests.test_torch_retinanet import RecordingLinen, forced_relus

SIZE, B, LR, EPOCHS = 32, 8, 1e-3, 2
CLASSES = ["coccolith", "diatom", "foram", "radiolarian"]
ADAM_FLOOR = 1e-5  # sqrt(v_hat) under which Adam's eps amplifies rounding


def leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def crops(tmp_path_factory):
    root = tmp_path_factory.mktemp("crops") / "tree"
    rng = np.random.default_rng(0)
    for c, name in enumerate(CLASSES):
        (root / name).mkdir(parents=True)
        for i in range(5):
            h, w = (int(v) for v in rng.integers(20, 50, 2))
            img = rng.integers(0, 70, (h, w, 3)).astype(np.uint8)
            img[h // 4: 3 * h // 4, w // 4: 3 * w // 4, c % 3] += 150
            suffix = ".jpg" if i == 4 else ".png"
            Image.fromarray(img).save(root / name / f"crop{i}{suffix}")
    (root / CLASSES[0] / "notes.txt").write_text("not an image")
    return str(root)


_INIT = {}


def jax_params(dtype=jnp.float32):
    """JAX's model in ``dtype`` and the parameters ``train_classifier``
    starts from at seed 0 (float32 whatever the compute dtype: one init
    serves the file)."""
    if not _INIT:
        variables = JaxClassifier(num_classes=len(CLASSES)).init(
            jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))
        _INIT["params"] = jax.tree.map(np.array,
                                       jax.device_get(variables["params"]))
    return (JaxClassifier(num_classes=len(CLASSES), dtype=dtype),
            _INIT["params"])


def port_model(params, dtype=torch.float32):
    model = CropClassifier(len(CLASSES), dtype=dtype)
    model.load_state_dict({k: t(v) for k, v in
                           classifier_state_dict_from_flax(params).items()})
    return model.to(memory_format=torch.channels_last)


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("branch", ["cv2", "pillow"])
def test_scan_and_load_crops(crops, monkeypatch, branch):
    if branch == "pillow":
        monkeypatch.setitem(sys.modules, "cv2", None)
    got = classify.scan_crop_folders(crops)
    assert got == jax_classify.scan_crop_folders(crops)
    paths, labels, names = got
    assert len(paths) == 20 and names == CLASSES
    assert labels == [i // 5 for i in range(20)]
    for path in paths[::3]:
        a = classify.load_crop(path, SIZE)
        np.testing.assert_array_equal(a, jax_classify.load_crop(path, SIZE))
        assert a.shape == (SIZE, SIZE, 3) and a.dtype == np.float32
    # The branches differ: each package took the branch asked for.
    with Image.open(paths[0]) as im:
        img = np.asarray(im.convert("RGB"))
    pillow = np.asarray(Image.fromarray(img).resize((SIZE, SIZE)))
    assert np.array_equal(classify.load_crop(paths[0], SIZE),
                          pillow.astype(np.float32) / 255.0) \
        == (branch == "pillow")


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("dtype, atol", [("float32", 1e-5),
                                         ("bfloat16", 5e-2)])
def test_forward(dtype, atol):
    jmodel, params = jax_params(getattr(jnp, dtype))
    x = np.random.default_rng(1).uniform(0, 1, (B, SIZE, SIZE, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(
        params, x))
    with torch.no_grad():
        got = port_model(params, getattr(torch, dtype))(t(x))
    assert got.dtype == torch.float32 and got.shape == (B, len(CLASSES))
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_bridge_and_init():
    _, params = jax_params()
    sd = classifier_state_dict_from_flax(params)
    model = CropClassifier(len(CLASSES))
    assert sorted(sd) == sorted(model.state_dict())
    assert len(sd) == 62 and all(
        sd[k].shape == tuple(v.shape) for k, v in model.state_dict().items())
    back = classifier_flax_from_state_dict({k: t(v) for k, v in sd.items()})
    assert jax.tree.structure(back) == jax.tree.structure(params)
    want = leaves(params)
    for k, v in leaves(back).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    missing = {k: v for k, v in params.items() if k != "gn_stem"}
    with pytest.raises(KeyError, match="gn_stem/scale"):
        classifier_state_dict_from_flax(missing)
    extra = dict(params, stage2_1=dict(params["stage2_1"],
                                       proj={"kernel": np.zeros(1)}))
    with pytest.raises(KeyError, match="stage2_1/proj/kernel"):
        classifier_state_dict_from_flax(extra)
    # flax's initialisers as distributions: lecun_normal (truncated normal,
    # fan-in) convolutions and head, zero bias, GroupNorm ones and zeros.
    init_classifier(model, torch.Generator().manual_seed(0))
    ours = leaves(classifier_flax_from_state_dict(model.state_dict()))
    for k, w in want.items():
        o = ours[k]
        if k.endswith("['kernel']"):
            fan_in = int(np.prod(w.shape[:-1]))
            for v in (o, w):
                assert abs(v.std() * np.sqrt(fan_in) - 1) < 0.1, k
                assert np.abs(v).max() <= 2 / np.sqrt(fan_in) / 0.8796 + 1e-6
        else:
            np.testing.assert_array_equal(o, w, err_msg=k)


# -- training -----------------------------------------------------------------

class JitRecorder:
    """Stands in for ``jax`` in ``podtpu.train.classify``: every call of
    the jitted ``train_step`` is recorded (its lr, loss and accuracy, the
    signs of its ReLU inputs as ``linen`` recorded them; its parameters
    and optimiser state after the step, pickled to ``root``)."""

    def __init__(self, root, linen):
        self.root, self.linen, self.steps = root, linen, []
        self.relus = None

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        jitted = jax.jit(fn)
        if fn.__name__ != "train_step":
            return jitted

        def call(params, opt_state, images, targets, lr):
            first = self.linen.calls  # the first call traces the step
            out = jitted(params, opt_state, images, targets, lr)
            jax.effects_barrier()
            self.relus = self.relus or range(first, self.linen.calls)
            path = os.path.join(self.root, f"step{len(self.steps)}.pkl")
            with open(path, "wb") as fp:
                pickle.dump(jax.tree.map(np.asarray, jax.device_get(
                    (out[0], adam_state(out[1])))), fp)
            self.steps.append(dict(
                lr=float(lr), loss=float(out[2]), acc=float(out[3]),
                path=path, signs=[self.linen.signs[i].copy()
                                  for i in self.relus]))
            return out

        return call


def adam_state(opt_state):
    """``(count, mu, nu)`` of optax's adamw state."""
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam.count, adam.mu, adam.nu


def load_step(rec):
    with open(rec["path"], "rb") as fp:
        return pickle.load(fp)


def check_params(got, params, adam, name):
    """``got`` against JAX's ``params`` after a step whose Adam state is
    ``adam``: 1e-6 where ``sqrt(v_hat) >= ADAM_FLOOR``, twice the learning
    rate elsewhere; returns the share of entries more than 1e-6 apart."""
    count, _, nu = adam
    v_hat = leaves(nu)
    want, apart, total = leaves(params), 0, 0
    for k, g in leaves(got).items():
        floor = np.sqrt(v_hat[k] / (1 - 0.999 ** int(count))) < ADAM_FLOOR
        diff = np.abs(g - want[k])
        assert diff[~floor].max(initial=0) <= 1e-6, (name, k)
        assert diff[floor].max(initial=0) <= 2 * LR, (name, k)
        apart, total = apart + int((diff > 1e-6).sum()), total + diff.size
    return apart / total


@pytest.fixture(scope="module")
def runs(crops, tmp_path_factory):
    """JAX's ``train_classifier`` (float32, recorded) and the port's from
    JAX's initial parameters, teacher-forced after every step."""
    root = tmp_path_factory.mktemp("classifier_runs")
    mp = pytest.MonkeyPatch()
    linen = RecordingLinen()
    recorder = JitRecorder(str(root), linen)
    mp.setattr(jax_classify, "CropClassifier",
               functools.partial(JaxClassifier, dtype=jnp.float32))
    mp.setattr(jax_classify, "jax", recorder)
    mp.setattr(jax_classifier_module, "nn", linen)
    kw = dict(batch_size=B, image_size=SIZE, max_epochs=EPOCHS,
              alrs_epochs=2, alrs_startup_factor=1, seed=0)
    jax_dir = jax_classify.train_classifier(crops, str(root), "jax", **kw)
    mp.undo()
    _, init = jax_params()

    built, port_steps, logged, flips = [], [], [], []

    class ForcedClassifier(CropClassifier):
        """The port's model whose training forwards take the ReLU signs
        of JAX's step of the same index."""

        def forward(self, x):
            if not torch.is_grad_enabled():
                return super().forward(x)
            mode = forced_relus(recorder.steps[len(flips)]["signs"])
            with mode:
                out = super().forward(x)
            assert mode.calls == len(recorder.relus) == 17
            flips.append(mode.flips)
            return out

    def float32_classifier(num_classes):
        built.append(ForcedClassifier(num_classes, dtype=torch.float32))
        return built[-1]

    class Logger(classify.MetricLogger):
        def update(self, **kwargs):
            logged.append(kwargs)
            super().update(**kwargs)

    real_step = classify.apply_optimizer

    def forced(optimizer, lr):
        k = len(port_steps)
        named = dict(built[0].named_parameters())
        grads = classifier_flax_from_state_dict(
            {n: p.grad.clone() for n, p in named.items()})
        rec = dict(lr=float(lr), grads=grads)
        if k == 0:  # the first update, from JAX's gradients
            mu = leaves(load_step(recorder.steps[0])[1][1])
            rec["update_from_jax_grads"] = update_from(
                init, {key: v / (1 - 0.9) for key, v in mu.items()}, lr)
        real_step(optimizer, lr)
        rec["params"] = classifier_flax_from_state_dict(
            {n: p.detach().clone() for n, p in named.items()})
        port_steps.append(rec)
        if k + 1 < len(recorder.steps):  # force: JAX's state after step k
            params, (count, mu, nu) = load_step(recorder.steps[k])
            sd = classifier_state_dict_from_flax(params)
            m = classifier_state_dict_from_flax(mu)
            v = classifier_state_dict_from_flax(nu)
            with torch.no_grad():
                for n, p in named.items():
                    p.copy_(t(sd[n]))
                    optimizer.state[p] = {
                        "step": torch.tensor(float(count)),
                        "exp_avg": torch.zeros_like(p).copy_(t(m[n])),
                        "exp_avg_sq": torch.zeros_like(p).copy_(t(v[n]))}

    mp.setattr(classify, "CropClassifier", float32_classifier)
    mp.setattr(classify, "MetricLogger", Logger)
    mp.setattr(classify, "apply_optimizer", forced)
    try:
        port_dir = classify.train_classifier(crops, str(root), "port",
                                             device="cpu",
                                             initial_params=init, **kw)
    finally:
        mp.undo()
    return dict(jax_dir=jax_dir, port_dir=port_dir, jax=recorder.steps,
                port=port_steps, logged=logged, init=init, flips=flips)


def update_from(params, grads, lr):
    """The port's first AdamW update of ``params`` from ``grads`` (flax
    trees of numpy arrays, ``grads`` flattened by key path)."""
    model = port_model(params)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=classify.WEIGHT_DECAY)
    sd = classifier_state_dict_from_flax(jax.tree_util.tree_unflatten(
        jax.tree.structure(params), [grads[k] for k in leaves(params)]))
    for n, p in model.named_parameters():
        p.grad = t(sd[n])
    apply_optimizer(opt, lr)
    return classifier_flax_from_state_dict(dict(model.named_parameters()))


def test_one_adamw_step(runs):
    jax_step, port_step = runs["jax"][0], runs["port"][0]
    np.testing.assert_allclose(runs["logged"][0]["loss"], jax_step["loss"],
                               rtol=1e-5)
    params, adam = load_step(jax_step)
    mu = leaves(adam[1])
    for k, g in leaves(port_step["grads"]).items():
        want = mu[k] / (1 - 0.9)
        scale = np.abs(want).max()
        if scale == 0:
            assert np.abs(g).max() == 0, k
            continue
        assert np.abs(g - want).max() <= 2e-3 * scale, k
    want = leaves(params)
    for k, v in leaves(port_step["update_from_jax_grads"]).items():
        np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-6, err_msg=k)
    assert check_params(port_step["params"], params, adam, "step 0") < 1e-4


def test_train_classifier_teacher_forced(runs):
    jax_steps, port_steps, logged = runs["jax"], runs["port"], runs["logged"]
    assert len(jax_steps) == len(port_steps) == len(logged) == 2 * EPOCHS
    assert sum(runs["flips"]) <= 2, runs["flips"]
    for k, (j, p, log) in enumerate(zip(jax_steps, port_steps, logged)):
        assert p["lr"] == j["lr"] == np.float32(LR)
        np.testing.assert_allclose(log["loss"], j["loss"], rtol=1e-5,
                                   err_msg=f"step {k}")
        assert log["acc"] == j["acc"], k
        params, adam = load_step(j)
        assert check_params(p["params"], params, adam, f"step {k}") < 1e-4
    # The model directories: the last step's parameters, labels, json.
    jd, pd = runs["jax_dir"], runs["port_dir"]
    with open(os.path.join(jd, "classifier.json")) as fp:
        jmeta = json.load(fp)
    with open(os.path.join(pd, "classifier.json")) as fp:
        pmeta = json.load(fp)
    assert pmeta == jmeta and jmeta["labels"] == CLASSES
    assert jmeta["image_size"] == SIZE
    with open(os.path.join(jd, "labels.txt")) as a, \
            open(os.path.join(pd, "labels.txt")) as b:
        assert a.read() == b.read()
    with open(os.path.join(pd, "classifier.msgpack"), "rb") as fp:
        saved = msgpack.unpackb(fp.read())
    params, adam = load_step(jax_steps[-1])
    assert jax.tree.structure(saved) == jax.tree.structure(params)
    check_params(saved, params, adam, "saved")
    with open(os.path.join(jd, "classifier.msgpack"), "rb") as fp:
        np.testing.assert_array_equal(
            msgpack.unpackb(fp.read())["head"]["kernel"],
            params["head"]["kernel"])


@pytest.fixture
def float32_classifiers(monkeypatch):
    """Both packages' ``CropClassifier`` in float32, so that labels are
    argmaxes of logits that agree to 1e-5."""
    monkeypatch.setattr(jax_classify, "CropClassifier", functools.partial(
        JaxClassifier, dtype=jnp.float32))
    monkeypatch.setattr(classify, "CropClassifier", functools.partial(
        CropClassifier, dtype=torch.float32))


def test_classify_crops_across_packages(runs, crops, float32_classifiers):
    for model_dir in (runs["jax_dir"], runs["port_dir"]):
        want = jax_classify.classify_crops(crops, model_dir, batch_size=B)
        got = classify.classify_crops(crops, model_dir, batch_size=B,
                                      device="cpu")
        assert got == want and len(got) == 20
        assert set(got.values()) <= set(CLASSES)


def test_entry_points_need_a_device_without_gpu(runs, crops, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        classify.classify_crops(crops, runs["jax_dir"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        classify.train_classifier(crops, max_epochs=1)


# -- the commands -------------------------------------------------------------

def test_train_crop_classifier_dispatch(crops, tmp_path, monkeypatch):
    calls = {"jax": [], "port": []}
    for side, mod in (("jax", jax_classify), ("port", classify)):
        monkeypatch.setattr(mod, "train_classifier",
                            lambda *a, _s=side, **k: calls[_s].append((a, k)))
    argv = ["train-crop-classifier", "-i", crops, "-m", "named",
            "--batch-size", "4", "--image-size", "64", "--max-epochs", "3"]
    result = CliRunner().invoke(jax_cli.cli, argv)
    assert result.exit_code == 0, result.output
    assert port_cli.main(argv, device="cpu") == 0
    port_kw = dict(calls["port"][0][1])
    assert port_kw.pop("device") == "cpu"
    assert calls["jax"] == [(calls["port"][0][0], port_kw)]
    assert port_kw == dict(output_dir="/obj_det/classifiers", name="named",
                           batch_size=4, image_size=64, max_epochs=3,
                           alrs_epochs=10)


def test_cli_train_then_classify(crops, tmp_path, float32_classifiers):
    """The port's ``train-crop-classifier`` at the function's defaults but
    size, batch and one epoch; both CLIs' ``classify-crops`` on its
    directory, to files and to stdout."""
    out = tmp_path / "classifiers"
    assert port_cli.main(["train-crop-classifier", "-i", crops, "-o",
                          str(out), "-m", "cli", "--batch-size", "8",
                          "--image-size", str(SIZE), "--max-epochs", "1"],
                         device="cpu") == 0
    assert sorted(os.listdir(out / "cli")) == [
        "classifier.json", "classifier.msgpack", "labels.txt"]
    argv = ["classify-crops", "-i", crops, "--model-dir", str(out),
            "--model", "cli", "--batch-size", "8"]
    result = CliRunner().invoke(jax_cli.cli, argv + ["-o",
                                                     str(tmp_path / "j")])
    assert result.exit_code == 0, result.output
    assert port_cli.main(argv + ["-o", str(tmp_path / "p")],
                         device="cpu") == 0
    got = json.loads((tmp_path / "p").read_text())
    assert got == json.loads((tmp_path / "j").read_text()) and len(got) == 20
    assert (tmp_path / "p").read_text() == (tmp_path / "j").read_text()
