"""Keypoint R-CNN's evaluation, driver, inference and CLI in podtpu_torch
against podtpu (CPU).

* ``keypoint_oks`` and COCO ``keypoints`` stats to 1e-9, gts with no
  visible keypoint among them;
* one ``train(with_keypoints=True)`` epoch of both packages at
  ``tests/conftest.py::tiny_config`` sizes (5 keypoints, a 64-channel
  head, ``keypoint_roi_expand`` 1.3) on ten synthetic JPEGs whose boxes
  carry their centre and four axis extremes (8 train, 2 test images),
  fine-tuned from one model directory the port wrote, the port fed the JAX
  step keys' draws and run in a spawned process beside the JAX run: every
  step's batch and lr equal, the epoch's loss to 1e-4 relative, its
  parameters (the keypoint head's too) to 2e-5 (measured 1.05e-5, the
  spread of the port against itself under a 1e-7 change of its starting
  weights), ``results.txt`` and ``results_keypoints.txt`` to 1e-3;
* the JAX run's model directory in ``evaluate_model`` (bbox and keypoints
  stats to 1e-3), ``infer`` at threshold 0 (the same rectangles: boxes to 1e-3
  px, scores to 1e-4; their keypoints to 1e-3 px and 1e-4 in score where
  the heatmap's peak clears its runner-up by ten times the logits'
  tolerance) and the port's ``DetectionServer`` (``infer``'s boxes, no
  keypoints);
* ``train-object-detector --with-keypoints`` and ``infer-object-detector``
  through the fake CVAT server, the port alone: a keypoint model directory
  with ``results_keypoints.txt``, and each uploaded rectangle followed by
  one "points" shape of its keypoints sharing its group id.

One JAX eval step compile serves the file's JAX entry points.
"""
import copy
import dataclasses
import multiprocessing
import os
import shutil
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

import jax

from podtpu.infer import inference as jax_inference
from podtpu.train import checkpoints as jax_ckpt
from podtpu.train import coco_metrics as jax_coco
from podtpu.train import step as jax_step
from podtpu.train import train as jax_train
from podtpu_torch.core.config import config_from_dict
from podtpu_torch.data.dataset import DetectionDataset
from podtpu_torch.infer import inference
from podtpu_torch.models.detector import init_parameters, make_detector
from podtpu_torch.shared import msgpack
from podtpu_torch.train import checkpoints, coco_metrics
from podtpu_torch.train import train as port_train
from tests.conftest import tiny_config
from tests.synthetic import make_project
from tests.test_torch_driver import draws_from_jax_keys, record
from tests.test_torch_keypoint import port_project
from tests.test_torch_mask import TORCH_THREADS, torch_threads  # noqa: F401

SEED = 0
K = 5
KW = dict(labels=["particle"], batch_size=2, max_epochs=1, alrs_epochs=2,
          alrs_startup_factor=1, seed=SEED, num_workers=2,
          with_keypoints=True, num_keypoints=K)


def jax_config():
    cfg = tiny_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, keypoint_head_channels=64, keypoint_roi_expand=1.3))


@pytest.fixture(autouse=True, scope="module")
def one_jax_eval_step():
    """One jitted JAX eval step per model configuration (each fresh
    ``jax.jit`` would compile it again)."""
    steps = {}

    def make_eval_step(model):
        if model.cfg not in steps:
            steps[model.cfg] = jax_step.make_eval_step(model)
        return steps[model.cfg]

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_inference, "make_eval_step", make_eval_step)
    mp.setattr(jax_train, "make_eval_step", make_eval_step)
    yield
    mp.undo()


# -- OKS and COCO keypoints ---------------------------------------------------

def keypoint_images(rng, n=8, k=K):
    """Per image: gt boxes with keypoints (some gts with none visible, some
    points invisible), detections near them with noisy keypoints."""
    out = []
    for _ in range(n):
        g = int(rng.integers(1, 5))
        d = int(rng.integers(0, 7))
        xy = rng.uniform(0, 200, (g, 2))
        wh = rng.uniform(3, 120, (g, 2))
        gb = np.concatenate([xy, xy + wh], 1)
        gk = np.concatenate([xy[:, None] + rng.uniform(0, 1, (g, k, 2))
                             * wh[:, None], rng.choice(
                                 [0.0, 1.0, 2.0], (g, k, 1))], -1)
        gk[rng.uniform(size=g) < 0.25, :, 2] = 0.0
        src = rng.integers(0, g, d)
        db = gb[src] + rng.normal(0, 4, (d, 4))
        dk = gk[src].copy()
        dk[..., :2] += rng.normal(0, 1, (d, k, 2)) * wh[src][:, None] / 10
        dk[..., 2] = rng.uniform(0, 1, (d, k))
        labels = rng.integers(1, 3, g + d)
        out.append(dict(gt_boxes=gb, gt_labels=labels[:g], dt_boxes=db,
                        dt_labels=labels[g:], dt_scores=rng.uniform(0, 1, d),
                        gt_keypoints=gk, dt_keypoints=dk))
    return out


@pytest.mark.parametrize("k", [K, 17])
def test_keypoint_oks_and_coco_stats(k):
    rng = np.random.default_rng(k)
    images = keypoint_images(rng, k=k)
    for im in images:
        np.testing.assert_array_equal(
            coco_metrics.keypoint_oks(im["dt_keypoints"], im["gt_keypoints"],
                                      im["gt_boxes"]),
            jax_coco.keypoint_oks(im["dt_keypoints"], im["gt_keypoints"],
                                  im["gt_boxes"]))
    assert any((im["gt_keypoints"][..., 2] == 0).all(-1).any()
               for im in images)
    got_ev = coco_metrics.COCOEvaluator(num_classes=2, iou_type="keypoints")
    want_ev = jax_coco.COCOEvaluator(num_classes=2, iou_type="keypoints")
    for im in images:
        got_ev.update(**im)
        want_ev.update(**im)
    got, want = got_ev.summarize(), want_ev.summarize()
    assert max(got) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(coco_metrics.COCO_KP_SIGMAS,
                                  jax_coco.COCO_KP_SIGMAS)
    with pytest.raises(ValueError, match="gt_keypoints"):
        got_ev.update(**dict(images[0], gt_keypoints=None))


# -- one train(with_keypoints=True) epoch -------------------------------------

def port_run(root, project, cfg, pretrained):
    """The port's recorded one-epoch keypoint run, in a spawned process."""
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(TORCH_THREADS)
    rec = {k: [] for k in ("losses", "stats", "steps", "params")}
    mp = pytest.MonkeyPatch()
    try:
        record(mp, rec, port_train, checkpoints, jax_side=False)
        port_dir = port_train.train(project, output_dir=root, name="port",
                                    config=cfg, pretrained=pretrained,
                                    device="cpu",
                                    draws=draws_from_jax_keys(cfg), **KW)
    finally:
        mp.undo()
    # Resumed with its budget spent, the run trains no further epoch and
    # writes its model directory from checkpoint.pt.
    resumed = port_train.train(project, output_dir=root, name="port",
                               config=cfg, pretrained=pretrained,
                               resume=True, device="cpu",
                               **dict(KW, with_keypoints=False))
    return dict(port_dir=port_dir, port=rec,
                resumed=checkpoints.load_model(resumed)[:3])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_keypoint_driver")
    jcfg = jax_config()
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    project = make_project(str(root / "images"), num_images=10,
                           keypoints=True)
    pretrained = str(root / "pretrained")
    model = make_detector(dataclasses.replace(
        cfg.model, num_classes=2, with_keypoints=True, num_keypoints=K))
    init_parameters(model, torch.Generator().manual_seed(7))
    checkpoints.save_model(pretrained, model, model.cfg, ["particle"])
    jax_rec = {k: [] for k in ("losses", "stats", "steps", "params")}
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(1, mp_context=ctx) as pool:
        port = pool.submit(port_run, str(root), port_project(project), cfg,
                           pretrained)
        mp = pytest.MonkeyPatch()
        try:
            record(mp, jax_rec, jax_train, jax_ckpt, jax_side=True)
            jax_dir = jax_train.train(project, output_dir=str(root),
                                      name="jax", config=jcfg,
                                      pretrained=pretrained, **KW)
        finally:
            mp.undo()
        out = port.result(timeout=600)
    yield dict(out, root=root, project=project, jax_dir=jax_dir, jax=jax_rec)
    shutil.rmtree(root, ignore_errors=True)


def read_results(model_dir, name="results.txt"):
    with open(os.path.join(model_dir, name)) as fp:
        return [float(line.rsplit("=", 1)[1]) for line in fp]


class TestTrainEpoch:
    def test_steps_losses_parameters(self, runs):
        got, want = runs["port"], runs["jax"]
        assert len(got["steps"]) == len(want["steps"]) == 4
        for (gi, gw, glr), (wi, ww, wlr) in zip(got["steps"], want["steps"]):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gw, ww.astype(np.float32))
            assert glr == wlr
        assert [e for e, _ in got["losses"]] == [0]
        np.testing.assert_allclose(got["losses"][0][1], want["losses"][0][1],
                                   rtol=1e-4)
        gp, wp = got["params"][0], want["params"][0]
        assert set(gp) == set(wp) and sum("keypoint_" in k for k in wp) == 18
        # 2e-5: the port against itself, its starting weights scaled by
        # 1 + 1e-7, ends this epoch 1.05e-5 apart (backbone layer3.3.conv2),
        # as far as it ends from JAX: each proposal's keypoint targets are
        # binned by a floor, and a 1e-7 change moves a point across a cell.
        for k in wp:
            np.testing.assert_allclose(gp[k], wp[k], rtol=0, atol=2e-5,
                                       err_msg=k)

    def test_resume_restores_the_keypoint_head(self, runs):
        """``checkpoint.pt`` holds the keypoint head and its config: a
        resumed call (without ``with_keypoints``) rebuilds the keypoint
        model and writes the epoch's parameters back, exactly."""
        from podtpu_torch.models.weights import state_dict_from_flax

        params, frozen, mcfg = runs["resumed"]
        assert mcfg.with_keypoints and mcfg.keypoint_roi_expand == 1.3
        got = state_dict_from_flax(params, frozen)
        want = runs["port"]["params"][0]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def test_bbox_and_keypoint_results(self, runs):
        for name in ("results.txt", "results_keypoints.txt"):
            got = read_results(runs["port_dir"], name)
            want = read_results(runs["jax_dir"], name)
            assert len(got) == 12
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        # The port's keypoint model directory loads in the JAX package.
        params, _, jcfg, _ = jax_ckpt.load_model(runs["port_dir"])
        assert jcfg.with_keypoints and jcfg.num_keypoints == K
        assert params["keypoint_head"]["deconv"]["kernel"].shape == \
            (4, 4, 64, K)


def test_evaluate_model(runs):
    test = copy.deepcopy(runs["project"])
    out = runs["root"] / "eval"
    want = jax_train.evaluate_model(test, runs["jax_dir"], batch_size=2,
                                    num_workers=2, output_dir=str(out / "j"))
    got = port_train.evaluate_model(port_project(test), runs["jax_dir"],
                                    batch_size=2, num_workers=2,
                                    output_dir=str(out / "p"), device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    kps = read_results(out / "p", "results_keypoints.txt")
    np.testing.assert_allclose(
        kps, read_results(out / "j", "results_keypoints.txt"), rtol=0,
        atol=1e-3)
    assert len(kps) == 12 and any(v != -1 for v in kps)


def rectangles(project):
    """{image id: [(label, bounds, score, keypoints), ...]}."""
    return {k: [(b.label, b.bounds, b.score, b.keypoints) for b in im.boxes]
            for k, im in project.image_dict.items()}


def peak_margins(model_dir, project):
    """{image id: [D_kept, K] top-two logit margins of each detection kept at
    threshold 0, and the largest logit}: the port's heatmaps of ``infer``'s
    own canvases."""
    _, model, cfg, labels = inference.load_inference_model(model_dir, "cpu")
    ds = DetectionDataset(project, image_size=cfg.image_size,
                          max_gt=cfg.max_gt_boxes, label_names=labels,
                          cache=False)
    out, top = {}, 0.0
    with torch.inference_mode():
        for i, (key, _) in enumerate(project.image_dict.items()):
            x = torch.from_numpy(ds.load(i).image[None])
            det, _ = model(x)
            _, logits = model._keypoint_logits(model.features(x), det.boxes)
            keep = (det.valid & (det.scores > 0))[0]
            flat = logits[0][keep].flatten(2).sort(-1).values
            out[key] = (flat[..., -1] - flat[..., -2]).numpy()
            if keep.any():
                top = max(top, float(logits[0][keep].abs().max()))
    return out, top


@pytest.fixture(scope="module")
def inferred(runs):
    jp = copy.deepcopy(runs["project"])
    for im in jp.image_dict.values():
        im.boxes = []
    port = port_project(jp)
    want = jax_inference.infer(jp, runs["jax_dir"], threshold=0.0,
                               batch_size=2, num_workers=2)
    got = inference.infer(port, runs["jax_dir"], threshold=0.0, batch_size=2,
                          num_workers=2, device="cpu")
    return got, want, peak_margins(runs["jax_dir"], port)


def test_infer_keypoints(inferred):
    got_p, want_p, (margins, top) = inferred
    got, want = rectangles(got_p), rectangles(want_p)
    assert set(got) == set(want)
    tol = 1e-4 * top
    held = total = 0
    for key in want:
        assert [a[0] for a in got[key]] == [a[0] for a in want[key]], key
        assert len(margins[key]) == len(want[key])
        for g, w, m in zip(got[key], want[key], margins[key]):
            np.testing.assert_allclose(g[1], w[1], rtol=0, atol=1e-3)
            np.testing.assert_allclose(g[2], w[2], rtol=0, atol=1e-4)
            gk, wk = np.asarray(g[3]), np.asarray(w[3])
            assert gk.shape == wk.shape == (K, 3)
            clear = m > 10 * tol
            np.testing.assert_allclose(gk[clear, :2], wk[clear, :2], rtol=0,
                                       atol=1e-3)
            np.testing.assert_allclose(gk[clear, 2], wk[clear, 2], rtol=1e-4,
                                       atol=1e-6)
            held += int(clear.sum())
            total += K
    print(f"keypoints held: {held} of {total}")
    assert total >= 5 * K and held >= 0.8 * total


def test_server_drops_keypoints(runs, inferred):
    """The server's entries for an image are ``infer``'s rectangles, with
    no keypoints."""
    from podtpu_torch.data import imageio
    from podtpu_torch.infer.server import DetectionServer

    got, _, _ = inferred
    server = DetectionServer(runs["jax_dir"], batch_size=2, device="cpu")
    try:
        checked = 0
        for meta in list(got.image_dict.values())[:3]:
            out = server.detect_array(imageio.read_rgb(meta.full_path), 0.0)
            dets = out["detections"]
            assert len(dets) == len(meta.boxes)
            for d, ann in zip(dets, meta.boxes):
                assert d["label"] == ann.label
                assert "keypoints" not in d and "polygon" not in d
                np.testing.assert_allclose(d["score"], ann.score, rtol=0,
                                           atol=1e-6)
                checked += 1
        assert checked > 0
    finally:
        server.close()


# -- the CLI ------------------------------------------------------------------

def test_cli_train_with_keypoints_and_points_upload(tmp_path, monkeypatch):
    from PIL import Image

    from podtpu_torch import cli as port_cli
    from podtpu_torch.core import config as port_config
    from tests.fake_cvat import FakeCvatServer, FakeCvatState

    tiny = config_from_dict(dataclasses.asdict(jax_config()))
    monkeypatch.setattr(port_config, "Config", lambda: tiny)
    project = make_project(str(tmp_path / "src"), num_images=6,
                           keypoints=True, seed=4)
    raw = tmp_path / "cvat" / "7" / "raw"
    raw.mkdir(parents=True)
    frames, shapes = [], []
    for i, meta in enumerate(project.image_dict.values()):
        name = f"frame_{i:02d}.png"
        Image.open(meta.full_path).save(raw / name)
        frames.append(name)
        for b in meta.boxes:
            group = len(shapes) + 1
            x1, y1, x2, y2 = b.coords
            shapes.append({"id": len(shapes) + 1, "type": "rectangle",
                           "frame": i, "label_id": 10, "outside": False,
                           "group": group, "points": [x1, y1, x2, y2]})
            shapes.append({"id": len(shapes) + 1, "type": "points",
                           "frame": i, "label_id": 10, "outside": False,
                           "group": group, "points": [
                               v for kp in b.keypoints for v in kp[:2]]})
    labels = [{"id": 10, "name": "particle", "color": "#ff0000"}]
    state = FakeCvatState()
    state.add_task(5, "keypoints", labels, frames, shapes=shapes)
    state.add_task(6, "unlabelled", labels, frames)
    out = tmp_path / "models"
    with FakeCvatServer(state) as srv:
        common = ["--server", srv.url, "--image-root", str(tmp_path / "cvat")]
        port_cli.main(["train-object-detector", "--tasks", "5", *common,
                       "--image-size", "128", "--max-epochs", "1",
                       "--alrs-epochs", "2", "--with-keypoints",
                       "--num-keypoints", str(K), "--keypoint-hflip-inds",
                       "0,2,1,4,3", "--keypoint-roi-expand", "1.3", "-o",
                       str(out), "-m", "kp_model"], device="cpu")
        model_dir = out / "kp_model"
        _, _, mcfg, names = checkpoints.load_model(str(model_dir))
        assert mcfg.with_keypoints and names == ["particle"]
        assert (mcfg.num_keypoints, mcfg.keypoint_hflip_inds,
                mcfg.keypoint_roi_expand, mcfg.keypoint_head_channels) == \
            (K, (0, 2, 1, 4, 3), 1.3, 64)
        assert len(read_results(model_dir, "results_keypoints.txt")) == 12
        before = len(state.patches)
        port_cli.main(["infer-object-detector", "--tasks", "6", *common,
                       "--model-dir", str(out), "--model", "kp_model",
                       "--threshold", "0.0"], device="cpu")
    shutil.rmtree(out)  # a model directory and a checkpoint
    uploads = [p for p in state.patches[before:]
               if "annotations?action=create" in p["path"]]
    assert len(uploads) == 1
    sent = uploads[0]["body"]["shapes"]
    assert sent and {s["type"] for s in sent} == {"rectangle", "points"}
    # Every rectangle's keypoints score above 0 (softmax probabilities): it
    # is followed by one points shape of its K points in its group.
    rects = [i for i, s in enumerate(sent) if s["type"] == "rectangle"]
    assert len(sent) == 2 * len(rects)
    for i in rects:
        r, p = sent[i], sent[i + 1]
        assert p["type"] == "points" and len(p["points"]) == 2 * K
        assert r["group"] == p["group"] > 0
        assert r["label_id"] == p["label_id"] == 10
        assert r["frame"] == p["frame"]
    assert len({sent[i]["group"] for i in rects}) == len(rects)
