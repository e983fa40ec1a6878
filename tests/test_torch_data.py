"""The port's data model, dataset, loader, COCO metrics and LR schedules
against the JAX package's (CPU).

Every comparison is exact (arrays equal, the same text, the same schedule
state) except the COCO stats, which agree to 1e-9.  Both packages decode a
batch with their native C++ decoder (the port's own build of the same
source) and fall back to Pillow and ``fit_resize`` per sample when a batch
holds an unreadable file; both paths read identical canvases.  The Pillow
path is also held alone, with both packages' ``decode_resize_batch``
patched to return None.  The bbox matchers are held the same way: native
in both packages, and the Python loops with both ``coco_match`` patched to
None.
"""
import copy

import numpy as np
import pytest

from podtpu.core import native
from podtpu.data import dataset as jax_dataset
from podtpu.data import loader as jax_loader
from podtpu.data.annotation import PolygonAnnotation as JaxPolygon
from podtpu.data.annotation import RectangleAnnotation as JaxRect
from podtpu.data.image import ImageMetadata as JaxImage
from podtpu.data.project import Project as JaxProject
from podtpu.train import alrs as jax_alrs
from podtpu.train import coco_metrics as jax_coco
from podtpu.train import schedules as jax_schedules
from podtpu.core.config import TrainConfig as JaxTrainConfig
from podtpu_torch.core import native as port_native
from podtpu_torch.core.config import TrainConfig
from podtpu_torch.core.logging import MetricLogger, SmoothedValue
from podtpu_torch.data import (ImageMetadata, PolygonAnnotation, Project,
                               RectangleAnnotation)
from podtpu_torch.data import dataset, loader
from podtpu_torch.shared.utils import now_as_str
from podtpu_torch.train import alrs, coco_metrics, schedules
from tests.synthetic import make_project

LABELS = ["particle", "bubble", "debris"]


def port_project(jp: JaxProject) -> Project:
    """The port's copy of a JAX project (same ids, boxes and task names)."""
    p = Project()
    p.task_names = dict(jp.task_names)
    for label in jp.label_dict.values():
        p.add_label(label.id, label.name, label.colour)
    for im in jp.image_dict.values():
        m = ImageMetadata(im.path, im.container, im.dataset_id, im.frame_id)
        for b in im.boxes:
            m.add_annotation(RectangleAnnotation(b.x, b.y, b.width, b.height,
                                                 b.label, score=b.score,
                                                 keypoints=b.keypoints))
        p.add_image(m)
    return p


@pytest.fixture(scope="module")
def jpeg_project(tmp_path_factory):
    """Eleven synthetic JPEGs in three labels, plus one unreadable file."""
    root = tmp_path_factory.mktemp("torch_data")
    jp = make_project(str(root), num_images=11, labels=LABELS, max_boxes=4,
                      seed=3)
    bad = root / "broken.jpg"
    bad.write_bytes(b"not an image")
    meta = JaxImage("broken.jpg", str(root), dataset_id=1, frame_id=99)
    meta.add_annotation(JaxRect(1, 2, 30, 40, "particle"))
    jp.add_image(meta)
    return jp


def pillow_decode(monkeypatch):
    """Both packages decode per sample through Pillow."""
    for mod in (native, port_native):
        monkeypatch.setattr(mod, "decode_resize_batch", lambda *a, **k: None)


def native_libraries_load():
    probe = (np.ones((1, 1)), np.zeros(1, bool), np.ones(1),
             jax_coco.IOU_THRS, (0.0, 1e10))
    assert native.coco_match(*probe) is not None, "JAX's library"
    assert port_native.coco_match(*probe) is not None, "the port's library"


# -- data model ---------------------------------------------------------------

def _ops(p, image):
    """The same sequence of project operations, recorded."""
    out = [p.label_names, p.label_counts(), p.box_counts(), len(p)]
    p.rename_label("debris", "grit")
    p.update_label_dict()
    out += [p.label_names, sorted(p.labels_in_use())]
    p.remove_annotations_below_threshold(0.5)
    out.append(p.label_counts())
    p.keep_annotations_with_label(["particle", "grit"])
    p.remove_unlabelled_images()
    p.update_label_dict()
    out += [p.label_names, p.summary(), sorted(p.image_dict)]
    other = type(p)()
    other.task_names = {7: "extra"}
    other.add_image(image)
    p.add_project(other)
    out += [sorted(p.task_names.items()), len(p), p.label_names]
    with pytest.raises(KeyError):
        p.add_project(other)
    p.remove_labelled_images()
    out.append(len(p))
    return out


def test_project_operations(jpeg_project):
    jp = copy.deepcopy(jpeg_project)
    for k, im in enumerate(jp.image_dict.values()):
        for j, b in enumerate(im.boxes):
            b.score = ((k * 7 + j * 3) % 10) / 10.0
    pp = port_project(jp)
    jim = JaxImage("x.png", "/data", dataset_id=7, frame_id=1)
    jim.add_annotation(JaxRect(0, 0, 5, 5, "newlabel"))
    pim = ImageMetadata("x.png", "/data", dataset_id=7, frame_id=1)
    pim.add_annotation(RectangleAnnotation(0, 0, 5, 5, "newlabel"))
    assert _ops(pp, pim) == _ops(jp, jim)


def test_image_metadata():
    for cls, rect in ((ImageMetadata, RectangleAnnotation),
                      (JaxImage, JaxRect)):
        im = cls("a/b.jpg", "/data", dataset_id=3, frame_id=4)
        im.add_annotation(rect(1, 2, 3, 4, "x"))
        im.add_annotation(rect(1, 2, 3, 4, "y"))
        assert im.id == "3_4_a/b.jpg" and im.full_path == "/data/a/b.jpg"
        assert sorted(im.labels) == ["x", "y"]
        assert im.has_label("x") and im.has_label(["z", "y"])
        assert not im.has_label("z")
        assert cls.create_id("p", 1, 2) == "1_2_p"
        assert repr(im) == "ImageMetadata('3_4_a/b.jpg', boxes=2)"


def test_annotations():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a, b = rng.uniform(-5, 60, (2, 4))
        a[2:] = np.abs(a[2:]) + 1
        b[2:] = np.abs(b[2:]) + 1
        pa, pb = RectangleAnnotation(*a, "x"), RectangleAnnotation(*b, "y")
        ja, jb = JaxRect(*a, "x"), JaxRect(*b, "y")
        assert pa.iou(pb) == ja.iou(jb)
        assert pa.centre_point_distance(pb, 3) == \
            ja.centre_point_distance(jb, 3)
        for attr in ("bounds", "coords", "coords_int", "bounds_int",
                     "centre", "area"):
            assert getattr(pa, attr) == getattr(ja, attr), attr
        assert pa.to_json() == ja.to_json() and str(pa) == str(ja)
        assert RectangleAnnotation.from_json(pa.to_json()).to_dict() == \
            pa.to_dict()
        assert dict(pa.to_cvat().attrib) == dict(ja.to_cvat().attrib)
        assert dict(pa.to_cvat_sequenced(5).attrib) == \
            dict(ja.to_cvat_sequenced(5).attrib)
        assert RectangleAnnotation.from_cvat(ja.to_cvat()).coords == \
            ja.coords
    xs, ys = [1.0, 9.0, 4.0], [2.0, 3.0, 8.0]
    pp, jpoly = PolygonAnnotation(xs, ys, "p"), JaxPolygon(xs, ys, "p")
    assert pp.to_json() == jpoly.to_json()
    assert pp.to_rectangle().coords == jpoly.to_rectangle().coords
    assert pp.points_str == jpoly.points_str
    assert PolygonAnnotation.from_cvat(jpoly.to_cvat()).to_dict() == \
        pp.to_dict()
    assert pp.iou(RectangleAnnotation(0, 0, 5, 5, "r")) == \
        jpoly.iou(JaxRect(0, 0, 5, 5, "r"))


def test_logging_and_run_names():
    v = SmoothedValue(window=3)
    for x in (4.0, 1.0, 3.0, 2.0):
        v.update(x)
    assert (v.median, v.avg, v.global_avg, v.value) == (2.0, 2.0, 2.5, 2.0)
    log = MetricLogger()
    got = list(log.log_every(range(3), 2, header="h"))
    log.update(loss=1.5)
    assert got == [0, 1, 2] and "loss: 1.5000 (1.5000)" in str(log)
    name = now_as_str()
    assert len(name) == 17 and name[4] == "-" and name[10] == "_"


# -- split, dataset, collate, loader ------------------------------------------

@pytest.mark.parametrize("n,fraction,seed", [(10, 0.2, 1), (11, 0.2, 1),
                                             (3, 0.2, 1), (50, 0.3, 7),
                                             (1, 0.2, 0)])
def test_train_test_split(n, fraction, seed):
    got = dataset.train_test_split(n, fraction, seed)
    want = jax_dataset.train_test_split(n, fraction, seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _assert_samples_equal(got, want):
    for f in ("image", "boxes", "labels", "valid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.scale == want.scale
    assert got.original_size == want.original_size
    assert (got.index, got.ok) == (want.index, want.ok)


def check_dataset_load_and_collate(jpeg_project, capsys):
    kw = dict(image_size=(128, 128), max_gt=3, label_names=LABELS[:2])
    jds = jax_dataset.DetectionDataset(jpeg_project, **kw)
    pds = dataset.DetectionDataset(port_project(jpeg_project), **kw)
    assert len(pds) == len(jds) == 12
    readable = list(range(11))  # one batch: native where the library loads
    got = dataset.collate(pds.load_batch(readable))
    want = jax_dataset.collate(jds.load_batch(readable))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for i in range(len(jds)):
        _assert_samples_equal(pds.load(i), jds.load(i))
    assert not pds.load(11).ok and "broken.jpg" in capsys.readouterr().out
    idx = [11, 0, 5, 5]
    got = dataset.collate(pds.load_batch(idx))
    want = jax_dataset.collate(jds.load_batch(idx))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # Keypoint targets: the boxes of every other image carry three points,
    # the last off the image, the others' none.
    kp_project = copy.deepcopy(jpeg_project)
    for n, im in enumerate(kp_project.image_dict.values()):
        for b in im.boxes if n % 2 == 0 else ():
            b.keypoints = [(b.x + b.width / 2, b.y + b.height / 2, 2.0),
                           (b.x + b.width, b.y, 1.0), (-3.0, b.y, 2.0)]
    kw = dict(kw, with_keypoints=True, num_keypoints=4)
    jds = jax_dataset.DetectionDataset(kp_project, **kw)
    pds = dataset.DetectionDataset(port_project(kp_project), **kw)
    got = dataset.collate(pds.load_batch(idx))
    want = jax_dataset.collate(jds.load_batch(idx))
    assert set(got) == set(want) and got["keypoints"].shape == (4, 3, 4, 3)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    visible = 0
    for i in range(len(jds)):
        np.testing.assert_array_equal(pds.load(i).keypoints,
                                      jds.load(i).keypoints)
        visible += int((pds.load(i).keypoints[..., 2] > 0).sum())
    assert visible > 10
    capsys.readouterr()


def test_dataset_load_and_collate(jpeg_project, capsys):
    native_libraries_load()
    check_dataset_load_and_collate(jpeg_project, capsys)


def check_loader_batches(jpeg_project, shuffle, num_workers):
    kw = dict(image_size=(96, 96), max_gt=5)
    jds = jax_dataset.DetectionDataset(jpeg_project, **kw)
    pds = dataset.DetectionDataset(port_project(jpeg_project), **kw)
    indices = np.arange(1, 12)  # 11 images at batch 4: a wrapped tail
    lkw = dict(indices=indices, shuffle=shuffle, seed=5,
               num_workers=num_workers)
    jl = jax_loader.Loader(jds, 4, **lkw)
    pl = loader.Loader(pds, 4, **lkw)
    assert len(pl) == len(jl) == 3
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        got, want = list(pl), list(jl)
        assert len(got) == len(want) == 3
        for (gb, gv), (wb, wv) in zip(got, want):
            np.testing.assert_array_equal(gv, wv)
            for k in wb:
                np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
        assert not want[-1][1][-1]       # the wrapped duplicate
        broken = [ok for b, bv in want for j, ok in zip(b["index"], bv)
                  if j == 11]
        assert broken and not any(broken)  # the unreadable image
    for i in range(2):
        np.testing.assert_array_equal(
            loader.wrap_batch_indices(np.arange(3), 5, i)[0],
            jax_loader.wrap_batch_indices(np.arange(3), 5, i)[0])


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_batches(jpeg_project, shuffle):
    """Native decode, one producer thread.  With two, the wrapped duplicate
    of an image is decoded natively in one batch and per sample in the
    batch that holds the unreadable file, and whichever thread finishes
    last leaves its sample in the cache, in both packages; the two samples
    differ in the scale's float32 rounding."""
    native_libraries_load()
    check_loader_batches(jpeg_project, shuffle, num_workers=1)


@pytest.mark.parametrize("what", ["dataset", "loader", "loader_shuffled"])
def test_pillow_decode_path(jpeg_project, monkeypatch, capsys, what):
    """The per-sample Pillow path of both packages, alone; the loaders with
    two producer threads."""
    pillow_decode(monkeypatch)
    if what == "dataset":
        check_dataset_load_and_collate(jpeg_project, capsys)
    else:
        check_loader_batches(jpeg_project, shuffle=what == "loader_shuffled",
                             num_workers=2)


def test_native_and_pillow_canvases_differ_little(jpeg_project,
                                                  monkeypatch):
    """The two decode paths of one package: the same sizes, the same scales
    (the native one in float32) and canvases within the 5 levels of the two
    resizes' rounding."""
    pds = dataset.DetectionDataset(port_project(jpeg_project),
                                   image_size=(128, 128), cache=False)
    native_samples = pds.load_batch(range(11))
    pillow_decode(monkeypatch)
    for a, b in zip(native_samples, pds.load_batch(range(11))):
        assert a.original_size == b.original_size
        assert a.scale == np.float32(b.scale)
        assert np.abs(a.image.astype(int) - b.image.astype(int)).max() <= 5


def test_loader_places_batches_and_forwards_errors(jpeg_project):
    import torch

    pds = dataset.DetectionDataset(port_project(jpeg_project),
                                   image_size=(64, 64), max_gt=2)
    batch, bvalid = next(iter(loader.Loader(pds, 2, place="cpu")))
    assert isinstance(batch["image"], torch.Tensor)
    assert batch["image"].shape == (2, 64, 64, 3) and bvalid.all()

    def fail(indices):
        raise OSError("disk gone")

    pds.load_batch = fail
    with pytest.raises(OSError, match="disk gone"):
        list(loader.Loader(pds, 2))


# -- COCO metrics -------------------------------------------------------------

def seeded_detections(seed, n_images=12, classes=3):
    """Per image: gt boxes of all three area ranges, and detections near
    them (matched, shifted, duplicated) and at random, with scores."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_images):
        g = int(rng.integers(0, 9))
        size = np.exp(rng.uniform(np.log(8), np.log(200), (g, 2)))
        xy = rng.uniform(0, 400, (g, 2))
        gt = np.concatenate([xy, xy + size], 1)
        gl = rng.integers(1, classes + 1, g)
        near = gt[rng.integers(0, g, int(rng.integers(0, 2 * g + 1)))] \
            if g else np.zeros((0, 4))
        near = near + rng.normal(0, 0.1, near.shape) * np.tile(
            near[:, 2:] - near[:, :2], 2)
        rnd = rng.uniform(0, 400, (int(rng.integers(0, 6)), 2))
        rnd = np.concatenate([rnd, rnd + rng.uniform(5, 150, rnd.shape)], 1)
        dt = np.concatenate([near, rnd])
        dl = rng.integers(1, classes + 1, len(dt))
        if g:
            dl[: len(near)] = np.where(rng.uniform(size=len(near)) < 0.8,
                                       gl[np.argmin(((near[:, None, :2]
                                                      - gt[None, :, :2]) ** 2)
                                                    .sum(-1), 1)],
                                       dl[: len(near)])
        ds = np.round(rng.uniform(0, 1, len(dt)), 2)  # ties on purpose
        out.append((gt, gl, dt, ds, dl))
    return out


@pytest.mark.parametrize("matcher", ["native", "python"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_evaluator(matcher, seed, monkeypatch):
    if matcher == "python":
        for mod in (native, port_native):
            monkeypatch.setattr(mod, "coco_match", lambda *a, **k: None)
    else:
        native_libraries_load()
    data = seeded_detections(seed)
    jev = jax_coco.COCOEvaluator(num_classes=3)
    pev = coco_metrics.COCOEvaluator(num_classes=3)
    # Two evaluators of alternate images, merged: tied scores are ordered
    # by image, so the merge is held against the JAX merge.
    jhalves = [jax_coco.COCOEvaluator(num_classes=3) for _ in range(2)]
    halves = [coco_metrics.COCOEvaluator(num_classes=3) for _ in range(2)]
    for k, (gt, gl, dt, ds, dl) in enumerate(data):
        for ev in (jev, pev, jhalves[k % 2], halves[k % 2]):
            ev.update(gt, gl, dt, ds, dl)
    want = jev.summarize()
    np.testing.assert_allclose(pev.summarize(), want, rtol=0, atol=1e-9)
    assert pev.summary_text() == jev.summary_text()
    assert pev.per_class_text(LABELS) == jev.per_class_text(LABELS)
    jhalves[0].merge_from(jhalves[1])
    halves[0].merge_from(halves[1])
    np.testing.assert_allclose(halves[0].summarize(),
                               jhalves[0].summarize(), rtol=0, atol=1e-9)
    assert coco_metrics.STAT_NAMES == jax_coco.STAT_NAMES
    a, b = data[0][0], data[0][2]
    np.testing.assert_array_equal(coco_metrics.pairwise_iou(a, b),
                                  jax_coco.pairwise_iou(a, b))


def test_coco_evaluator_refuses_other_iou_types():
    with pytest.raises(ValueError, match="iou_type"):
        coco_metrics.COCOEvaluator(num_classes=2, iou_type="boxes")


# -- LR schedules ---------------------------------------------------------------

def loss_curve(seed, n=60):
    """Falling, then flat and noisy: ALRS drops on the plateau."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return 2.0 * np.exp(-t / 8.0) + 0.3 + rng.normal(0, 0.02, n)


def _trajectory(sched, losses):
    out = []
    for epoch, loss in enumerate(losses):
        if sched.exhausted(epoch):
            out.append(("exhausted", epoch))
            break
        lr = sched.lr_for(epoch)
        stop = sched.step(epoch, float(loss))
        out.append((lr, stop, sched.state_dict()))
        if stop:
            break
    return out


@pytest.mark.parametrize("kind", ["alrs", "multistep", "cosine"])
@pytest.mark.parametrize("seed", [0, 1])
def test_schedules(kind, seed):
    fields = dict(lr_schedule=kind, alrs_epochs=4, alrs_startup_factor=1,
                  alrs_drops=3, epochs=12, lr_steps=(5, 9))
    got_s = schedules.make_scheduler(TrainConfig(**fields), 0.01)
    want_s = jax_schedules.make_scheduler(JaxTrainConfig(**fields), 0.01)
    losses = loss_curve(seed)
    got, want = _trajectory(got_s, losses), _trajectory(want_s, losses)
    assert got == want
    assert got[-1][1] is True          # every schedule stops in 60 epochs
    # A resumed scheduler continues where the straight run was.
    half = len(want) // 2
    fresh = schedules.make_scheduler(TrainConfig(**fields), 0.01)
    fresh.load_state_dict(want[half - 1][2])
    for epoch in range(half, len(want)):
        assert fresh.lr_for(epoch) == want[epoch][0]
        assert fresh.step(epoch, float(losses[epoch])) == want[epoch][1]
    other = "cosine" if kind != "cosine" else "alrs"
    wrong = schedules.make_scheduler(
        TrainConfig(**dict(fields, lr_schedule=other)), 0.01)
    with pytest.raises(ValueError) as got_err:
        wrong.load_state_dict(want[0][2])
    wrong_j = jax_schedules.make_scheduler(
        JaxTrainConfig(**dict(fields, lr_schedule=other)), 0.01)
    with pytest.raises(ValueError) as want_err:
        wrong_j.load_state_dict(want[0][2])
    assert str(got_err.value) == str(want_err.value)


def test_alrs_statistic():
    rng = np.random.default_rng(4)
    for n in (1, 2, 3, 7, 10):
        values = list(rng.normal(size=n))
        assert alrs.slope_probability_less_than(values) == \
            jax_alrs.slope_probability_less_than(values)
    assert alrs.slope_probability_less_than([1.0, 1.0, 1.0]) == 0.0
