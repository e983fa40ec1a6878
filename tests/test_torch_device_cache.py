"""podtpu_torch.data.device_cache against podtpu.data.device_cache (CPU).

Both packages' datasets read the same ``tests/synthetic.make_project``
images (box, polygon and keypoint projects; the box project with one
file removed), and every comparison is exact: the cache's fields, ``ok``
and ``batch``; the device loader's batches, raw and gathered, shuffled
over two epochs, against JAX's and against the port's own ``Loader``; the
byte count and ``fits`` (with the environment's budget); ``epoch_batches``;
``gather_rows`` in both modes; the windowed stream's windows, batches,
lengths and static shapes.
"""
import os

import numpy as np
import pytest
import torch

from podtpu.data import device_cache as jax_cache
from podtpu.data.dataset import DetectionDataset as JaxDataset
from podtpu_torch.data import device_cache as cache_mod
from podtpu_torch.data.dataset import DetectionDataset
from podtpu_torch.data.loader import Loader
from tests.synthetic import make_project
from tests.test_torch_data import port_project as box_port_project
from tests.test_torch_mask import port_project as mask_port_project
from tests.test_torch_mask import torch_threads  # noqa: F401

SIZE = (64, 64)
N = 7


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """``kind -> (port dataset, JAX dataset)`` for "box" (image 2 removed),
    "mask" and "keypoint"."""
    root = tmp_path_factory.mktemp("device_cache")
    out = {}
    for kind, kw in (("box", {}), ("mask", dict(polygons=True)),
                     ("keypoint", dict(keypoints=True))):
        jp = make_project(str(root / kind), num_images=N, max_boxes=3,
                          seed=3, **kw)
        if kind == "box":
            os.remove(list(jp.image_dict.values())[2].full_path)
        pp = (mask_port_project if kind == "mask" else box_port_project)(jp)
        dkw = dict(image_size=SIZE, max_gt=4,
                   with_masks=kind == "mask", mask_stride=4,
                   with_keypoints=kind == "keypoint", num_keypoints=5)
        out[kind] = (DetectionDataset(pp, **dkw), JaxDataset(jp, **dkw))
    return out


def assert_fields_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if torch.is_tensor(got[k]) else np.asarray(got[k])
        w = np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("kind", ["box", "mask", "keypoint"])
def test_cache_fields_ok_and_batch(datasets, kind, capsys):
    pds, jds = datasets[kind]
    got = cache_mod.DeviceDataCache(pds, device="cpu")
    want = jax_cache.DeviceDataCache(jds)
    assert got.n == want.n == N
    np.testing.assert_array_equal(got.ok, want.ok)
    assert got.ok.sum() == (N - 1 if kind == "box" else N)
    assert all(v.device.type == "cpu" for v in got.arrays.values())
    assert_fields_equal(got.arrays, want.arrays)
    idx = np.asarray([3, 1, 3, 6])
    assert_fields_equal(got.batch(idx), want.batch(idx))
    padded = cache_mod.DeviceDataCache(pds, device="cpu", pad_to_multiple=4)
    jpadded = jax_cache.DeviceDataCache(jds, pad_to_multiple=4)
    assert padded.n == jpadded.n == 8
    np.testing.assert_array_equal(padded.ok, jpadded.ok)
    assert_fields_equal(padded.arrays, jpadded.arrays)
    capsys.readouterr()


@pytest.mark.parametrize("raw", [False, True])
def test_device_loader(datasets, raw, capsys):
    """Shuffled over two epochs, 6 of the 7 images at batch 4 (a wrapped
    tail, the removed file masked): JAX's loader and the port's streaming
    Loader give the same batches."""
    pds, jds = datasets["box"]
    indices = np.arange(1, N)
    kw = dict(indices=indices, shuffle=True, seed=4)
    got = cache_mod.DeviceLoader(cache_mod.DeviceDataCache(pds, device="cpu"),
                                 4, raw=raw, **kw)
    want = jax_cache.DeviceLoader(jax_cache.DeviceDataCache(jds), 4, raw=raw,
                                  **kw)
    stream = Loader(pds, 4, num_workers=1, **kw)
    assert len(got) == len(want) == len(stream) == 2
    orders = []
    for epoch in (0, 1):
        for loader in (got, want, stream):
            loader.set_epoch(epoch)
        batches = list(zip(got, want, stream))
        assert len(batches) == 2
        for (gb, gv), (wb, wv), (sb, sv) in batches:
            np.testing.assert_array_equal(gv, wv)
            np.testing.assert_array_equal(gv, sv)
            if raw:
                np.testing.assert_array_equal(gb, wb)
                np.testing.assert_array_equal(gb, sb["index"])
            else:
                assert_fields_equal(gb, wb)
                assert_fields_equal(gb, {k: v for k, v in sb.items()})
        orders.append(np.concatenate([sb["index"]
                                      for _, _, (sb, _) in batches]))
        assert not batches[-1][0][1][-1]  # the wrapped duplicate
    assert not np.array_equal(*orders)
    capsys.readouterr()


@pytest.mark.parametrize("kind", ["box", "mask", "keypoint"])
def test_bytes_and_fits(datasets, kind, monkeypatch):
    pds, jds = datasets[kind]
    args = (N, SIZE, 4, kind == "mask", 4, kind == "keypoint", 5)
    assert cache_mod.dataset_device_bytes(*args) == \
        jax_cache.dataset_device_bytes(*args)
    need = cache_mod.dataset_device_bytes(*args)
    assert cache_mod.fits(pds) and jax_cache.fits(jds)
    for budget in (need - 1, need):
        assert cache_mod.fits(pds, budget) == jax_cache.fits(jds, budget) \
            == (budget >= need)
        monkeypatch.setenv("PODTPU_DEVICE_CACHE_BYTES", str(budget))
        assert cache_mod.fits(pds) == jax_cache.fits(jds) == (budget >= need)
    assert cache_mod.DEFAULT_BUDGET == jax_cache.DEFAULT_BUDGET


@pytest.mark.parametrize("n,b", [(7, 2), (3, 5), (8, 4), (0, 2)])
def test_epoch_batches(n, b):
    rng = np.random.default_rng(n * 10 + b)
    order = rng.permutation(n)
    ok = rng.uniform(size=max(n, 1)) > 0.3
    got = list(cache_mod.epoch_batches(order, b, ok))
    want = list(jax_cache.epoch_batches(order, b, ok))
    assert len(got) == len(want) == -(-n // b)
    for (gi, gv), (wi, wv) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)


def test_gather_rows_take_slice_and_refusal(datasets, capsys):
    pds, jds = datasets["keypoint"]
    arrays = cache_mod.DeviceDataCache(pds, device="cpu").arrays
    jarrays = jax_cache.DeviceDataCache(jds).arrays
    idx = np.asarray([5, 0, 5])
    take = cache_mod.gather_rows(arrays, torch.from_numpy(idx), "take")
    sliced = cache_mod.gather_rows(arrays, torch.from_numpy(idx), "slice")
    assert_fields_equal(take, sliced)
    assert_fields_equal(take, jax_cache.gather_rows(jarrays, idx, "slice"))
    with pytest.raises(ValueError, match="cache_gather"):
        cache_mod.gather_rows(arrays, torch.from_numpy(idx), "gather")
    with pytest.raises(ValueError, match="cache_gather"):
        cache_mod.make_cached_train_step(lambda *a, **k: None, "gather")(
            arrays, idx, np.ones(3, np.float32), 0.1)
    assert_fields_equal(
        cache_mod._stack_samples(pds.load_batch([1, 4])),
        jax_cache._stack_samples(jds.load_batch([1, 4])))
    capsys.readouterr()


def windows(loader):
    """Every ``(idx, valid)`` and, at each, the window's contents."""
    out = []
    for idx, valid in loader:
        out.append((idx, valid, {k: np.asarray(v).copy()
                                 for k, v in loader.arrays.items()}))
    return out


@pytest.mark.parametrize("kind,samples,indices", [
    ("box", 4, np.arange(N)),          # windows of 4: 4 + 3 (padded)
    ("mask", 2, np.arange(1, N)),      # windows of 2 (the batch)
    ("keypoint", 20, np.arange(N)),    # one window larger than the data
    ("box", 4, np.arange(0)),          # no index
])
def test_windowed_stream(datasets, kind, samples, indices, capsys):
    pds, jds = datasets[kind]
    per = cache_mod.dataset_device_bytes(1, SIZE, 4, kind == "mask", 4,
                                         kind == "keypoint", 5)
    budget = 2 * samples * per + 1
    kw = dict(indices=indices, shuffle=True, seed=2, budget_bytes=budget)
    got = cache_mod.WindowedStreamLoader(pds, 2, device="cpu", **kw)
    want = jax_cache.WindowedStreamLoader(jds, 2, **kw)
    assert got.window == want.window == samples
    assert len(got) == len(want)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        g, w = windows(got), windows(want)
        assert len(g) == len(w) == len(got)
        for (gi, gv, ga), (wi, wv, wa) in zip(g, w):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gv, wv)
            assert_fields_equal(ga, wa)
            assert ga["image"].shape == (samples,) + SIZE + (3,)
        assert got.arrays is None and want.arrays is None
    capsys.readouterr()
