"""The port's native host library against ``podtpu.core.native`` (CPU).

The port builds its own copy of the C++ source with ``g++`` and
``native/Makefile``'s flags; the JAX package loads its library from
``native/``.  Decoding is held byte for byte (canvases, scales and original
sizes) on JPEG, PNG and TIFF files, 16-bit TIFF included, at canvases that
shrink and that enlarge them; the COCO matcher exactly against the JAX
package's and the port's Python loop.
"""
import numpy as np
import pytest
from PIL import Image

from podtpu.core import native as jax_native
from podtpu_torch.core import native
from podtpu_torch.train import coco_metrics

# (suffix, PIL mode, save options)
FORMATS = [(".jpg", "RGB", {"quality": 90}), (".png", "RGB", {}),
           (".png", "L", {}), (".tif", "RGB", {}),
           (".tif", "RGB", {"compression": "tiff_lzw"}),
           (".tif", "RGB", {"compression": "tiff_deflate"}),
           (".tif", "L", {}), (".tif", "I;16", {})]


def write_images(root, sizes, seed=0):
    """Every format at every size, seeded noise with a smooth ramp (so
    resizing has gradients to interpolate)."""
    rng = np.random.default_rng(seed)
    paths = []
    for h, w in sizes:
        for k, (suffix, mode, kw) in enumerate(FORMATS):
            ramp = np.add.outer(np.linspace(0, 180, h), np.linspace(0, 60, w))
            rgb = (ramp[..., None] + rng.integers(0, 16, (h, w, 3))).astype(
                np.uint8)
            if mode == "I;16":
                im = Image.fromarray((rgb[..., 0].astype(np.uint16) * 257)
                                     + rng.integers(0, 200, (h, w)).astype(
                                         np.uint16))
            else:
                im = Image.fromarray(rgb).convert(mode)
            path = root / f"im_{h}x{w}_{k}{suffix}"
            im.save(path, **kw)
            paths.append(str(path))
    return paths


def test_library_builds():
    assert native.build() == native.LIB_PATH and native.LIB_PATH.exists()
    assert native.available()
    assert jax_native.available(), "the JAX package's library did not load"


@pytest.mark.parametrize("canvas", [(96, 128), (320, 256)])
def test_decode_equals_jax_byte_for_byte(tmp_path, canvas):
    paths = write_images(tmp_path, [(150, 110), (61, 203), (77, 55)])
    got = native.decode_resize_batch(paths, canvas, num_threads=3)
    want = jax_native.decode_resize_batch(paths, canvas, num_threads=3)
    assert got is not None and want is not None
    for g, w, what in zip(got, want, ("canvases", "scales", "sizes")):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        np.testing.assert_array_equal(g, w, err_msg=what)
    canvases, scales, sizes = got
    assert canvases.shape == (len(paths), *canvas, 3)
    assert sorted({tuple(s) for s in sizes}) == [(61, 203), (77, 55),
                                                 (150, 110)]
    assert not np.allclose(scales, 1.0)


def test_failures_give_none(tmp_path, monkeypatch):
    (good,) = write_images(tmp_path, [(40, 30)])[:1]
    bad = tmp_path / "broken.jpg"
    bad.write_bytes(b"not an image")
    for paths in ([str(tmp_path / "missing.png")], [good, str(bad)]):
        assert native.decode_resize_batch(paths, (64, 64)) is None
        assert jax_native.decode_resize_batch(paths, (64, 64)) is None
    assert native.decode_resize_batch([good], (64, 64)) is not None
    monkeypatch.setenv("PODTPU_DISABLE_NATIVE", "1")
    assert native.get_lib() is None and not native.available()
    assert native.decode_resize_batch([good], (64, 64)) is None
    assert native.coco_match(np.ones((1, 1)), np.zeros(1, bool), np.ones(1),
                             coco_metrics.IOU_THRS, (0.0, 1e10)) is None


def python_match(iou, g_ig, area, rng_range, monkeypatch):
    """The port's Python matcher (``COCOEvaluator._match`` with the native
    matcher off), on gts already sorted as ``_match`` sorts them."""
    with monkeypatch.context() as mp:
        mp.setattr(native, "coco_match", lambda *a, **k: None)
        ev = coco_metrics.COCOEvaluator._match(
            iou, np.zeros(len(iou)), area, g_ig, rng_range)
    return ev.dt_matched, ev.dt_ignored


@pytest.mark.parametrize("seed", [0, 1])
def test_coco_match_equals_jax_and_python(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        d, g = int(rng.integers(1, 12)), int(rng.integers(1, 8))
        iou = np.round(rng.uniform(0, 1, (d, g)), 2)  # ties on purpose
        g_ig = rng.uniform(0, 1, g) > 0.7
        order = np.argsort(g_ig, kind="stable")
        iou, g_ig = iou[:, order], g_ig[order]
        area = rng.uniform(10, 5000, d)
        rng_range = (0.0, 1024.0)
        got = native.coco_match(iou, g_ig, area, coco_metrics.IOU_THRS,
                                rng_range)
        want = jax_native.coco_match(iou, g_ig, area, coco_metrics.IOU_THRS,
                                     rng_range)
        loop = python_match(iou, g_ig, area, rng_range, monkeypatch)
        for a, b, c in zip(got, want, loop):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
