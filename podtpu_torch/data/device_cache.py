"""Device-resident training data: the dataset in GPU memory, batches gathered
on the device, K training steps replayed as one CUDA graph.

Counterpart of ``podtpu/data/device_cache.py`` (its single-device part).
miso-scale datasets (tens to hundreds of annotated micrographs) fit in the
card's memory: a 1024x1024 uint8 canvas is 3 MB, so 300 images take under
1 GB.  :class:`DeviceDataCache` copies every field to the device once, one
copy a field; each step then gathers its batch there (:func:`gather_rows`)
from a ``[B]`` index vector.  :func:`fits` gates on a byte budget (2 GiB, or
``$PODTPU_DEVICE_CACHE_BYTES``); a dataset past it streams through
:class:`WindowedStreamLoader`, whose windows are copied on a side stream
while the steps gather from the window before.

:func:`make_cached_multi_step` is the JAX package's K steps in one dispatch
(``lax.scan``).  On the GPU its first full group runs as K eager steps
(which also builds the optimiser's state and the kernels' lazy settings);
the second is captured as one ``torch.cuda.CUDAGraph`` over K steps, and
it and every later group are replays of that graph.  The graph reads its
indices, image weights, learning rates and random draws from static
buffers that are refreshed before each replay, and the dataset from the
cache's own tensors.  On the CPU a group is a loop of K cached steps.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from podtpu_torch.data.loader import wrap_batch_indices
from podtpu_torch.infer.inference import resolve_device
from podtpu_torch.ops import _build


DEFAULT_BUDGET = 2 << 30


def _budget(budget: Optional[int]) -> int:
    return budget if budget is not None else \
        int(os.environ.get("PODTPU_DEVICE_CACHE_BYTES", DEFAULT_BUDGET))


def dataset_device_bytes(n: int, image_size, max_gt: int,
                         with_masks: bool = False,
                         mask_stride: int = 8,
                         with_keypoints: bool = False,
                         num_keypoints: int = 17) -> int:
    ch, cw = image_size
    per = ch * cw * 3 + max_gt * (4 * 4 + 4 + 1) + 16
    if with_masks:
        per += max_gt * (ch // mask_stride) * (cw // mask_stride) * 4
    if with_keypoints:
        per += max_gt * num_keypoints * 3 * 4
    return n * per


def _sample_bytes(dataset, n: int) -> int:
    return dataset_device_bytes(
        n, dataset.image_size, dataset.max_gt, dataset.with_masks,
        dataset.mask_stride, getattr(dataset, "with_keypoints", False),
        getattr(dataset, "num_keypoints", 17))


def fits(dataset, budget: Optional[int] = None) -> bool:
    return _sample_bytes(dataset, len(dataset)) <= _budget(budget)


def _record(s) -> Dict[str, np.ndarray]:
    """One sample's fields, as :class:`DeviceDataCache` stores them."""
    rec = {
        "image": s.image,
        "boxes": s.boxes,
        "labels": s.labels,
        "valid": s.valid,
        "scale": np.float32(s.scale),
        "original_size": np.asarray(s.original_size, np.int32),
        "index": np.int32(s.index),
    }
    if s.masks is not None:
        rec["masks"] = s.masks
    if s.keypoints is not None:
        rec["keypoints"] = s.keypoints
    return rec


class DeviceDataCache:
    """All samples of a :class:`DetectionDataset`, stacked and held on one
    device, one tensor a field.  ``batch(idx)`` returns the standard batch
    dict gathered there (no image crosses from the host).

    ``ok``: host-side bool array marking samples that decoded successfully;
    the caller folds it into ``batch_valid`` as the streaming loader does.
    """

    def __init__(self, dataset, device=None, decode_batch: int = 16,
                 pad_to_multiple: int = 1):
        """``device``: the GPU when None (raises when there is none).
        ``pad_to_multiple``: pad the sample axis to a multiple (pad slots
        repeat sample 0 with ``ok=False``, so they never contribute)."""
        self.device = resolve_device(device)
        n = len(dataset)
        pad = (-n) % max(1, pad_to_multiple)
        fields: Dict[str, list] = {}
        ok = np.ones((n + pad,), bool)
        ok[n:] = False
        for start in range(0, n, decode_batch):
            idx = list(range(start, min(start + decode_batch, n)))
            for s in dataset.load_batch(idx):
                ok[s.index] = s.ok
                for k, v in _record(s).items():
                    fields.setdefault(k, [None] * (n + pad))[s.index] = v
        for k, v in fields.items():
            for j in range(n, n + pad):
                v[j] = v[0]
        self.ok = ok
        self.n = n + pad
        # One copy a field: the dataset crosses to the device once.
        self.arrays = {k: torch.from_numpy(np.stack(v)).to(self.device)
                       for k, v in fields.items()}

    def batch(self, idx) -> Dict[str, torch.Tensor]:
        """Batch dict for ``idx`` ([B] int array), gathered on the device."""
        return gather_rows(self.arrays,
                           to_device(idx, self.device, torch.int64))


def gather_rows(arrays: Dict[str, torch.Tensor], idx: torch.Tensor,
                mode: str = "take") -> Dict[str, torch.Tensor]:
    """A batch: every cache field's rows at the ``[B]`` int64 index vector
    ``idx`` (on the fields' device), one ``index_select`` a field.
    ``mode`` is ``TrainConfig.cache_gather``.  The JAX package's
    ``"slice"`` reads the B rows as dynamic slices, its way round backends
    where a gather lowers poorly; the bytes are those of ``"take"``, and a
    CUDA gather is one kernel a field, so both gather the same way here.
    Any other mode raises ``ValueError``."""
    if mode not in ("take", "slice"):
        raise ValueError(f"cache_gather must be 'take'|'slice', got {mode!r}")
    return {k: v.index_select(0, idx) for k, v in arrays.items()}


def _host(x, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    """Host values ``x`` as a ``dtype`` tensor, pinned if ``pin``: a copy
    from pageable memory to a GPU would wait for the stream's earlier
    work."""
    t = torch.as_tensor(np.asarray(x), dtype=dtype)
    return t.pin_memory() if pin else t


def to_device(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``x`` (numpy or tensor) as a ``dtype`` tensor on ``dev``; host
    values go to a GPU from pinned memory."""
    if torch.is_tensor(x):
        return x.to(dev, dtype, non_blocking=True)
    return _host(x, dtype, dev.type == "cuda").to(dev, non_blocking=True)


def make_cached_train_step(train_step, gather: str = "take"):
    """``step(arrays, idx, image_weight, lr, generator=None, draws=None)``:
    the batch gathered from ``arrays`` (the cache's, or a stream window's)
    at ``idx`` ([B]), with ``image_weight`` ([B]), handed to ``train_step``
    (:func:`podtpu_torch.train.step.make_train_step`'s) with ``lr`` and the
    draws; returns its metrics."""

    def step(arrays, idx, image_weight, lr, generator=None, draws=None):
        dev = next(iter(arrays.values())).device
        batch = gather_rows(arrays, to_device(idx, dev, torch.int64),
                            gather)
        batch["image_weight"] = to_device(image_weight, dev,
                                          torch.float32)
        return train_step(batch, lr, generator=generator, draws=draws)

    return step


def _leaves(x) -> List[torch.Tensor]:
    """The tensors of a nest of NamedTuples (``TrainDraws``), in order."""
    if isinstance(x, tuple):
        return [t for v in x for t in _leaves(v)]
    return [] if x is None else [x]


def _clone(x):
    if isinstance(x, tuple):
        return type(x)(*(_clone(v) for v in x))
    return None if x is None else x.clone()


class CachedMultiStep:
    """K cached steps per call: ``(arrays, idx [K, B], image_weight
    [K, B], lrs [K], draws) -> metrics``, each metric stacked along a
    leading ``[K]`` axis; ``draws`` holds each step's ``TrainDraws``.
    The math is that of K consecutive calls of the single cached step.

    On the GPU the first call runs the K steps eagerly on a side stream
    (the warm-up before a capture); the second captures them as one CUDA
    graph over static input buffers and replays it; later calls copy their
    inputs into those buffers and replay.  ``arrays`` must be the same
    tensors on every call (the cache's).  A capture counts the kernels'
    launches without running them; each replay adds that count again
    (``podtpu_torch.ops._build``).  ``captures``, ``replays`` and
    ``capture_s`` say what happened."""

    def __init__(self, train_step, k: int, gather: str = "take"):
        self.k = k
        self.step = make_cached_train_step(train_step, gather)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.calls = 0
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self.launches_per_replay: Dict[str, int] = {}

    def _eager(self, arrays, idx, image_weight, lrs, draws):
        return [self.step(arrays, idx[j], image_weight[j], lrs[j],
                          draws=draws[j]) for j in range(self.k)]

    @staticmethod
    def _stacked(outs) -> Dict[str, torch.Tensor]:
        return {key: torch.stack([m[key] for m in outs]) for key in outs[0]}

    def __call__(self, arrays, idx, image_weight, lrs, draws):
        if len(draws) != self.k or len(idx) != self.k:
            raise ValueError(f"a group holds {self.k} steps")
        dev = next(iter(arrays.values())).device
        self.calls += 1
        if dev.type != "cuda":
            lrs = to_device(lrs, dev, torch.float32)
            return self._stacked(self._eager(arrays, idx, image_weight, lrs,
                                             draws))
        if self.calls == 1:
            lrs = to_device(lrs, dev, torch.float32)
            current = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                out = self._stacked(self._eager(arrays, idx, image_weight,
                                                lrs, draws))
            current.wait_stream(side)
            for t in out.values():
                t.record_stream(current)
            return out
        if self.graph is None:
            self._capture(arrays, idx, image_weight, lrs, draws)
        else:
            if arrays is not self._arrays:
                raise ValueError("a captured group reads the arrays it was "
                                 "captured with")
            self._fill(idx, image_weight, lrs, draws)
        self.graph.replay()
        self.replays += 1
        _build.add_launches(self.launches_per_replay)
        return {key: v.clone() for key, v in self._out.items()}

    def _fill(self, idx, image_weight, lrs, draws) -> None:
        """The group's inputs into the static buffers, after the previous
        replay in stream order (pinned copies: the host does not wait)."""
        for buf, x in ((self._idx, idx), (self._w, image_weight),
                       (self._lrs, lrs)):
            buf.copy_(x if torch.is_tensor(x) else _host(x, buf.dtype, True),
                      non_blocking=True)
        for bufs, d in zip(self._draws, draws):
            for buf, t in zip(_leaves(bufs), _leaves(d)):
                buf.copy_(t, non_blocking=True)

    def _capture(self, arrays, idx, image_weight, lrs, draws) -> None:
        dev = next(iter(arrays.values())).device
        t0 = time.perf_counter()
        self._arrays = arrays
        self._idx = to_device(idx, dev, torch.int64)
        self._w = to_device(image_weight, dev, torch.float32)
        self._lrs = to_device(lrs, dev, torch.float32)
        self._draws = [_clone(d) for d in draws]
        graph = torch.cuda.CUDAGraph()
        with _build.captured_launches() as counted:
            with torch.cuda.graph(graph):
                self._out = self._stacked(
                    self._eager(arrays, self._idx, self._w, self._lrs,
                                self._draws))
        torch.cuda.synchronize(dev)
        self.graph = graph
        self.launches_per_replay = dict(counted)
        self.captures += 1
        self.capture_s = time.perf_counter() - t0


def make_cached_multi_step(train_step, k: int,
                           gather: str = "take") -> CachedMultiStep:
    """K cached train steps per call (:class:`CachedMultiStep`): on the
    GPU, one CUDA graph replay per full group after the first.  Kept at the
    JAX package's name, the one ``train()`` calls."""
    return CachedMultiStep(train_step, k, gather)


class DeviceLoader:
    """Drop-in for :class:`podtpu_torch.data.loader.Loader` backed by a
    :class:`DeviceDataCache`: the same ``(batch, batch_valid)`` iteration,
    ``set_epoch`` shuffling and wrap-around static shapes, but batches are
    gathers on the device."""

    def __init__(self, cache: DeviceDataCache, batch_size: int,
                 indices: Optional[np.ndarray] = None, shuffle: bool = False,
                 seed: int = 0, raw: bool = False):
        """``raw``: yield ``(idx [B] int array, batch_valid)`` instead of
        assembled batches, for :func:`make_cached_train_step`, which
        gathers inside the step."""
        self.cache = cache
        self.raw = raw
        self.batch_size = batch_size
        self.indices = np.asarray(
            indices if indices is not None else np.arange(cache.n))
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        if len(self.indices) == 0:
            return 0
        return -(-len(self.indices) // self.batch_size)

    def __iter__(self):
        order = self.indices.copy()
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        for idx, bvalid in epoch_batches(order, self.batch_size,
                                         self.cache.ok):
            yield (idx if self.raw else self.cache.batch(idx)), bvalid


def make_uploader(device):
    """``upload(host) -> (arrays, done)``: a window's stacked host fields
    copied to ``device``.  To a GPU the copies go from pinned memory on a
    side stream of their own, so they overlap the steps on the consumer's
    stream; ``done`` is the event that marks their end, which the consumer
    waits on before it reads the window.  On the CPU ``done`` is None."""
    device = torch.device(device)
    if device.type != "cuda":
        return lambda host: ({k: torch.from_numpy(v).to(device)
                              for k, v in host.items()}, None)
    stream = torch.cuda.Stream(device)

    def upload(host):
        with torch.cuda.stream(stream):
            arrays = {k: torch.from_numpy(v).pin_memory().to(
                device, non_blocking=True) for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return arrays, done

    return upload


def _stack_samples(samples) -> Dict[str, np.ndarray]:
    """Stack a list of :class:`Sample` into the field dict the cached steps
    consume (the fields of :class:`DeviceDataCache`)."""
    fields: Dict[str, list] = {}
    for s in samples:
        for k, v in _record(s).items():
            fields.setdefault(k, []).append(v)
    return {k: np.stack(v) for k, v in fields.items()}


class WindowedStreamLoader:
    """Streaming path for datasets past the device budget: the epoch is cut
    into fixed-size WINDOWS of samples; while the steps gather batches from
    the resident window, a thread decodes the next window and copies it to
    the device on a side stream (double buffering).  Each buffer takes half
    the budget, so the per-step host-to-device traffic becomes one bulk copy
    a window that overlaps ``window / batch`` steps.

    Iteration yields ``(local_idx [B] into .arrays, batch_valid [B])`` and
    sets ``self.arrays`` to the current window's tensors before the first
    yield of each window (the consumer's stream then waits for their copy);
    consumers pass ``loader.arrays`` to :func:`make_cached_train_step` each
    step.  Every window has the same shapes (a short last window is padded
    with copies of its first sample, never yielded).
    """

    def __init__(self, dataset, batch_size: int,
                 indices: Optional[np.ndarray] = None, shuffle: bool = False,
                 seed: int = 0, device=None,
                 budget_bytes: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.indices = np.asarray(
            indices if indices is not None else np.arange(len(dataset)))
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        per = _sample_bytes(dataset, 1)
        # Two live buffers: each window gets half the budget.
        self.window = max(batch_size,
                          (_budget(budget_bytes) // 2) // max(per, 1))
        self.arrays: Optional[Dict[str, torch.Tensor]] = None
        self._uploader = None

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.indices)
        if n == 0:
            return 0
        full, rem = divmod(n, self.window)
        per_window = -(-self.window // self.batch_size)
        return full * per_window + (-(-rem // self.batch_size) if rem else 0)

    def _stage(self, chunk: np.ndarray):
        """Decode ``chunk``, pad it to the window and start its copy to the
        device; runs on the staging thread."""
        samples = self.dataset.load_batch([int(i) for i in chunk])
        ok = np.array([s.ok for s in samples], bool)
        pad = self.window - len(samples)
        if pad:
            samples = samples + [samples[0]] * pad
        if self._uploader is None:
            self._uploader = make_uploader(self.device)
        arrays, done = self._uploader(_stack_samples(samples))
        return arrays, done, ok

    def _take(self, arrays, done):
        """Order the consumer's stream after the window's copy, and tell the
        allocator its tensors are used there."""
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            for t in arrays.values():
                t.record_stream(current)
        return arrays

    def __iter__(self):
        from concurrent.futures import ThreadPoolExecutor

        order = self.indices.copy()
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        chunks = [order[i:i + self.window]
                  for i in range(0, len(order), self.window)]
        if not chunks:
            return
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(self._stage, chunks[0])
            try:
                for ci, chunk in enumerate(chunks):
                    arrays, done, ok = fut.result()
                    # Swap before staging the next window: the old window's
                    # tensors are then held only by the steps in flight, so
                    # at most two windows occupy the device.
                    self.arrays = self._take(arrays, done)
                    del arrays
                    if ci + 1 < len(chunks):
                        fut = pool.submit(self._stage, chunks[ci + 1])
                    for idx, valid in epoch_batches(
                            np.arange(len(chunk)), self.batch_size, ok):
                        yield idx, valid
            finally:
                # The last window is not held through evaluation.
                self.arrays = None


def epoch_batches(order: np.ndarray, batch_size: int, ok: np.ndarray):
    """Yield ``(idx [B], batch_valid [B])`` pairs covering ``order`` with
    static shapes: short tails wrap around (mask False), decode failures
    mask False, the streaming Loader's contract."""
    num_batches = -(-len(order) // batch_size)
    for b in range(num_batches):
        idx, valid = wrap_batch_indices(order, batch_size, b)
        yield idx, valid & ok[idx]
