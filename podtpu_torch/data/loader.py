"""Prefetching batch loader: threaded decode, fixed-shape batches.

Counterpart of ``podtpu/data/loader.py``: a thread pool decodes and resizes
(image libraries release the interpreter lock for the heavy work), batches
are assembled into fixed-shape numpy arrays, and a bounded queue keeps
``prefetch`` batches ready so host work overlaps device compute.  A short
epoch wraps around instead of emitting a partial batch; ``batch_valid`` marks
the wrapped duplicates (and samples that failed to decode) so training
weights them 0 and evaluation skips them.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from podtpu_torch.data.dataset import DetectionDataset, collate


def wrap_batch_indices(order: np.ndarray, batch_size: int, b: int):
    """Indices + validity for batch ``b`` of ``order`` with static shapes:
    a short tail wraps around to the front of the epoch and the wrapped
    duplicates are masked False."""
    idx = order[b * batch_size: (b + 1) * batch_size]
    valid = np.ones(len(idx), bool)
    if len(idx) < batch_size:
        extra = order[: batch_size - len(idx)]
        if len(extra) < batch_size - len(idx):  # dataset smaller than batch
            extra = np.resize(order, batch_size - len(idx))
        idx = np.concatenate([idx, extra])
        valid = np.concatenate([valid, np.zeros(batch_size - len(valid),
                                                bool)])
    return idx, valid


class Loader:
    def __init__(
        self,
        dataset: DetectionDataset,
        batch_size: int,
        indices: Optional[np.ndarray] = None,
        shuffle: bool = False,
        seed: int = 0,
        num_workers: int = 4,
        prefetch: int = 2,
        place: Optional[torch.device] = None,
    ):
        """``place``: optional device; when set, the producer thread copies
        each batch there as tensors.  To a GPU it copies from pinned memory
        on a side stream of its own, so the copy can overlap the steps on
        the consumer's stream; the consumer's current stream waits for the
        copy when it takes the batch.  Leave None for consumers that index
        batch fields on the host (evaluation)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.indices = np.asarray(
            indices if indices is not None else np.arange(len(dataset)))
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.place = None if place is None else torch.device(place)
        self._epoch = 0

    def __len__(self) -> int:
        if len(self.indices) == 0:
            return 0
        return -(-len(self.indices) // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _epoch_order(self) -> np.ndarray:
        order = self.indices.copy()
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        return order

    def _to_place(self, batch: dict, stream) -> Tuple[dict, object]:
        """``batch`` copied to ``place``; on a GPU, enqueued on ``stream``
        from pinned memory, with the event that marks the copies' end."""
        if stream is None:
            return {k: torch.from_numpy(v).to(self.place)
                    for k, v in batch.items()}, None
        with torch.cuda.stream(stream):
            out = {k: torch.from_numpy(v).pin_memory().to(
                self.place, non_blocking=True) for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def _take(self, batch, done):
        """Order the consumer's stream after the copy of ``batch``, and
        tell the allocator its tensors are used there."""
        if done is not None:
            current = torch.cuda.current_stream(self.place)
            current.wait_event(done)
            for t in batch.values():
                t.record_stream(current)
        return batch

    def __iter__(self) -> Iterator[Tuple[dict, np.ndarray]]:
        order = self._epoch_order()
        if len(order) == 0:
            return
        bs = self.batch_size
        num_batches = len(self)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure = []
        stream = (torch.cuda.Stream(self.place) if self.place is not None
                  and self.place.type == "cuda" else None)

        def finish(samples, bvalid):
            # Decode failures yield ok=False samples: fold them into the
            # batch mask, like wrap-around duplicates.
            bvalid = bvalid & np.asarray([s.ok for s in samples], bool)
            batch, done = collate(samples), None
            if self.place is not None:
                batch, done = self._to_place(batch, stream)
            return batch, bvalid, done

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    futures = []
                    for b in range(num_batches):
                        idx, bvalid = wrap_batch_indices(order, bs, b)
                        futures.append(
                            (pool.submit(self.dataset.load_batch, idx),
                             bvalid))
                        # Bound the number of in-flight batch jobs.
                        while len(futures) > max(2, self.prefetch):
                            fut, bv = futures.pop(0)
                            out_q.put(finish(fut.result(), bv))
                            if stop.is_set():
                                return
                    for fut, bv in futures:
                        if stop.is_set():
                            return
                        out_q.put(finish(fut.result(), bv))
            except BaseException as exc:  # handed to the consumer below
                failure.append(exc)
            finally:
                out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                batch, bvalid, done = item
                yield self._take(batch, done), bvalid
            if failure:
                raise failure[0]
        finally:
            stop.set()
            # Drain so the producer can exit.
            while thread.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.1)
