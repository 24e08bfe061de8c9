"""Data loading: per-input loaders, a prefetching batch iterator, and
look-ahead device placement.

Counterpart of ``flexflow_tpu/dataloader.py`` on one device (no mesh
branch).  Three stages feed ``FFModel.fit``: :class:`BatchIterator`
assembles batch i+1.. on a producer thread (numpy row gathers) while
step i runs; :class:`DevicePrefetcher` places up to ``depth`` batches
ahead through the executor's pinned, non-blocking copy; the step runs.

The shuffle is numpy's, as in the JAX package's ``SingleDataLoader``:
each loader draws from its own ``np.random.default_rng(seed)`` and
shuffles its order in place at every ``reset()``, so loaders given the
same seed keep their rows aligned, and an epoch's order equals the JAX
loader's for the same ``(seed, epoch)``.  (The JAX ``fit`` takes its
native C++ loader, ``native/ffdl.cc``, when ``g++`` can build it; that
loader shuffles with its own generator.  The native loader is not
ported, ROADMAP.md queue A item 3.)
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Callable, Sequence

import numpy as np

__all__ = ["SingleDataLoader", "BatchIterator", "DevicePrefetcher"]


class SingleDataLoader:
    """One loader per model input (and one for the labels); batches are
    host numpy arrays, a trailing partial batch is dropped."""

    def __init__(self, data: np.ndarray, batch_size: int, shuffle: bool = False,
                 seed: int = 0) -> None:
        self.data = np.asarray(data)
        self.batch_size = int(batch_size)
        self.num_samples = self.data.shape[0]
        self.shuffle = bool(shuffle)
        self._rng = np.random.default_rng(seed)
        self._order = np.arange(self.num_samples)

    @property
    def num_batches(self) -> int:
        return self.num_samples // self.batch_size

    def reset(self) -> None:
        """A new epoch: reshuffle the order when shuffling."""
        if self.shuffle:
            self._rng.shuffle(self._order)

    def next_batch(self, idx: int) -> np.ndarray:
        sel = self._order[idx * self.batch_size:(idx + 1) * self.batch_size]
        return self.data[sel]


class BatchIterator:
    """Zips loaders (inputs, then labels) into per-step tuples.  With
    ``prefetch_depth > 0`` a producer thread assembles batches into a
    bounded queue in the same index order; leaving the loop early stops
    and joins the thread."""

    def __init__(self, loaders: Sequence[SingleDataLoader], prefetch_depth: int = 0) -> None:
        if not loaders:
            raise ValueError("BatchIterator needs at least one loader")
        self.loaders = list(loaders)
        self.prefetch_depth = int(prefetch_depth)
        counts = {l.num_batches for l in self.loaders}
        if len(counts) != 1:
            raise ValueError(f"loaders disagree on the batch count: {sorted(counts)}")
        self.num_batches = counts.pop()

    def reset(self) -> None:
        for l in self.loaders:
            l.reset()

    def __iter__(self):
        if self.prefetch_depth <= 0:
            for i in range(self.num_batches):
                yield tuple(l.next_batch(i) for l in self.loaders)
            return
        yield from self._iter_prefetched()

    def _iter_prefetched(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()
        done = object()
        failed = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                for i in range(self.num_batches):
                    if not put(tuple(l.next_batch(i) for l in self.loaders)):
                        return
            except BaseException as e:  # re-raised in the consumer
                failed.append(e)
            put(done)

        t = threading.Thread(target=produce, daemon=True, name="ffdl-py-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    if failed:
                        raise failed[0]
                    break
                yield item
        finally:
            stop.set()
            try:  # unblock a producer waiting on a full queue
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)


class DevicePrefetcher:
    """Applies ``place_fn`` (``Executor.place_batch``) to up to ``depth``
    batches ahead of the one the consumer is stepping on, so each
    host-to-device copy is queued before the step that needs it."""

    def __init__(self, it: Any, place_fn: Callable[[Any], Any], depth: int = 2) -> None:
        self.it = it
        self.place_fn = place_fn
        self.depth = max(1, int(depth))

    def __iter__(self):
        staged: collections.deque = collections.deque()
        for batch in self.it:
            staged.append(self.place_fn(batch))
            if len(staged) >= self.depth:
                yield staged.popleft()
        while staged:
            yield staged.popleft()
