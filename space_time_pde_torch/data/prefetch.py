"""Host-side batch prefetching.

A copy of ``space_time_pde_tpu/data/prefetch.py`` (framework-free; the
JAX package's ``data/__init__`` imports jax, so the port carries its
own). A background thread keeps a small queue of ready numpy batches
while the device steps: no pickling, no fork, deterministic PRNG
threading (one thread draws in order).

:class:`CountingPrefetcher`, the port's own, also counts its ``gets``,
the ``stalls`` among them (a get that found the queue empty) and
``wait_s``, the seconds blocked in those: always on, the clock read only
on the empty-queue path.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict

import numpy as np

__all__ = ["BatchPrefetcher", "CountingPrefetcher"]


class BatchPrefetcher:
    """Runs ``make_batch()`` in a daemon thread, buffering ``depth``.

    Example::

        pf = BatchPrefetcher(lambda: ds.sample_batch(rng, B), depth=4)
        for _ in range(steps):
            batch = pf.get()
        pf.close()
    """

    def __init__(self, make_batch: Callable[[], Dict[str, np.ndarray]],
                 depth: int = 4):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            while not self._stop.is_set():
                batch = self._make()
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # surfaced on next get()
            self._exc = e

    def get(self) -> Dict[str, np.ndarray]:
        while True:
            if self._exc is not None:
                raise self._exc
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                if not self._thread.is_alive() and self._exc is None:
                    raise RuntimeError("prefetch thread died")

    def close(self):
        self._stop.set()
        # Drain so the worker can exit a blocking put.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class CountingPrefetcher(BatchPrefetcher):
    """A :class:`BatchPrefetcher` that counts its gets, its stalls and the
    seconds it waited in them."""

    def __init__(self, make_batch: Callable[[], Dict[str, np.ndarray]],
                 depth: int = 4):
        self.gets, self.stalls, self.wait_s = 0, 0, 0.0
        super().__init__(make_batch, depth)

    def get(self) -> Dict[str, np.ndarray]:
        self.gets += 1
        if self._exc is None:
            try:
                return self._q.get_nowait()
            except queue.Empty:
                pass
        self.stalls += 1
        t0 = time.perf_counter()
        try:
            return super().get()
        finally:
            self.wait_s += time.perf_counter() - t0
