"""Synchronised timers.

Counterpart of ``space_time_pde_tpu/utils/timing.py``. PyTorch returns
before the card finishes, so a host clock alone measures the enqueue:
on a CUDA device these record CUDA events around the work and
synchronise on the last one; on the CPU they read the host clock.

- :class:`Timer`: a context manager; ``seconds`` is the host wall time
  up to the synchronise, ``device_seconds`` the CUDA events' elapsed
  time (None on the CPU).
- :func:`throughput`: (seconds per call, last result) of a callable over
  ``iters`` calls after ``warmup``, synchronised after every call.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

__all__ = ["Timer", "throughput"]


def _cuda_device(obj) -> Optional[torch.device]:
    """The first CUDA device among ``obj``'s tensors (a tensor, a device,
    or lists / tuples / dicts of them), else None."""
    if isinstance(obj, torch.device):
        return obj if obj.type == "cuda" else None
    if isinstance(obj, torch.Tensor):
        return obj.device if obj.is_cuda else None
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        for o in obj:
            d = _cuda_device(o)
            if d is not None:
                return d
    return None


class Timer:
    """``with Timer(device) as t: ...`` -> ``t.seconds``,
    ``t.device_seconds``. ``sync_on``: the device, or tensors on it."""

    def __init__(self, sync_on=None):
        self._device = _cuda_device(sync_on)
        self.seconds = 0.0
        self.device_seconds: Optional[float] = None

    def __enter__(self):
        if self._device is not None:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self._device))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._device is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self._device))
            end.synchronize()
            self.device_seconds = self._start.elapsed_time(end) / 1e3
        self.seconds = time.perf_counter() - self._t0
        return False


def throughput(fn: Callable, *args, iters: int = 20, warmup: int = 3):
    """(seconds per call, result) of ``fn(*args)``, each call synchronised
    on its result's CUDA device (host wall time on the CPU)."""
    result = None

    def call():
        out = fn(*args)
        dev = _cuda_device(out)
        if dev is not None:
            torch.cuda.synchronize(dev)
        return out

    for _ in range(warmup):
        result = call()
    t0 = time.perf_counter()
    for _ in range(iters):
        result = call()
    return (time.perf_counter() - t0) / iters, result
