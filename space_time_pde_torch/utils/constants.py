"""Tensors made once from host numbers and shared.

A function that builds a constant tensor from host numbers on each call
copies it to the card each time: a synchronous copy, which a CUDA graph
cannot capture (``train/trainer.py::CapturedStep``). The step's modules
take their constants from :func:`device_constant` instead.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["device_constant"]


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, shape: tuple, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False), torch.no_grad():
        return torch.tensor(values, dtype=dtype,
                            device=device).reshape(shape)


def device_constant(values, dtype=None, device="cpu") -> torch.Tensor:
    """``values`` (numbers, a nested list or a numpy array) as a tensor on
    ``device``, made once for each (values, dtype, device) and shared by
    every later call. ``dtype`` defaults to the numpy array's. The
    tensor is shared: never write to it."""
    arr = np.asarray(values)
    if dtype is None:
        dtype = torch.from_numpy(np.ascontiguousarray(arr)).dtype
    return _constant(tuple(arr.ravel().tolist()), arr.shape, dtype,
                     torch.device(device))
