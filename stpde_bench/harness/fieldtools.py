"""What every field generator shares: the host copy of a field made on
the device, its channel statistics, the table of valid start frames of
a crop, and a window's own normalisation."""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np
import torch


def host_field(chunks: Iterable[torch.Tensor], shape, channels: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Copy the device chunks ``[frames, *grid, C]`` (in order) into one
    host array of ``shape``; returns it with the channel mean and
    standard deviation (+ 1e-8) over all of it, summed in float64 on the
    device."""
    out = np.empty(shape, np.float32)
    s1 = s2 = None
    n = 0
    t = 0
    for chunk in chunks:
        flat = chunk.reshape(-1, channels).double()
        s1 = flat.sum(0) if s1 is None else s1 + flat.sum(0)
        s2 = (flat * flat).sum(0) if s2 is None else s2 + (flat * flat).sum(0)
        n += flat.shape[0]
        out[t:t + chunk.shape[0]] = chunk.cpu().numpy()
        t += chunk.shape[0]
    mean = s1 / n
    std = torch.sqrt(torch.clamp(s2 / n - mean * mean, min=0.0))
    return (out, mean.float().cpu().numpy(),
            (std + 1e-8).float().cpu().numpy())


def valid_starts(sims: int, frames: int, crop_t: int) -> np.ndarray:
    """Start frames of crops that stay inside one simulation."""
    return np.concatenate([np.arange(s * frames, s * frames + frames
                                     - crop_t + 1)
                           for s in range(sims)]).astype(np.int64)


def normalised(window: torch.Tensor) -> np.ndarray:
    """``[*grid, C]`` by its own channel mean and deviation, f32."""
    flat = window.reshape(-1, window.shape[-1]).double()
    out = (window.double() - flat.mean(0)) / (flat.std(0, unbiased=False)
                                              + 1e-8)
    return out.float().numpy()


def lattice_nodes(crop, lres, spacing, offset=None):
    """The physical coordinates of a crop's low-res lattice, one vector
    an axis (endpoints on the crop's first and last node)."""
    offset = offset or [0.0] * len(crop)
    return [torch.linspace(0, c - 1, n, dtype=torch.float64) * s + o
            for c, n, s, o in zip(crop, lres, spacing, offset)]


def chunked(make: Callable[[int, int], torch.Tensor], total: int,
            step: int):
    for a in range(0, total, step):
        yield make(a, min(total, a + step))
