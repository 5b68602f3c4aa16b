"""RB2D evaluation windows: the eval path's data step.

The part of ``space_time_pde_tpu/data/dataset.py::RB2DataLoader`` that
the dense-decode eval runs: load an ``.npz`` simulation (``p, b, u, w``
of shape [T, Z, X]) as ``[T, Z, X, 4]``, hold per-channel mean/std, and
build the normalised low-res encoder input of a full-extent window
(optional anti-alias filter on (z, x), then endpoint-aligned linear or
nearest resampling with scipy's ``RegularGridInterpolator``, exactly as
the JAX package does). Host-side numpy/scipy, like the reference; the
port keeps its own copy so that nothing on its path imports the JAX
package. Training crops and point sampling come with slice 2.
``tests/test_torch_data.py`` holds it equal to the JAX loader.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from scipy import ndimage
from scipy.interpolate import RegularGridInterpolator

__all__ = ["RB2EvalData", "CHANNELS", "FILTERS"]

CHANNELS = ("p", "b", "u", "w")
FILTERS = ("none", "gaussian", "uniform", "median", "maximum")


class RB2EvalData:
    """Full-extent eval windows over one or more RB2D npz files
    (comma-separated names concatenate along time)."""

    def __init__(self, data_folder: str = ".",
                 data_filename: str = "rb2d_ra1e6_s42.npz",
                 nt: int = 16, nz: int = 128, nx: int = 128,
                 downsamp_t: int = 4, downsamp_xz: int = 8,
                 normalize_output: bool = True,
                 lres_filter: str = "none", lres_interp: str = "linear"):
        if lres_filter not in FILTERS:
            raise ValueError(f"lres_filter must be one of {FILTERS}")
        if lres_interp not in ("linear", "nearest"):
            raise ValueError("lres_interp must be 'linear' or 'nearest'")
        parts = []
        for name in (s.strip() for s in data_filename.split(",")):
            if not name:
                continue
            with np.load(os.path.join(data_folder, name)) as npz:
                parts.append(np.stack(
                    [np.asarray(npz[c], np.float32) for c in CHANNELS],
                    axis=-1))
        t_min = min(p.shape[0] for p in parts)
        self.data = (parts[0] if len(parts) == 1
                     else np.concatenate(parts, axis=0))
        _, Z, X, _ = self.data.shape
        if nt > t_min or nz > Z or nx > X:
            raise ValueError(f"crop ({nt},{nz},{nx}) larger than data "
                             f"({self.data.shape[0]},{Z},{X})")
        self.nt = nt
        self.downsamp_t, self.downsamp_xz = downsamp_t, downsamp_xz
        self.lres_filter, self.lres_interp = lres_filter, lres_interp
        self.channel_mean = self.data.mean(axis=(0, 1, 2))
        self.channel_std = self.data.std(axis=(0, 1, 2)) + 1e-8
        if not normalize_output:
            self.channel_mean = np.zeros_like(self.channel_mean)
            self.channel_std = np.ones_like(self.channel_std)

    def _filter(self, crop: np.ndarray) -> np.ndarray:
        """Anti-alias filter on the (z, x) axes, per channel & frame."""
        if self.lres_filter == "none":
            return crop
        size = max(self.downsamp_xz // 2 * 2 + 1, 3)
        sigma = self.downsamp_xz / 2.0
        out = np.empty_like(crop)
        for c in range(crop.shape[-1]):
            f = crop[..., c]
            if self.lres_filter == "gaussian":
                out[..., c] = ndimage.gaussian_filter(
                    f, sigma=(0, sigma, sigma))
            elif self.lres_filter == "uniform":
                out[..., c] = ndimage.uniform_filter(f, size=(1, size, size))
            elif self.lres_filter == "median":
                out[..., c] = ndimage.median_filter(f, size=(1, size, size))
            else:
                out[..., c] = ndimage.maximum_filter(f, size=(1, size, size))
        return out

    def full_lres_sequence(self, t0: int = 0,
                           nt: Optional[int] = None) -> np.ndarray:
        """Normalised low-res input ``[nt_l, nz_l, nx_l, 4]`` of the
        full-extent window ``[t0, t0 + nt)``."""
        nt = nt or self.nt
        crop = self._filter(self.data[t0:t0 + nt])
        _, nz, nx, _ = crop.shape
        shape_l = (max(2, nt // self.downsamp_t),
                   max(2, nz // self.downsamp_xz),
                   max(2, nx // self.downsamp_xz))
        interp = RegularGridInterpolator(
            (np.arange(nt), np.arange(nz), np.arange(nx)), crop,
            method=self.lres_interp)
        axes = [np.linspace(0, n - 1, m)
                for n, m in zip((nt, nz, nx), shape_l)]
        pts = np.stack(np.meshgrid(*axes, indexing="ij"),
                       axis=-1).reshape(-1, 3)
        lres = interp(pts).reshape(*shape_l, -1).astype(np.float32)
        return (lres - self.channel_mean) / self.channel_std
