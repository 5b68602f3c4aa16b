"""RB2D evaluation windows: the eval path's data step.

The part of ``space_time_pde_tpu/data/dataset.py::RB2DataLoader`` that
the dense-decode eval runs: load an ``.npz`` simulation (``p, b, u, w``
of shape [T, Z, X]) as ``[T, Z, X, 4]``, hold per-channel mean/std, and
build the normalised low-res encoder input of a full-extent window
(optional anti-alias filter on (z, x), then endpoint-aligned linear or
nearest resampling with scipy's ``RegularGridInterpolator``, exactly as
the JAX package does). Host-side numpy/scipy, like the reference; the
port keeps its own copy so that nothing on its path imports the JAX
package. ``tests/test_torch_data.py`` holds it equal to the JAX loader.

:class:`RB2DataLoader` is a copy of the JAX loader's training half
(``space_time_pde_tpu/data/dataset.py``): random space-time crops, the
endpoint-aligned low-res lattice, uniform query points with their
trilinear ground truth, per-channel stats (std + 1e-8), and the
multi-file ``valid_t0`` guard, all vectorised numpy
(``sample_batch`` / ``batch_from_origins``). The per-item scipy oracle
of the JAX loader stays there. ``tests/test_torch_device_pipeline.py``
holds the copy equal to the JAX loader for the same ``RandomState``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
from scipy import ndimage
from scipy.interpolate import RegularGridInterpolator

__all__ = ["RB2EvalData", "RB2DataLoader", "CHANNELS", "FILTERS"]

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


def _resample_axis(a: np.ndarray, axis: int, n_dst: int,
                   method: str) -> np.ndarray:
    """Endpoint-aligned 1-D resample of one axis (linear or nearest).

    Sample positions are ``linspace(0, n_src - 1, n_dst)`` — identical
    semantics (and nearest tie-breaking: the lower neighbor wins on an
    exact half) to ``scipy.interpolate.RegularGridInterpolator``, but
    with STATIC per-axis indices/weights so a whole batch resamples in
    a few vectorized takes instead of a scattered-point scipy call.
    """
    n_src = a.shape[axis]
    x = np.linspace(0, n_src - 1, n_dst)
    i0 = np.minimum(np.floor(x).astype(np.int64), n_src - 2)
    frac = x - i0
    if method == "nearest":
        return np.take(a, i0 + (frac > 0.5), axis=axis)
    w = frac.reshape([n_dst if d == axis else 1 for d in range(a.ndim)])
    w = w.astype(a.dtype)  # keep the blend in the array's dtype
    lo = np.take(a, i0, axis=axis)
    hi = np.take(a, i0 + 1, axis=axis)
    return lo * (1.0 - w) + hi * w


def _global_multilinear(data: np.ndarray, origins: np.ndarray,
                        crop_sizes, pts: np.ndarray,
                        method: str = "linear") -> np.ndarray:
    """Vectorized trilinear read of crop-normalized points, directly
    from the GLOBAL field array (no per-crop copies).

    data: [T, Z, X, C]; origins: [B, 3] crop origins; crop_sizes:
    (nt, nz, nx); pts: [B, N, 3] in [0,1]^3 crop coordinates ->
    values [B, N, C]: 2^3 batched corner gathers + blend (the
    multilinear math of scipy's ``RegularGridInterpolator``, to float
    tolerance). Nearest ties (frac == 0.5) resolve to the lower
    neighbor, matching scipy.
    """
    sizes = np.asarray(crop_sizes, np.float64)
    s = np.clip(pts.astype(np.float64) * (sizes - 1), 0, sizes - 1)
    cell = np.minimum(s.astype(np.int64), (sizes - 2).astype(np.int64))
    cell = np.maximum(cell, 0)
    frac = s - cell                                        # [B, N, 3]
    g = cell + origins[:, None, :]                         # [B, N, 3] global
    if method == "nearest":
        idx = g + (frac > 0.5)
        return data[idx[..., 0], idx[..., 1], idx[..., 2]]
    out = 0.0
    for ot in (0, 1):
        for oz in (0, 1):
            for ox in (0, 1):
                w = ((frac[..., 0] if ot else 1 - frac[..., 0])
                     * (frac[..., 1] if oz else 1 - frac[..., 1])
                     * (frac[..., 2] if ox else 1 - frac[..., 2]))
                vals = data[g[..., 0] + ot, g[..., 1] + oz,
                            g[..., 2] + ox]                # [B, N, C]
                out = out + w[..., None].astype(data.dtype) * vals
    return out.astype(data.dtype)


class RB2DataLoader:
    """Space-time crop dataset over RB2D npz files (training batches).

    Same flags as the JAX loader: nt/nz/nx crop sizes, downsamp_t /
    downsamp_xz, n_samp_pts_per_crop, lres_filter, lres_interp,
    normalize_channels, return_hres, velonly.
    """

    def __init__(
        self,
        data_folder: str = ".",
        data_filename: str = "rb2d_ra1e6_s42.npz",
        nt: int = 16,
        nz: int = 128,
        nx: int = 128,
        n_samp_pts_per_crop: int = 512,
        downsamp_t: int = 4,
        downsamp_xz: int = 8,
        normalize_output: bool = True,
        return_hres: bool = False,
        lres_filter: str = "none",
        lres_interp: str = "linear",
        velonly: bool = False,
    ):
        if lres_filter not in FILTERS:
            raise ValueError(f"lres_filter must be one of {FILTERS}")
        if lres_interp not in ("linear", "nearest"):
            raise ValueError("lres_interp must be 'linear' or 'nearest'")
        # Comma-separated filenames concatenate multiple simulations
        # along the time axis; ``valid_t0`` below keeps crops from
        # straddling a file boundary (reference: single-file
        # ``RB2DataLoader``; multi-simulation training is our data-axis
        # extension).
        names = [s.strip() for s in data_filename.split(",") if s.strip()]
        parts, t_lens = [], []
        for name in names:
            path = os.path.join(data_folder, name)
            with np.load(path) as npz:
                parts.append(np.stack(
                    [np.asarray(npz[c], np.float32) for c in CHANNELS],
                    axis=-1))  # [T, Z, X, 4]
                self.dt_phys = float(npz["dt"]) if "dt" in npz else 1.0
                self.dz_phys = float(npz["dz"]) if "dz" in npz else 1.0
                self.dx_phys = float(npz["dx"]) if "dx" in npz else 1.0
        self.data = (parts[0] if len(parts) == 1
                     else np.concatenate(parts, axis=0))
        t_lens = [p.shape[0] for p in parts]
        del parts

        T, Z, X, _ = self.data.shape
        if nt > min(t_lens) or nz > Z or nx > X:
            raise ValueError(
                f"crop ({nt},{nz},{nx}) larger than data ({T},{Z},{X})")
        # Global-frame t0 values whose [t0, t0+nt) window stays inside
        # one source file.
        starts, off = [], 0
        for tl in t_lens:
            starts.append(np.arange(off, off + tl - nt + 1))
            off += tl
        self.valid_t0 = np.concatenate(starts).astype(np.int64)
        self.nt, self.nz, self.nx = nt, nz, nx
        self.n_samp_pts_per_crop = n_samp_pts_per_crop
        self.downsamp_t, self.downsamp_xz = downsamp_t, downsamp_xz
        self.normalize_output = normalize_output
        self.return_hres = return_hres
        self.lres_filter = lres_filter
        self.lres_interp = lres_interp
        self.velonly = velonly

        self.nt_l = max(2, nt // downsamp_t)
        self.nz_l = max(2, nz // downsamp_xz)
        self.nx_l = max(2, nx // downsamp_xz)

        # Per-channel stats over the whole dataset (reference computes
        # these in the dataloader and shares them with the PDE layer).
        self.channel_mean = self.data.mean(axis=(0, 1, 2))
        self.channel_std = self.data.std(axis=(0, 1, 2)) + 1e-8
        if not normalize_output:
            self.channel_mean = np.zeros_like(self.channel_mean)
            self.channel_std = np.ones_like(self.channel_std)

        # _origins[0] counts VALID t0 values (an index into valid_t0,
        # not a raw frame number — identical for single-file data).
        self._origins = (len(self.valid_t0), Z - nz + 1, X - nx + 1)

    # ------------------------------------------------------------------

    def __len__(self) -> int:
        o = self._origins
        return o[0] * o[1] * o[2]

    @property
    def lres_shape(self) -> Tuple[int, int, int]:
        return (self.nt_l, self.nz_l, self.nx_l)

    @property
    def coord_extents(self) -> Tuple[float, float, float]:
        """Physical spans of the [0,1]-normalized crop coordinates
        (for PDELayer.set_scaling)."""
        return ((self.nt - 1) * self.dt_phys,
                (self.nz - 1) * self.dz_phys,
                (self.nx - 1) * self.dx_phys)

    # ------------------------------------------------------------------

    def sample_batch(self, rng: np.random.RandomState, batch_size: int
                     ) -> Dict[str, np.ndarray]:
        """batch_size random items, assembled fully vectorized: crop
        gather, anti-alias filter, low-res resample and continuous-point
        reads all run batched numpy."""
        o = self._origins
        t0 = self.valid_t0[rng.randint(o[0], size=batch_size)]
        z0 = rng.randint(o[1], size=batch_size)
        x0 = rng.randint(o[2], size=batch_size)
        pts = rng.rand(batch_size, self.n_samp_pts_per_crop, 3
                       ).astype(np.float32)
        return self.batch_from_origins(t0, z0, x0, pts)

    def batch_from_origins(self, t0, z0, x0, pts: np.ndarray
                           ) -> Dict[str, np.ndarray]:
        """Vectorized batch from explicit crop origins + query points.

        t0/z0/x0: [B] crop origins; pts: [B, N, 3] in [0,1]^3.
        """
        b = len(t0)
        origins = np.stack([np.asarray(t0), np.asarray(z0),
                            np.asarray(x0)], axis=-1)     # [B, 3]
        crop_sizes = (self.nt, self.nz, self.nx)

        hres = None
        if self.return_hres or self.lres_filter != "none":
            # Only materialize full-res crops when something needs the
            # whole field (anti-alias filtering / hres output).
            hres = np.empty((b, *crop_sizes, self.data.shape[-1]),
                            self.data.dtype)
            for i in range(b):
                hres[i] = self.data[t0[i]:t0[i] + self.nt,
                                    z0[i]:z0[i] + self.nz,
                                    x0[i]:x0[i] + self.nx]

        if self.lres_filter != "none":
            lres = self._filter_batch(hres)
            for axis, n_dst in ((1, self.nt_l), (2, self.nz_l),
                                (3, self.nx_l)):
                lres = _resample_axis(lres, axis, n_dst, self.lres_interp)
            lres = lres.astype(np.float32)
        else:
            # Unfiltered default path: read the endpoint-aligned lattice
            # straight out of the global array — no crop copies at all.
            lat = self._lattice_pts()                    # [L, 3] static
            lat_b = np.broadcast_to(lat[None], (b, lat.shape[0], 3))
            lres = _global_multilinear(
                self.data, origins, crop_sizes, lat_b,
                method=self.lres_interp)
            lres = lres.reshape(b, self.nt_l, self.nz_l, self.nx_l,
                                -1).astype(np.float32)

        vals = _global_multilinear(self.data, origins, crop_sizes,
                                   pts)                  # [B, N, 4]

        mean, std = self.channel_mean, self.channel_std
        batch = {
            "lres": (lres - mean) / std,
            "point_coord": pts,
            "point_value": (vals - mean) / std,
        }
        if self.velonly:
            batch["point_value"] = batch["point_value"][..., 2:4]
        if self.return_hres:
            batch["hres"] = (hres - mean) / std
        return batch

    def _lattice_pts(self) -> np.ndarray:
        """Endpoint-aligned low-res lattice as [0,1]^3 points [L, 3]."""
        tl = np.linspace(0.0, 1.0, self.nt_l)
        zl = np.linspace(0.0, 1.0, self.nz_l)
        xl = np.linspace(0.0, 1.0, self.nx_l)
        TT, ZZ, XX = np.meshgrid(tl, zl, xl, indexing="ij")
        return np.stack([TT, ZZ, XX], axis=-1).reshape(-1, 3)

    def _filter_batch(self, crops: np.ndarray) -> np.ndarray:
        """Anti-alias filter on (z, x), vectorized over batch/t/channel
        (per-axis zero sigma/unit size keeps frames independent —
        identical to the per-crop filter)."""
        if self.lres_filter == "none":
            return crops
        size = max(self.downsamp_xz // 2 * 2 + 1, 3)
        sigma = self.downsamp_xz / 2.0
        if self.lres_filter == "gaussian":
            return ndimage.gaussian_filter(
                crops, sigma=(0, 0, sigma, sigma, 0))
        if self.lres_filter == "uniform":
            return ndimage.uniform_filter(
                crops, size=(1, 1, size, size, 1))
        if self.lres_filter == "median":
            return ndimage.median_filter(
                crops, size=(1, 1, size, size, 1))
        return ndimage.maximum_filter(
            crops, size=(1, 1, size, size, 1))
