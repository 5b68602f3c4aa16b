"""4-D space-time dataset: crops, degradation and point sampling in
(t, z, y, x), for the turb3d stack.

A copy of ``space_time_pde_tpu/data/dataset4d.py::Field4DDataset``
(numpy + scipy, class for class: ``tests/test_torch_imports.py`` holds
the two ASTs equal), carried because the port imports nothing of the
JAX package. Loads an npz of [T, Z, Y, X] fields (comma-separated names
concatenate realizations along time), crops random 4-D blocks, builds
the low-res input on an endpoint-aligned lattice, samples continuous
points with linear ground truth, and normalizes per channel. Pairs with
``models.UNet4d`` and ``physics.systems.get_ns3d_pde_layer``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy.interpolate import RegularGridInterpolator

__all__ = ["Field4DDataset"]


class Field4DDataset:
    """Space-time crop dataset over 4-D fields.

    channels: npz array names in output order (default p, u, v, w).
    Items: lres [ntl, nzl, nyl, nxl, C], point_coord [N, 4] in [0,1]^4
    (t, z, y, x order), point_value [N, C] (normalized).
    """

    def __init__(
        self,
        data_folder: str = ".",
        data_filename: str = "abc_flow.npz",
        channels: Sequence[str] = ("p", "u", "v", "w"),
        nt: int = 8,
        nz: int = 16,
        ny: int = 16,
        nx: int = 16,
        n_samp_pts_per_crop: int = 512,
        downsamp_t: int = 2,
        downsamp_xyz: int = 4,
        normalize_output: bool = True,
        return_hres: bool = False,
    ):
        # Comma-separated filenames concatenate multiple realizations
        # along the time axis; ``valid_t0`` keeps crops from straddling
        # a file boundary (mirrors RB2DataLoader's multi-sim support —
        # the basis of the multi-realization Beltrami protocol).
        names = [s.strip() for s in data_filename.split(",") if s.strip()]
        parts = []
        for name in names:
            path = os.path.join(data_folder, name)
            with np.load(path) as npz:
                parts.append(np.stack(
                    [np.asarray(npz[c], np.float32) for c in channels],
                    axis=-1))                           # [T, Z, Y, X, C]
                self.spacings = tuple(
                    float(npz[k]) if k in npz else 1.0
                    for k in ("dt", "dz", "dy", "dx"))
        t_lens = [p.shape[0] for p in parts]
        self.data = (parts[0] if len(parts) == 1
                     else np.concatenate(parts, axis=0))
        del parts
        T, Z, Y, X, _ = self.data.shape
        if nt > min(t_lens) or nz > Z or ny > Y or nx > X:
            raise ValueError(
                f"crop ({nt},{nz},{ny},{nx}) > data ({T},{Z},{Y},{X})")
        starts, off = [], 0
        for tl in t_lens:
            starts.append(np.arange(off, off + tl - nt + 1))
            off += tl
        self.valid_t0 = np.concatenate(starts).astype(np.int64)
        self.crop = (nt, nz, ny, nx)
        self.n_samp_pts_per_crop = n_samp_pts_per_crop
        self.return_hres = return_hres
        self.lres = tuple(
            max(2, c // d) for c, d in zip(
                self.crop, (downsamp_t, downsamp_xyz, downsamp_xyz,
                            downsamp_xyz)))

        self.channel_mean = self.data.mean(axis=(0, 1, 2, 3))
        self.channel_std = self.data.std(axis=(0, 1, 2, 3)) + 1e-8
        if not normalize_output:
            self.channel_mean = np.zeros_like(self.channel_mean)
            self.channel_std = np.ones_like(self.channel_std)
        # _origins[0] counts VALID t0 values (index into valid_t0 —
        # identical to the frame count for single-file data).
        self._origins = (len(self.valid_t0),) + tuple(
            s - c + 1 for s, c in zip(self.data.shape[1:4], self.crop[1:]))

    def __len__(self) -> int:
        return int(np.prod(self._origins))

    @property
    def lres_shape(self) -> Tuple[int, int, int, int]:
        return self.lres

    @property
    def coord_extents(self) -> Tuple[float, float, float, float]:
        return tuple((c - 1) * s for c, s in zip(self.crop, self.spacings))

    def sample_crop(self, origin, rng: np.random.RandomState
                    ) -> Dict[str, np.ndarray]:
        sl = tuple(slice(o, o + c) for o, c in zip(origin, self.crop))
        hres = self.data[sl]                         # [*crop, C]

        axes = [np.arange(c) for c in self.crop]
        interp = RegularGridInterpolator(axes, hres, method="linear")
        lat = [np.linspace(0, c - 1, l)
               for c, l in zip(self.crop, self.lres)]
        mesh = np.meshgrid(*lat, indexing="ij")
        lres = interp(np.stack(mesh, -1).reshape(-1, 4)).reshape(
            *self.lres, -1).astype(np.float32)

        n = self.n_samp_pts_per_crop
        pts = rng.rand(n, 4).astype(np.float32)
        axes01 = [np.linspace(0, 1, c) for c in self.crop]
        vals = RegularGridInterpolator(axes01, hres)(pts).astype(
            np.float32)

        mean, std = self.channel_mean, self.channel_std
        item = {
            "lres": (lres - mean) / std,
            "point_coord": pts,
            "point_value": (vals - mean) / std,
        }
        if self.return_hres:
            item["hres"] = (hres - mean) / std
        return item

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        origin = np.unravel_index(idx, self._origins)
        origin = (int(self.valid_t0[origin[0]]),) + tuple(origin[1:])
        return self.sample_crop(origin, np.random.RandomState(idx))

    def sample_batch(self, rng: np.random.RandomState, batch_size: int
                     ) -> Dict[str, np.ndarray]:
        items = []
        for _ in range(batch_size):
            origin = tuple(rng.randint(o) for o in self._origins)
            origin = (int(self.valid_t0[origin[0]]),) + tuple(origin[1:])
            items.append(self.sample_crop(origin, rng))
        return {k: np.stack([it[k] for it in items]) for k in items[0]}
