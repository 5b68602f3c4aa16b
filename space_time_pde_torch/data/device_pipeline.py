"""On-device batch assembly (PyTorch).

Counterpart of ``space_time_pde_tpu/data/device_pipeline.py``: the whole
simulation field is uploaded to the device once (RB2D at 200 x 128 x 512
x 4 f32 is ~52 MB), and each step's low-res lattice reads, ground-truth
point reads and normalisation are a few batched multilinear gathers on
the device. The host only draws crop origins and uniform points, with
the same ``np.random.RandomState`` calls as the JAX sampler, so both
packages draw identical batches for a seed.

The field lives as ``[nodes, C]`` (row-major nodes, channels minor): a
corner read is one row gather. The JAX sampler's flat 1-D layout
avoided TPU tile padding and has no reason here. Supported for the
default degradation (``lres_filter='none'``), linear or nearest
lattice interpolation, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from space_time_pde_torch.ops.grid_interp import (
    _locate, _strides, corner_offsets)
from space_time_pde_torch.utils import tracing

__all__ = ["DeviceSampler"]


def _crop_geometry(ds):
    """(crop_sizes, lres_sizes) of the 3-D ``RB2DataLoader`` or the 4-D
    ``Field4DDataset``."""
    if hasattr(ds, "crop"):            # Field4DDataset
        return tuple(ds.crop), tuple(ds.lres)
    return (ds.nt, ds.nz, ds.nx), (ds.nt_l, ds.nz_l, ds.nx_l)


class DeviceSampler:
    """Device-side ``sample_batch`` of an :class:`RB2DataLoader` or a
    :class:`Field4DDataset` (its stats and crop geometry):
    ``batch_fn(origins [B, D], pts [B, N, D])`` -> the host pipeline's
    batch dict, on ``device``."""

    def __init__(self, ds, device):
        if getattr(ds, "lres_filter", "none") != "none":
            raise ValueError(
                "DeviceSampler supports lres_filter='none' only "
                f"(got {ds.lres_filter!r}); use the host pipeline")
        self.device = torch.device(device)
        self._host_data = np.asarray(ds.data)
        self.field_spatial = tuple(int(s) for s in ds.data.shape[:-1])
        self.n_ch = int(ds.data.shape[-1])
        self.data = self._upload()
        self._strides = torch.as_tensor(_strides(self.field_spatial),
                                        device=self.device)
        self.mean = torch.as_tensor(ds.channel_mean, dtype=torch.float32,
                                    device=self.device)
        self.std = torch.as_tensor(ds.channel_std, dtype=torch.float32,
                                   device=self.device)
        self.crop_sizes, self.lres_sizes = _crop_geometry(ds)
        self.dim = len(self.crop_sizes)
        self.lres_interp = getattr(ds, "lres_interp", "linear")
        self.velonly = getattr(ds, "velonly", False)
        self._origins = ds._origins
        self._valid_t0 = np.asarray(ds.valid_t0, np.int32)
        self.n_samp_pts = ds.n_samp_pts_per_crop
        axes = [np.linspace(0.0, 1.0, n) for n in self.lres_sizes]
        mesh = np.meshgrid(*axes, indexing="ij")
        self.lattice = torch.as_tensor(
            np.stack(mesh, -1).reshape(-1, self.dim).astype(np.float32),
            device=self.device)
        # Made once: the device-side read builds no tensor from host
        # numbers (a synchronous copy, which a CUDA graph cannot hold).
        kw = dict(dtype=torch.float32, device=self.device)
        self._sizes = torch.as_tensor(self.crop_sizes, **kw)
        self._gsizes = torch.as_tensor(self.field_spatial, **kw)
        self._offs = torch.as_tensor(corner_offsets(self.dim),
                                     device=self.device)

    @staticmethod
    def supported(ds) -> bool:
        return getattr(ds, "lres_filter", "none") == "none"

    def _host_field(self) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(self._host_data).reshape(-1, self.n_ch))

    def _upload(self) -> torch.Tensor:
        # A copy on every device (on the CPU too), so that the host field
        # stays what refresh() restores.
        return self._host_field().to(self.device, copy=True)

    def refresh(self) -> torch.Tensor:
        """Re-upload the field into the same device buffer (the driver's
        recovery after non-finite steps with healthy parameters; a
        captured step keeps reading that storage)."""
        self.data.copy_(self._host_field())
        return self.data

    # -------------------------------------------------------- host side

    def draw(self, rng: np.random.RandomState, batch_size: int
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Host RNG: (origins [B, D] int32, pts [B, N, D] f32)."""
        o = self._origins
        origins = np.stack([rng.randint(o[i], size=batch_size)
                            for i in range(self.dim)], -1).astype(np.int32)
        origins[:, 0] = self._valid_t0[origins[:, 0]]
        pts = rng.rand(batch_size, self.n_samp_pts,
                       self.dim).astype(np.float32)
        return origins, pts

    # ------------------------------------------------------ device side

    def _read(self, pts_crop: torch.Tensor, origins: torch.Tensor,
              method: str) -> torch.Tensor:
        """Crop-normalised points ``[B, N, D]`` of crops at ``origins``
        ``[B, D]`` -> field values ``[B, N, C]``."""
        s_idx = origins.to(torch.float32)[:, None, :] + pts_crop * (
            self._sizes - 1.0)
        p_glob = s_idx / (self._gsizes - 1.0)
        cell, frac = _locate(p_glob, self.field_spatial, 0.0, 1.0)
        if method == "nearest":
            node = cell.to(torch.int64) + (frac > 0.5)
            return self.data[(node * self._strides).sum(-1)]
        offs = self._offs
        cidx = cell.to(torch.int64)[..., None, :] + offs     # [B, N, K, D]
        feats = self.data[(cidx * self._strides).sum(-1)]    # [B, N, K, C]
        per_axis = torch.where(offs.bool(), frac[..., None, :],
                               1.0 - frac[..., None, :])
        weights = torch.prod(per_axis, dim=-1)               # [B, N, K]
        return torch.einsum("bnkc,bnk->bnc", feats, weights)

    def batch_fn(self, origins, pts) -> Dict[str, torch.Tensor]:
        """(origins [B, D], pts [B, N, D]) -> normalised batch dict."""
        origins = torch.as_tensor(origins, device=self.device)
        pts = torch.as_tensor(pts, device=self.device)
        b = pts.shape[0]
        lat = self.lattice.expand(b, *self.lattice.shape)
        lres = self._read(lat, origins, self.lres_interp)
        lres = lres.reshape(b, *self.lres_sizes, self.n_ch)
        vals = self._read(pts, origins, "linear")
        lres = (lres - self.mean) / self.std
        vals = (vals - self.mean) / self.std
        if self.velonly:
            vals = vals[..., 2:4]
        return {"lres": lres, "point_coord": pts, "point_value": vals}

    def wrap_loss(self, loss_fn):
        """loss_fn over batches -> loss_fn over raw ``{"origins",
        "point_coord"}`` batches (assembled here, on the device)."""

        def loss2(raw):
            with tracing.span("batch"):
                batch = self.batch_fn(raw["origins"], raw["point_coord"])
            return loss_fn(batch)

        return loss2
