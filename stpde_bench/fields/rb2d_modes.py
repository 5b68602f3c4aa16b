"""RB2D-shaped training fields made from the seed, on the device.

The recipe trains on four Dedalus runs of Rayleigh-Benard convection
(p, b, u, w on 128 x 512 nodes of a 1 x 4 box, 200 snapshots 0.125 apart;
``data/regen_rb2d.sh``). A solver run takes tens of seconds a seed on
the card, far more than a benchmark's set-up may, so each simulation
here is a smooth stand-in of the same shape and spacing: per channel,
the conduction profile (buoyancy only) plus ``modes`` travelling modes
``a sin(pi n z) cos(2 pi k x / Lx + omega t + phi)`` with n in 1..4, k
in 1..6, omega in [-2, 2), phi in [0, 2 pi) and a ~ N(0, 1 / modes).
The training step's work does not depend on the values; its PDE
residuals are those of whatever field it sees.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stpde_bench.harness.fieldtools import (
    host_field, lattice_nodes, normalised, valid_starts)

CHANNELS = 4    # p, b, u, w
BASE = (0.0, 1.0, 0.0, 0.0)   # buoyancy 1 - z, the conduction profile


def _params(sims, modes, gen, device):
    kw = dict(generator=gen, device=device)
    shape = (sims, CHANNELS, modes)
    return {
        "a": torch.randn(shape, **kw, dtype=torch.float64) / math.sqrt(modes),
        "n": torch.randint(1, 5, shape, **kw).double(),
        "k": torch.randint(1, 7, shape, **kw).double(),
        "omega": 4 * torch.rand(shape, **kw, dtype=torch.float64) - 2,
        "phi": 2 * math.pi * torch.rand(shape, **kw, dtype=torch.float64),
    }


def _evaluate(p, t, z, x, lx):
    """``[S, T, Z, X, C]`` at node coordinates t, z, x (float64)."""
    sinz = torch.sin(math.pi * p["n"][..., None] * z)            # [S,C,M,Z]
    arg = (2 * math.pi * p["k"][..., None, None] * x / lx
           + p["omega"][..., None, None] * t[:, None]
           + p["phi"][..., None, None])                           # [S,C,M,T,X]
    field = torch.einsum("scmz,scmtx->stzxc", p["a"][..., None] * sinz,
                         torch.cos(arg))
    base = torch.tensor(BASE, dtype=field.dtype, device=field.device)
    return field + base * (1.0 - z)[:, None, None]


def make(data: dict, seed: int, device):
    """(field ``[sims x frames, Z, X, 4]`` f32 on the host, valid start
    frames, channel mean, channel std)."""
    f = data["fields"]
    sims, frames, modes = f["sims"], f["frames"], f["modes"]
    nz, nx = f["grid"]
    dt, dz, dx = data["spacing"]
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    p = _params(sims, modes, gen, device)
    kw = dict(dtype=torch.float64, device=device)
    t = torch.arange(frames, **kw) * dt
    z = torch.arange(nz, **kw) * dz
    x = torch.arange(nx, **kw) * dx
    lx = nx * dx

    def sim(a, b):
        one = {k: v[a:b] for k, v in p.items()}
        return _evaluate(one, t, z, x, lx).float().reshape(-1, nz, nx,
                                                          CHANNELS)

    chunks = (sim(s, s + 1) for s in range(sims))
    field, mean, std = host_field(chunks, (sims * frames, nz, nx, CHANNELS),
                                  CHANNELS)
    return field, valid_starts(sims, frames, data["crop"][0]), mean, std


def window(data: dict, seed: int, crop, lres) -> np.ndarray:
    """A fresh normalised low-res window ``[*lres, 4]`` of a full-extent
    crop ``crop`` of one new stand-in simulation."""
    f = data["fields"]
    gen = torch.Generator().manual_seed(seed)
    p = _params(1, f["modes"], gen, "cpu")
    nz, nx = f["grid"]
    dt, dz, dx = data["spacing"]
    t0 = float(torch.rand((), generator=gen, dtype=torch.float64)) \
        * (f["frames"] - crop[0]) * dt
    t, z, x = lattice_nodes(crop, lres, data["spacing"], [t0, 0.0, 0.0])
    return normalised(_evaluate(p, t, z, x, nx * dx)[0])
