"""turb3d training fields made from the seed, on the device.

The recipe trains on 200 Beltrami (ABC) flows, exact solutions of the
incompressible Navier-Stokes equations (p, u, v, w on 32^3 nodes of a
2 pi periodic box, 24 snapshots 0.1 apart, viscosity nu;
``data/regen_beltrami.sh``). Each realisation here is the same closed
form with its own amplitudes (uniform on the positive octant of the
sphere A^2 + B^2 + C^2 = ``energy``) and phases (uniform), drawn from
the seed:

    u = (A sin(z + pz) + C cos(y + py)) F,  v = (B sin(x + px) + A cos(z + pz)) F,
    w = (C sin(y + py) + B cos(x + px)) F,  p = -(u^2 + v^2 + w^2) / 2,
    F = exp(-nu t).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stpde_bench.harness.fieldtools import (
    chunked, host_field, lattice_nodes, normalised, valid_starts)

CHANNELS = 4    # p, u, v, w


def _params(sims, energy, gen, device):
    kw = dict(generator=gen, device=device, dtype=torch.float64)
    amps = torch.randn(sims, 3, **kw).abs()
    amps = amps / torch.linalg.vector_norm(amps, dim=1, keepdim=True) \
        * math.sqrt(energy)
    phases = 2 * math.pi * torch.rand(sims, 3, **kw)
    return amps, phases


def _evaluate(amps, phases, t, z, y, x, nu):
    """``[S, T, Z, Y, X, 4]`` (float64)."""
    a, b, c = (amps[:, i].view(-1, 1, 1, 1, 1) for i in range(3))
    pz, px, py = (phases[:, i].view(-1, 1, 1, 1, 1) for i in range(3))
    f = torch.exp(-nu * t).view(1, -1, 1, 1, 1)
    z, y, x = z.view(1, 1, -1, 1, 1), y.view(1, 1, 1, -1, 1), \
        x.view(1, 1, 1, 1, -1)
    u = (a * torch.sin(z + pz) + c * torch.cos(y + py)) * f
    v = (b * torch.sin(x + px) + a * torch.cos(z + pz)) * f
    w = (c * torch.sin(y + py) + b * torch.cos(x + px)) * f
    shape = torch.broadcast_shapes(u.shape, v.shape, w.shape)
    u, v, w = (q.expand(shape) for q in (u, v, w))
    p = -0.5 * (u * u + v * v + w * w)
    return torch.stack([p, u, v, w], -1)


def make(data: dict, seed: int, device):
    """(field ``[sims x frames, Z, Y, X, 4]`` f32 on the host, valid
    start frames, channel mean, channel std)."""
    f = data["fields"]
    sims, frames = f["sims"], f["frames"]
    grid = tuple(f["grid"])
    dt, dz, dy, dx = data["spacing"]
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    amps, phases = _params(sims, f["energy"], gen, device)
    kw = dict(dtype=torch.float64, device=device)
    t = torch.arange(frames, **kw) * dt
    z, y, x = (torch.arange(n, **kw) * s for n, s in zip(grid, (dz, dy, dx)))

    def part(a, b):
        return _evaluate(amps[a:b], phases[a:b], t, z, y, x,
                         f["viscosity"]).float().reshape(-1, *grid, CHANNELS)

    field, mean, std = host_field(chunked(part, sims, 8),
                                  (sims * frames, *grid, CHANNELS), CHANNELS)
    return field, valid_starts(sims, frames, data["crop"][0]), mean, std


def window(data: dict, seed: int, crop, lres) -> np.ndarray:
    """A fresh normalised low-res window ``[*lres, 4]`` of a full-extent
    crop of one new realisation."""
    f = data["fields"]
    gen = torch.Generator().manual_seed(seed)
    amps, phases = _params(1, f["energy"], gen, "cpu")
    t0 = float(torch.rand((), generator=gen, dtype=torch.float64)) \
        * (f["frames"] - crop[0]) * data["spacing"][0]
    t, z, y, x = lattice_nodes(crop, lres, data["spacing"],
                               [t0, 0.0, 0.0, 0.0])
    return normalised(_evaluate(amps, phases, t, z, y, x,
                                f["viscosity"])[0])
