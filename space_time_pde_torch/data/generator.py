"""Analytic fixture data (numpy): the decaying Taylor–Green solution and
the exact Beltrami (ABC) Navier–Stokes realizations of the turb3d data.

Copies of ``space_time_pde_tpu/data/generator.py::taylor_green_fields``,
``abc_flow_fields`` and ``beltrami_realization_params`` (numpy only),
carried so that the port's smoke run makes its data without importing
the JAX package. ``tests/test_torch_data.py`` and
``tests/test_torch_turb3d.py`` hold them equal. The Boussinesq solver
stays in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["taylor_green_fields", "abc_flow_fields",
           "beltrami_realization_params", "beltrami_fields",
           "save_npz"]


def save_npz(path: str, fields: Dict[str, np.ndarray]) -> None:
    np.savez_compressed(path, **fields)


def taylor_green_fields(nt: int = 32, nz: int = 64, nx: int = 64,
                        viscosity: float = 1e-2, dt: float = 0.05,
                        dtype=np.float32) -> Dict[str, np.ndarray]:
    """Exact decaying Taylor–Green solution on [0, 2pi)^2, b == 0.

        u =  sin(x) cos(z) F(t),  w = -cos(x) sin(z) F(t),
        p = +(cos 2x + cos 2z)/4 F(t)^2,  F = exp(-2 nu t)
    """
    t = np.arange(nt) * dt
    z = np.linspace(0, 2 * np.pi, nz, endpoint=False)
    x = np.linspace(0, 2 * np.pi, nx, endpoint=False)
    T, Z, X = np.meshgrid(t, z, x, indexing="ij")
    F = np.exp(-2.0 * viscosity * T)
    u = np.sin(X) * np.cos(Z) * F
    w = -np.cos(X) * np.sin(Z) * F
    p = 0.25 * (np.cos(2 * X) + np.cos(2 * Z)) * F ** 2
    b = np.zeros_like(u)
    return {
        "p": p.astype(dtype), "b": b.astype(dtype),
        "u": u.astype(dtype), "w": w.astype(dtype),
        "dt": np.float64(dt),
        "dz": np.float64(2 * np.pi / nz),
        "dx": np.float64(2 * np.pi / nx),
        "viscosity": np.float64(viscosity),
    }


def abc_flow_fields(nt: int = 16, nz: int = 32, ny: int = 32,
                    nx: int = 32, viscosity: float = 1e-2,
                    dt: float = 0.1, A: float = 1.0, B: float = 0.7,
                    C: float = 0.3, dtype=np.float32,
                    phases=(0.0, 0.0, 0.0)
                    ) -> Dict[str, np.ndarray]:
    """Exact decaying ABC (Beltrami) Navier-Stokes solution on [0,2pi)^3.

        u = (A sin(z+pz) + C cos(y+py)) F,
        v = (B sin(x+px) + A cos(z+pz)) F,
        w = (C sin(y+py) + B cos(x+px)) F,
        p = -(u^2+v^2+w^2)/2,  F = exp(-nu t)

    Every axis term is a |k| = 1 Beltrami mode, so the field satisfies
    omega = u and is an exact unsteady solution of incompressible 3-D
    NS for any amplitudes and phases ``(pz, px, py)``. Arrays are
    [T, Z, Y, X].
    """
    pz, px, py = phases
    t = np.arange(nt) * dt
    z = np.linspace(0, 2 * np.pi, nz, endpoint=False)
    y = np.linspace(0, 2 * np.pi, ny, endpoint=False)
    x = np.linspace(0, 2 * np.pi, nx, endpoint=False)
    T, Z, Y, X = np.meshgrid(t, z, y, x, indexing="ij")
    F = np.exp(-viscosity * T)
    u = (A * np.sin(Z + pz) + C * np.cos(Y + py)) * F
    v = (B * np.sin(X + px) + A * np.cos(Z + pz)) * F
    w = (C * np.sin(Y + py) + B * np.cos(X + px)) * F
    p = -0.5 * (u ** 2 + v ** 2 + w ** 2)
    return {
        "p": p.astype(dtype), "u": u.astype(dtype),
        "v": v.astype(dtype), "w": w.astype(dtype),
        "dt": np.float64(dt),
        "dz": np.float64(2 * np.pi / nz),
        "dy": np.float64(2 * np.pi / ny),
        "dx": np.float64(2 * np.pi / nx),
        "viscosity": np.float64(viscosity),
    }


def beltrami_realization_params(seed: int, energy: float = 1.58):
    """Random same-statistics Beltrami realization: (A, B, C, phases).

    Amplitudes uniform on the positive octant of the sphere
    A^2 + B^2 + C^2 = ``energy`` and three uniform phases: each seed is
    a decorrelated exact NS solution of the same family (the turb3d
    train / val / test seeds).
    """
    rng = np.random.RandomState(seed)
    amps = np.abs(rng.randn(3))
    amps = amps / np.linalg.norm(amps) * np.sqrt(energy)
    phases = rng.uniform(0.0, 2 * np.pi, size=3)
    return float(amps[0]), float(amps[1]), float(amps[2]), tuple(phases)


def beltrami_fields(seed: int, nt: int = 24, n: int = 32
                    ) -> Dict[str, np.ndarray]:
    """The realization that ``experiments/turb3d/generate_data.py --seed
    <seed>`` writes with its default grid (nt frames of n^3, dt 0.1,
    viscosity 1e-2)."""
    a, b, c, phases = beltrami_realization_params(seed)
    return abc_flow_fields(nt=nt, nz=n, ny=n, nx=n, A=a, B=b, C=c,
                           phases=phases)
