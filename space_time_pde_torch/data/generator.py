"""Analytic fixture data (numpy): the decaying Taylor–Green solution.

A copy of ``space_time_pde_tpu/data/generator.py::taylor_green_fields``
(numpy only), carried so that the port's smoke run makes its data
without importing the JAX package. ``tests/test_torch_data.py`` holds
the two equal. The Boussinesq solver stays in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["taylor_green_fields", "save_npz"]


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
