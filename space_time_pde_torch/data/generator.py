"""Data generation in numpy: the RB2D Boussinesq solver, the decaying
Taylor–Green solution and the exact Beltrami (ABC) Navier–Stokes
realizations of the turb3d data.

Copies of ``space_time_pde_tpu/data/generator.py::_thomas_batched``,
``_RB2Solver``, ``simulate_rb2d``, ``taylor_green_fields``,
``abc_flow_fields`` and ``beltrami_realization_params`` (numpy only),
carried so that the port makes its data without importing the JAX
package. The solver is the port's reference arithmetic: the card's
float64 solver (``data/rb2_solver.py``) is held against it, and
``experiments/rb2d/generate_data_torch.py --device cpu`` runs it, so
that path writes the datasets ``data/SHA256SUMS.rb2d`` pins.
``tests/test_torch_data.py``, ``tests/test_torch_turb3d.py`` and
``tests/test_torch_rb2_solver.py`` hold them equal.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["simulate_rb2d", "taylor_green_fields", "abc_flow_fields",
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


# --------------------------------------------------------------------------
# Vorticity–streamfunction Boussinesq solver.
# --------------------------------------------------------------------------


def _thomas_batched(lower, diag, upper, rhs):
    """Vectorized Thomas solve of tridiagonal systems.

    lower/diag/upper: [..., n] (lower[..., 0] and upper[..., -1] unused).
    rhs: [..., n]. Returns x with the same shape. Complex-safe.
    """
    n = diag.shape[-1]
    c = np.empty_like(diag)
    d = np.empty_like(rhs)
    c[..., 0] = upper[..., 0] / diag[..., 0]
    d[..., 0] = rhs[..., 0] / diag[..., 0]
    for i in range(1, n):
        denom = diag[..., i] - lower[..., i] * c[..., i - 1]
        c[..., i] = upper[..., i] / denom
        d[..., i] = (rhs[..., i] - lower[..., i] * d[..., i - 1]) / denom
    x = np.empty_like(rhs)
    x[..., -1] = d[..., -1]
    for i in range(n - 2, -1, -1):
        x[..., i] = d[..., i] - c[..., i] * x[..., i + 1]
    return x


class _RB2Solver:
    """Periodic-x / wall-bounded-z Boussinesq solver on a [Z, X] grid."""

    def __init__(self, nx, nz, lx, lz, rayleigh, prandtl, seed):
        self.nx, self.nz, self.lx, self.lz = nx, nz, lx, lz
        self.R = (rayleigh / prandtl) ** -0.5   # viscosity
        self.P = (rayleigh * prandtl) ** -0.5   # thermal diffusivity
        self.dx = lx / nx
        self.dz = lz / (nz - 1)
        self.z = np.linspace(0.0, lz, nz)
        self.kx = 2 * np.pi * np.fft.rfftfreq(nx, d=self.dx)
        rng = np.random.RandomState(seed)
        # Conduction profile + small random perturbation (interior only).
        self.b = (1.0 - self.z / lz)[:, None] * np.ones((nz, nx))
        pert = 1e-2 * rng.randn(nz, nx)
        pert *= (np.sin(np.pi * self.z / lz) ** 2)[:, None]
        self.b += pert
        self.zeta = np.zeros((nz, nx))          # vorticity dw/dx - du/dz
        self.psi = np.zeros((nz, nx))

    # -- spatial operators ------------------------------------------------
    def ddx(self, f):
        return np.fft.irfft(1j * self.kx * np.fft.rfft(f, axis=1), axis=1,
                            n=self.nx)

    def ddz(self, f):
        out = np.empty_like(f)
        out[1:-1] = (f[2:] - f[:-2]) / (2 * self.dz)
        out[0] = (-3 * f[0] + 4 * f[1] - f[2]) / (2 * self.dz)
        out[-1] = (3 * f[-1] - 4 * f[-2] + f[-3]) / (2 * self.dz)
        return out

    def lap(self, f):
        d2x = np.fft.irfft(-(self.kx ** 2) * np.fft.rfft(f, axis=1),
                           axis=1, n=self.nx)
        d2z = np.empty_like(f)
        d2z[1:-1] = (f[2:] - 2 * f[1:-1] + f[:-2]) / self.dz ** 2
        d2z[0] = (2 * f[0] - 5 * f[1] + 4 * f[2] - f[3]) / self.dz ** 2
        d2z[-1] = (2 * f[-1] - 5 * f[-2] + 4 * f[-3] - f[-4]) / self.dz ** 2
        return d2x + d2z

    def _solve_helmholtz(self, rhs, bc="dirichlet", shift=0.0):
        """(d2/dz2 - kx^2 - shift) f = rhs per Fourier mode in x.

        bc='dirichlet': f=0 at both walls. bc='neumann': df/dz=0 walls
        (kx=0 handled by pinning the mean).
        """
        nz, dz2 = self.nz, self.dz ** 2
        rhs_k = np.fft.rfft(rhs, axis=1).T          # [nkx, nz]
        nk = rhs_k.shape[0]
        diag = np.full((nk, nz), -2.0 / dz2, dtype=complex)
        diag -= (self.kx ** 2 + shift)[:, None]
        lower = np.full((nk, nz), 1.0 / dz2, dtype=complex)
        upper = np.full((nk, nz), 1.0 / dz2, dtype=complex)
        if bc == "dirichlet":
            diag[:, 0] = 1.0; upper[:, 0] = 0.0
            diag[:, -1] = 1.0; lower[:, -1] = 0.0
            rhs_k[:, 0] = 0.0; rhs_k[:, -1] = 0.0
        else:  # one-sided 2nd-order Neumann
            diag[:, 0] = -1.0 / dz2 - (self.kx ** 2 + shift)
            upper[:, 0] = 1.0 / dz2
            diag[:, -1] = -1.0 / dz2 - (self.kx ** 2 + shift)
            lower[:, -1] = 1.0 / dz2
            # kx=0, shift=0 is singular (pure Neumann): pin f(0)=0.
            if shift == 0.0:
                diag[0, 0] = 1.0; upper[0, 0] = 0.0; rhs_k[0, 0] = 0.0
        f_k = _thomas_batched(lower, diag, upper, rhs_k)
        return np.fft.irfft(f_k.T, axis=1, n=self.nx)

    def velocities(self):
        self.psi = self._solve_helmholtz(-self.zeta, bc="dirichlet")
        u = self.ddz(self.psi)
        w = -self.ddx(self.psi)
        # Enforce no-slip/no-penetration at walls exactly.
        u[0] = u[-1] = 0.0
        w[0] = w[-1] = 0.0
        return u, w

    def _rhs(self, zeta, b):
        u, w = self.velocities()
        adv_z = u * self.ddx(zeta) + w * self.ddz(zeta)
        adv_b = u * self.ddx(b) + w * self.ddz(b)
        dzeta = -adv_z + self.R * self.lap(zeta) + self.ddx(b)
        db = -adv_b + self.P * self.lap(b)
        return dzeta, db, u, w

    def _apply_bcs(self):
        # Temperature: fixed plates.
        self.b[0] = 1.0
        self.b[-1] = 0.0
        # Vorticity at no-slip walls (Thom's formula, psi_wall = 0):
        # zeta_wall = -2 psi_1 / dz^2 (sign: zeta = -lap(psi)).
        self.zeta[0] = -2.0 * self.psi[1] / self.dz ** 2
        self.zeta[-1] = -2.0 * self.psi[-2] / self.dz ** 2

    def step(self, dt):
        # RK2 midpoint.
        dz1, db1, _, _ = self._rhs(self.zeta, self.b)
        z_mid = self.zeta + 0.5 * dt * dz1
        b_mid = self.b + 0.5 * dt * db1
        zeta_save, b_save = self.zeta, self.b
        self.zeta, self.b = z_mid, b_mid
        self._apply_bcs()
        dz2, db2, _, _ = self._rhs(self.zeta, self.b)
        self.zeta = zeta_save + dt * dz2
        self.b = b_save + dt * db2
        self._apply_bcs()

    def pressure(self, u, w, b):
        """Recover p from the pressure Poisson equation.

        lap(p) = -(u_x^2 + 2 u_z w_x + w_z^2) + b_z, Neumann walls
        (from z-momentum at the wall: p_z = b + R w_zz, w_wall = 0).
        """
        ux, uz = self.ddx(u), self.ddz(u)
        wx, wz = self.ddx(w), self.ddz(w)
        rhs = -(ux ** 2 + 2 * uz * wx + wz ** 2) + self.ddz(b)
        # Fold Neumann data into the one-sided wall rows.
        g0 = b[0] + self.R * self.lap(w)[0]      # p_z at z=0
        g1 = b[-1] + self.R * self.lap(w)[-1]    # p_z at z=1
        rhs = rhs.copy()
        rhs[0] += g0 / self.dz
        rhs[-1] -= g1 / self.dz
        p = self._solve_helmholtz(rhs, bc="neumann")
        return p - p.mean()


def simulate_rb2d(nx: int = 512, nz: int = 128, lx: float = 4.0,
                  lz: float = 1.0, rayleigh: float = 1e6,
                  prandtl: float = 1.0, t_transient: float = 25.0,
                  n_snapshots: int = 200, snap_dt: float = 0.125,
                  dt: float = None, seed: int = 42,
                  dtype=np.float32, progress: bool = False
                  ) -> Dict[str, np.ndarray]:
    """Simulate RB convection; returns the reference npz schema.

    Returns dict with ``p, b, u, w`` arrays of shape
    [n_snapshots, nz, nx] plus ``dt`` (snapshot spacing), ``dz``,
    ``dx`` metadata (reference: Dedalus ``rayleigh_benard.py`` script +
    pre-simulated ``rb2d_ra1e6_s42.npz``).
    """
    s = _RB2Solver(nx, nz, lx, lz, rayleigh, prandtl, seed)
    if dt is None:
        # CFL-ish: free-fall velocity O(1), explicit diffusion limit.
        dt = min(0.2 * s.dx, 0.2 * s.dz, 0.2 * s.dz ** 2 / max(s.R, s.P))
    n_tr = int(round(t_transient / dt))
    n_per = max(1, int(round(snap_dt / dt)))
    snaps = {k: np.empty((n_snapshots, nz, nx), dtype)
             for k in ("p", "b", "u", "w")}
    for i in range(n_tr):
        s.step(dt)
        if progress and i % 2000 == 0:
            print(f"transient {i}/{n_tr}", flush=True)
    for n in range(n_snapshots):
        for _ in range(n_per):
            s.step(dt)
        u, w = s.velocities()
        p = s.pressure(u, w, s.b)
        snaps["p"][n], snaps["b"][n] = p, s.b
        snaps["u"][n], snaps["w"][n] = u, w
        if progress and n % 10 == 0:
            print(f"snapshot {n}/{n_snapshots}", flush=True)
    snaps["dt"] = np.float64(n_per * dt)
    snaps["dz"] = np.float64(s.dz)
    snaps["dx"] = np.float64(s.dx)
    snaps["rayleigh"] = np.float64(rayleigh)
    snaps["prandtl"] = np.float64(prandtl)
    return snaps


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
