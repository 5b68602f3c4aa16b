"""The RB2D Boussinesq solver in float64 on an explicit torch device.

Counterpart of ``space_time_pde_tpu/data/generator.py::_RB2Solver`` and
``simulate_rb2d`` (a vorticity–streamfunction solver: Fourier in periodic
x, second-order finite differences in wall-bounded z, RK2 midpoint
steps), with the same operators in the same order of operations:

- ``ddx`` / ``lap``'s x part through ``torch.fft`` (cuFFT on a card);
- the Helmholtz solves per Fourier mode through :func:`ops.tridiag.tridiag`
  (the hand-written ``csrc/tridiag.cu`` on a card, its plain twin on the
  CPU), their factors computed once per operator;
- Thom's wall vorticity from the last ``psi``, so the midpoint's walls use
  the first stage's ``psi``;
- the pressure from its Poisson equation, Neumann data folded into the
  wall rows, ``p - p.mean()``.

The initial state is the numpy reference's (``np.random.RandomState(seed)
.randn``, ``np.linspace`` z, ``np.fft.rfftfreq`` kx) moved to the device,
so a seed means the same start in both packages. The state lives in
fixed tensors (``b``, ``zeta``, ``psi``) updated in place, so
:meth:`RB2Solver.capture` can record steps as one CUDA graph over them;
a replay equals the same steps run eagerly bit for bit.

Two differences of form that keep numpy's values: a division by a
constant divides by a 0-dim tensor on the solver's device (PyTorch's CUDA
kernels turn a division by a Python number into a product with its
reciprocal; numpy divides), and ``ddx``'s multiplier ``1j kx`` is 0 at the
Nyquist mode of an even ``nx`` (numpy's ``irfft`` ignores that mode's
imaginary part, the only part ``1j kx`` leaves there; cuFFT is not
documented to).
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from space_time_pde_torch.ops.tridiag import factor, tridiag

__all__ = ["RB2Solver", "simulate_rb2d", "flow_statistics", "REPLAYS",
           "reset_replays"]

# Replays of the snapshot interval's CUDA graph that simulate_rb2d ran
# (each runs the graph's recorded launches again).
REPLAYS = {"interval": 0}


def reset_replays() -> None:
    REPLAYS["interval"] = 0


class RB2Solver:
    """Periodic-x / wall-bounded-z Boussinesq solver on a [Z, X] grid, in
    float64 on ``device``."""

    def __init__(self, nx, nz, lx, lz, rayleigh, prandtl, seed, device):
        self._grid(nx, nz, lx, lz, rayleigh, prandtl, device)
        rng = np.random.RandomState(seed)
        # Conduction profile + small random perturbation (interior only).
        b = (1.0 - self.z / lz)[:, None] * np.ones((nz, nx))
        pert = 1e-2 * rng.randn(nz, nx)
        pert *= (np.sin(np.pi * self.z / lz) ** 2)[:, None]
        b += pert
        self._state(b, np.zeros((nz, nx)), np.zeros((nz, nx)))

    @classmethod
    def from_state(cls, b, zeta, psi, lx, lz, rayleigh, prandtl, device):
        """A solver that starts from the state ``b, zeta, psi`` ([nz, nx]
        float64 arrays, e.g. a numpy solver's)."""
        self = cls.__new__(cls)
        nz, nx = np.shape(b)
        self._grid(nx, nz, lx, lz, rayleigh, prandtl, device)
        self._state(b, zeta, psi)
        return self

    def _grid(self, nx, nz, lx, lz, rayleigh, prandtl, device):
        self.device = torch.device(device)
        self.nx, self.nz, self.lx, self.lz = nx, nz, lx, lz
        self.R = (rayleigh / prandtl) ** -0.5   # viscosity
        self.P = (rayleigh * prandtl) ** -0.5   # thermal diffusivity
        self.dx = lx / nx
        self.dz = lz / (nz - 1)
        self.z = np.linspace(0.0, lz, nz)
        kx = 2 * np.pi * np.fft.rfftfreq(nx, d=self.dx)
        ikx = 1j * kx
        if nx % 2 == 0:
            ikx[-1] = 0.0
        dev = dict(device=self.device)
        self._ikx = torch.tensor(ikx, dtype=torch.complex128, **dev)
        self._mk2 = torch.tensor(-(kx ** 2), dtype=torch.float64, **dev)
        scalar = lambda v: torch.tensor(v, dtype=torch.float64, **dev)
        self._2dz = scalar(2 * self.dz)
        self._dz2 = scalar(self.dz ** 2)
        self._dz = scalar(self.dz)
        self._psi_op = self._helmholtz(kx, "dirichlet") + ("walls",)
        self._p_op = self._helmholtz(kx, "neumann") + ("pin",)

    def _state(self, b, zeta, psi):
        as_t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64),
                                      device=self.device)
        self.b, self.zeta, self.psi = as_t(b), as_t(zeta), as_t(psi)

    def _helmholtz(self, kx, bc):
        """Factors of ``(d2/dz2 - kx^2)`` per mode, the rows of
        ``_solve_helmholtz`` (at its only shift, 0): (lower [nz], the
        sub-diagonal of every mode, and c, inv [nz, nk])."""
        nz, dz2 = self.nz, self.dz ** 2
        nk = kx.shape[0]
        diag = np.full((nk, nz), -2.0 / dz2)
        diag -= (kx ** 2)[:, None]
        lower = np.full(nz, 1.0 / dz2)          # the same in every mode
        upper = np.full((nk, nz), 1.0 / dz2)
        if bc == "dirichlet":
            diag[:, 0] = 1.0; upper[:, 0] = 0.0
            diag[:, -1] = 1.0; lower[-1] = 0.0
        else:  # one-sided 2nd-order Neumann, kx = 0 pinned: f(0) = 0
            diag[:, 0] = -1.0 / dz2 - kx ** 2
            upper[:, 0] = 1.0 / dz2
            diag[:, -1] = -1.0 / dz2 - kx ** 2
            diag[0, 0] = 1.0; upper[0, 0] = 0.0
        lower = torch.from_numpy(lower)
        diag, upper = (torch.from_numpy(np.ascontiguousarray(a.T))
                       for a in (diag, upper))
        c, inv = factor(lower, diag, upper)
        return tuple(t.to(self.device) for t in (lower, c, inv))

    # -- spatial operators ------------------------------------------------
    def ddx(self, f):
        return torch.fft.irfft(self._ikx * torch.fft.rfft(f, dim=1),
                               n=self.nx, dim=1)

    def ddz(self, f):
        out = torch.empty_like(f)
        out[1:-1] = (f[2:] - f[:-2]) / self._2dz
        out[0] = (-3 * f[0] + 4 * f[1] - f[2]) / self._2dz
        out[-1] = (3 * f[-1] - 4 * f[-2] + f[-3]) / self._2dz
        return out

    def lap(self, f):
        d2x = torch.fft.irfft(self._mk2 * torch.fft.rfft(f, dim=1),
                              n=self.nx, dim=1)
        d2z = torch.empty_like(f)
        d2z[1:-1] = (f[2:] - 2 * f[1:-1] + f[:-2]) / self._dz2
        d2z[0] = (2 * f[0] - 5 * f[1] + 4 * f[2] - f[3]) / self._dz2
        d2z[-1] = (2 * f[-1] - 5 * f[-2] + 4 * f[-3] - f[-4]) / self._dz2
        return d2x + d2z

    def _solve(self, rhs, op):
        lower, c, inv, zero_rows = op
        f_k = tridiag(torch.fft.rfft(rhs, dim=1), lower, c, inv, zero_rows)
        return torch.fft.irfft(f_k, n=self.nx, dim=1)

    def velocities(self):
        self.psi.copy_(self._solve(-self.zeta, self._psi_op))
        u = self.ddz(self.psi)
        w = -self.ddx(self.psi)
        # Enforce no-slip/no-penetration at walls exactly.
        u[0] = u[-1] = 0.0
        w[0] = w[-1] = 0.0
        return u, w

    def _rhs(self):
        u, w = self.velocities()
        bx = self.ddx(self.b)
        adv_z = u * self.ddx(self.zeta) + w * self.ddz(self.zeta)
        adv_b = u * bx + w * self.ddz(self.b)
        dzeta = -adv_z + self.R * self.lap(self.zeta) + bx
        db = -adv_b + self.P * self.lap(self.b)
        return dzeta, db

    def _apply_bcs(self):
        # Temperature: fixed plates.
        self.b[0] = 1.0
        self.b[-1] = 0.0
        # Vorticity at no-slip walls (Thom's formula, psi_wall = 0).
        self.zeta[0] = -2.0 * self.psi[1] / self._dz2
        self.zeta[-1] = -2.0 * self.psi[-2] / self._dz2

    def step(self, dt):
        # RK2 midpoint, in place on the state tensors.
        zeta_save, b_save = self.zeta.clone(), self.b.clone()
        dz1, db1 = self._rhs()
        self.zeta.copy_(zeta_save + 0.5 * dt * dz1)
        self.b.copy_(b_save + 0.5 * dt * db1)
        self._apply_bcs()
        dz2, db2 = self._rhs()
        self.zeta.copy_(zeta_save + dt * dz2)
        self.b.copy_(b_save + dt * db2)
        self._apply_bcs()

    def pressure(self, u, w, b):
        """Recover p from the pressure Poisson equation (Neumann walls)."""
        ux, uz = self.ddx(u), self.ddz(u)
        wx, wz = self.ddx(w), self.ddz(w)
        rhs = -(ux ** 2 + 2 * uz * wx + wz ** 2) + self.ddz(b)
        # Fold Neumann data into the one-sided wall rows.
        lap_w = self.lap(w)
        g0 = b[0] + self.R * lap_w[0]           # p_z at z=0
        g1 = b[-1] + self.R * lap_w[-1]         # p_z at z=1
        rhs[0] += g0 / self._dz
        rhs[-1] -= g1 / self._dz
        p = self._solve(rhs, self._p_op)
        return p - p.mean()

    def capture(self, n_steps, dt) -> torch.cuda.CUDAGraph:
        """Record ``n_steps`` steps as one CUDA graph over the state
        tensors; each ``replay()`` advances the state by them. One eager
        step first (its state put back) warms cuFFT's plans and the
        allocator; the capture itself moves nothing."""
        saved = [t.clone() for t in (self.b, self.zeta, self.psi)]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.step(dt)
        torch.cuda.current_stream(self.device).wait_stream(side)
        for t, s in zip((self.b, self.zeta, self.psi), saved):
            t.copy_(s)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n_steps):
                self.step(dt)
        return graph


def simulate_rb2d(nx: int = 512, nz: int = 128, lx: float = 4.0,
                  lz: float = 1.0, rayleigh: float = 1e6,
                  prandtl: float = 1.0, t_transient: float = 25.0,
                  n_snapshots: int = 200, snap_dt: float = 0.125,
                  dt: float = None, seed: int = 42,
                  dtype=np.float32, progress: bool = False,
                  device="cuda") -> Dict[str, np.ndarray]:
    """Simulate RB convection on ``device``; returns the reference npz
    schema of ``generator.simulate_rb2d``: ``p, b, u, w`` [n_snapshots,
    nz, nx] in ``dtype`` plus ``dt`` (snapshot spacing), ``dz``, ``dx``,
    ``rayleigh``, ``prandtl`` (float64).

    On a card the ``n_per`` steps between two snapshots run as one CUDA
    graph (:meth:`RB2Solver.capture`), the transient as its replays and
    the remainder of ``n_tr / n_per`` steps eagerly; on the CPU every
    step is eager."""
    s = RB2Solver(nx, nz, lx, lz, rayleigh, prandtl, seed, device)
    if dt is None:
        # CFL-ish: free-fall velocity O(1), explicit diffusion limit.
        dt = min(0.2 * s.dx, 0.2 * s.dz, 0.2 * s.dz ** 2 / max(s.R, s.P))
    n_tr = int(round(t_transient / dt))
    n_per = max(1, int(round(snap_dt / dt)))
    if s.device.type == "cuda":
        graph = s.capture(n_per, dt)

        def advance():
            graph.replay()
            REPLAYS["interval"] += 1
    else:
        def advance():
            for _ in range(n_per):
                s.step(dt)
    out = {k: torch.empty((n_snapshots, nz, nx), dtype=torch.float64,
                          device=s.device) for k in ("p", "b", "u", "w")}
    t0 = time.perf_counter()
    for i in range(n_tr // n_per):
        if progress and i * n_per % 2000 < n_per:
            print(f"transient {i * n_per}/{n_tr}", flush=True)
        advance()
    for _ in range(n_tr % n_per):
        s.step(dt)
    for n in range(n_snapshots):
        advance()
        u, w = s.velocities()
        out["p"][n] = s.pressure(u, w, s.b)
        out["b"][n], out["u"][n], out["w"][n] = s.b, u, w
        if progress and n % 10 == 0:
            print(f"snapshot {n}/{n_snapshots} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    snaps = {k: v.cpu().numpy().astype(dtype) for k, v in out.items()}
    snaps["dt"] = np.float64(n_per * dt)
    snaps["dz"] = np.float64(s.dz)
    snaps["dx"] = np.float64(s.dx)
    snaps["rayleigh"] = np.float64(rayleigh)
    snaps["prandtl"] = np.float64(prandtl)
    return snaps


def flow_statistics(fields: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Statistics of an rb2d dataset (``p, b, u, w`` [T, Z, X] and ``dz``),
    in float64: the x-and-time mean profile of ``b``, the rms profiles of
    ``u`` and ``w`` (``sqrt(mean u^2)`` over x and time), and the
    time-mean Nusselt number at each wall, ``-mean db/dz`` there by the
    solver's one-sided second-order ``ddz`` (1 for pure conduction)."""
    b = np.asarray(fields["b"], np.float64)
    dz = float(fields["dz"])
    rms = lambda f: np.sqrt((np.asarray(f, np.float64) ** 2).mean((0, 2)))
    return {
        "b_mean": b.mean((0, 2)),
        "u_rms": rms(fields["u"]),
        "w_rms": rms(fields["w"]),
        "nu_bottom": np.float64(
            -((-3 * b[:, 0] + 4 * b[:, 1] - b[:, 2]) / (2 * dz)).mean()),
        "nu_top": np.float64(
            -((3 * b[:, -1] - 4 * b[:, -2] + b[:, -3]) / (2 * dz)).mean()),
    }
