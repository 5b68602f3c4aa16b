"""The RB2D Boussinesq data generator of the port against the JAX
package's numpy solver, on the CPU.

- The port's numpy copy (``space_time_pde_torch/data/generator.py``) is
  the JAX package's source, statement for statement, and writes the same
  arrays bit for bit (also through both CLIs).
- ``ops/tridiag.py``: :func:`factor` + :func:`thomas_plain` (the kernel's
  plain twin) against ``_thomas_batched`` on random systems of both
  boundary kinds, rtol 1e-13: the twin does numpy's arithmetic (a product
  with the reciprocal for numpy's division by a real-valued complex), so
  the only slack is the sign of a zero.
- The float64 torch solver (``data/rb2_solver.py``) against the numpy
  solver over 200 steps, from a seeded start and from a developed state
  (64 x 32, Ra 1e5, seed 0, run to t = 10 by the numpy solver): every
  field within 1e-12 of its max |numpy|. The FFTs differ (torch's against
  numpy's pocketfft), so the two agree to rounding, which the seeded
  start's first steps grow to ~2e-14 of max.
- ``simulate_rb2d`` of the port: the npz schema and ``tests/test_data.py``'s
  physical checks.

Torch runs on one thread here: the solver's operators are small, and
eight threads on 64 x 32 fields spend their time waiting on each other.
"""

import ast
import importlib.util
import inspect
import os
import sys

import numpy as np
import pytest
import torch

from space_time_pde_torch.data import generator as tgen
from space_time_pde_torch.data.rb2_solver import RB2Solver
from space_time_pde_torch.data.rb2_solver import simulate_rb2d as \
    torch_simulate
from space_time_pde_torch.ops import tridiag as td
from space_time_pde_tpu.data import generator as jgen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_data.py's run of the solver.
SMALL = dict(nx=32, nz=16, rayleigh=1e4, t_transient=0.5, n_snapshots=4,
             snap_dt=0.25, seed=0)
STEPS, STEP_TOL = 200, 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _node(module, name):
    tree = ast.parse(inspect.getsource(module))
    return ast.dump(next(n for n in tree.body
                         if getattr(n, "name", None) == name))


@pytest.mark.parametrize("name", ["_thomas_batched", "_RB2Solver",
                                  "simulate_rb2d"])
def test_numpy_copy_is_the_jax_source(name):
    assert _node(tgen, name) == _node(jgen, name)


def test_numpy_copy_equals_jax_simulate_rb2d():
    want = jgen.simulate_rb2d(**SMALL)
    got = tgen.simulate_rb2d(**SMALL)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _system(kind, rng, nz=24, nx=40, scramble=False):
    """(lower, diag, upper) [nk, nz] real and rhs [nk, nz] complex, built
    as ``_solve_helmholtz`` builds its rows for the zero_rows ``kind``
    (a random grid spacing; ``scramble``: also a random shift, ``upper``
    scaled by random factors in [0.5, 1] and ``lower`` by one such factor
    a row, so that it stays the same in every mode as the solver's)."""
    dz = rng.uniform(0.01, 0.1)
    kx = 2 * np.pi * np.fft.rfftfreq(nx, d=rng.uniform(0.02, 0.2))
    nk, dz2 = kx.shape[0], dz ** 2
    shift = rng.uniform(0.5, 5.0) if scramble else 0.0
    diag = np.full((nk, nz), -2.0 / dz2) - (kx ** 2 + shift)[:, None]
    lower = np.full((nk, nz), 1.0 / dz2)
    upper = np.full((nk, nz), 1.0 / dz2)
    if kind == "walls":
        diag[:, 0] = 1.0; upper[:, 0] = 0.0
        diag[:, -1] = 1.0; lower[:, -1] = 0.0
    else:
        diag[:, 0] = -1.0 / dz2 - (kx ** 2 + shift)
        diag[:, -1] = -1.0 / dz2 - (kx ** 2 + shift)
        diag[0, 0] = 1.0; upper[0, 0] = 0.0
    if scramble:
        lower *= rng.uniform(0.5, 1.0, nz)
        upper *= rng.uniform(0.5, 1.0, upper.shape)
    rhs = rng.randn(nk, nz) + 1j * rng.randn(nk, nz)
    return lower, diag, upper, rhs


def _numpy_solve(kind, lower, diag, upper, rhs):
    rhs = rhs.copy()
    if kind == "walls":
        rhs[:, 0] = 0.0
        rhs[:, -1] = 0.0
    else:
        rhs[0, 0] = 0.0
    c = lambda a: a.astype(complex)
    return jgen._thomas_batched(c(lower), c(diag), c(upper), rhs)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind,scramble", [("walls", False), ("pin", False),
                                           ("walls", True), ("pin", True)])
def test_thomas_plain_matches_thomas_batched(kind, scramble, seed):
    rng = np.random.RandomState(seed)
    lower, diag, upper, rhs = _system(kind, rng, scramble=scramble)
    want = _numpy_solve(kind, lower, diag, upper, rhs)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))
    low = torch.from_numpy(lower[0])
    c, inv = td.factor(low, t(diag), t(upper))
    got = td.tridiag(t(rhs), low, c, inv, kind).numpy().T
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13 * scale)


def test_factor_is_numpy_elimination():
    """c and 1 / denom of the recurrence of ``_thomas_batched``'s lines
    89-94, bit for bit (numpy's complex division by a real-valued
    complex is a product with the reciprocal)."""
    rng = np.random.RandomState(2)
    lower, diag, upper, _ = _system("pin", rng, scramble=True)
    n = diag.shape[-1]
    c64 = np.empty_like(diag, dtype=complex)
    inv64 = np.empty_like(diag)
    cl, cd, cu = (a.astype(complex) for a in (lower, diag, upper))
    c64[:, 0] = cu[:, 0] / cd[:, 0]
    inv64[:, 0] = 1.0 / diag[:, 0]
    for i in range(1, n):
        denom = cd[:, i] - cl[:, i] * c64[:, i - 1]
        c64[:, i] = cu[:, i] / denom
        inv64[:, i] = 1.0 / denom.real
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))
    c, inv = td.factor(torch.from_numpy(lower[0]), t(diag), t(upper))
    np.testing.assert_array_equal(c.numpy().T, c64.real)
    np.testing.assert_array_equal(inv.numpy().T, inv64)


def test_tridiag_refuses_bad_inputs():
    rng = np.random.RandomState(3)
    lower, diag, upper, rhs = _system("walls", rng, nz=6, nx=8)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))
    low = torch.from_numpy(lower[0])
    c, inv = td.factor(low, t(diag), t(upper))
    with pytest.raises(ValueError, match="complex128"):
        td.tridiag(t(rhs).to(torch.complex64), low, c, inv, "walls")
    with pytest.raises(ValueError, match="float64"):
        td.tridiag(t(rhs), low.float(), c, inv, "walls")
    with pytest.raises(ValueError, match="zero_rows"):
        td.tridiag(t(rhs), low, c, inv, "dirichlet")
    with pytest.raises(ValueError, match="one"):
        td.factor(low[:3], t(diag), t(upper))
    with pytest.raises(ValueError, match=r"lower must be float64 \(6,\)"):
        td.tridiag(t(rhs), t(lower), c, inv, "walls")


@pytest.fixture(scope="module")
def developed():
    """The numpy solver's state at t = 10 (1,550 steps) from seed 0 at
    64 x 32, Ra 1e5: |u| ~ 0.35, |w| ~ 0.64 (chip_smoke.py phase S,
    check c)."""
    s = jgen._RB2Solver(64, 32, 4.0, 1.0, 1e5, 1.0, 0)
    dt = min(0.2 * s.dx, 0.2 * s.dz, 0.2 * s.dz ** 2 / max(s.R, s.P))
    for _ in range(int(round(10.0 / dt))):
        s.step(dt)
    return s, dt


def _fields(s):
    """b, zeta, then psi, u, w (``velocities``) and p (``pressure``)."""
    u, w = s.velocities()
    out = {"b": s.b, "zeta": s.zeta, "psi": s.psi, "u": u, "w": w,
           "p": s.pressure(u, w, s.b)}
    return {k: v.numpy() if torch.is_tensor(v) else v
            for k, v in out.items()}


@pytest.mark.parametrize("start", ["seeded", "developed"])
def test_torch_solver_matches_numpy(start, request):
    if start == "seeded":
        ref = jgen._RB2Solver(64, 32, 4.0, 1.0, 1e5, 1.0, 0)
        dt = min(0.2 * ref.dx, 0.2 * ref.dz,
                 0.2 * ref.dz ** 2 / max(ref.R, ref.P))
        sol = RB2Solver(64, 32, 4.0, 1.0, 1e5, 1.0, 0, "cpu")
        np.testing.assert_array_equal(sol.b.numpy(), ref.b)
    else:
        ref, dt = request.getfixturevalue("developed")
        ref = _copy_solver(ref)
        sol = RB2Solver.from_state(ref.b, ref.zeta, ref.psi, 4.0, 1.0, 1e5,
                                   1.0, "cpu")
        assert float(np.abs(ref.ddz(ref.psi)).max()) > 0.3
    for _ in range(STEPS):
        ref.step(dt)
        sol.step(dt)
    want, got = _fields(ref), _fields(sol)
    for k in want:
        scale = float(np.abs(want[k]).max())
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= STEP_TOL * scale, (k, err / scale)


def _copy_solver(s):
    out = jgen._RB2Solver.__new__(jgen._RB2Solver)
    out.__dict__.update({k: np.copy(v) if isinstance(v, np.ndarray) else v
                         for k, v in s.__dict__.items()})
    return out


def test_torch_simulate_rb2d_schema_and_values():
    want = jgen.simulate_rb2d(**SMALL)
    got = torch_simulate(device="cpu", **SMALL)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.shape(got[k]) == np.shape(want[k]), k
    for k in ("dt", "dz", "dx", "rayleigh", "prandtl"):
        assert got[k] == want[k], k
    for k in ("p", "b", "u", "w"):
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-6 * scale, err_msg=k)


def test_torch_simulate_rb2d_is_physical():
    """``tests/test_data.py::test_rb_simulation_runs_and_is_physical`` on
    the torch solver's output."""
    out = torch_simulate(device="cpu", **SMALL)
    for k in ("p", "b", "u", "w"):
        assert out[k].shape == (4, 16, 32)
        assert np.all(np.isfinite(out[k]))
    np.testing.assert_allclose(out["b"][:, 0, :], 1.0, atol=1e-6)
    np.testing.assert_allclose(out["b"][:, -1, :], 0.0, atol=1e-6)
    assert np.abs(out["u"][:, 0]).max() < 1e-10
    assert np.abs(out["w"][:, -1]).max() < 1e-10
    u, w = out["u"][-1], out["w"][-1]
    dx, dz = float(out["dx"]), float(out["dz"])
    div = ((np.roll(u, -1, 1) - np.roll(u, 1, 1)) / (2 * dx)
           + np.gradient(w, dz, axis=0))
    scale = max(np.abs(u).max(), np.abs(w).max(), 1e-8) / dz
    assert np.abs(div[2:-2]).max() < 0.05 * scale


def _cli(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "experiments", "rb2d", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_cpu_writes_the_jax_cli_file(tmp_path, monkeypatch, capsys):
    """``generate_data_torch.py --device cpu`` and ``generate_data.py``
    write the same npz bytes; the card is the default device."""
    flags = ["--nx", "32", "--nz", "16", "--rayleigh", "1e4",
             "--t_transient", "0.5", "--n_snapshots", "4", "--snap_dt",
             "0.25", "--seed", "0"]
    port, jax_cli = _cli("generate_data_torch"), _cli("generate_data")
    port.main(flags + ["--device", "cpu", "--out",
                       str(tmp_path / "port.npz")])
    monkeypatch.setattr(sys, "argv", ["generate_data.py", *flags, "--out",
                                      str(tmp_path / "jax.npz")])
    jax_cli.main()
    out = capsys.readouterr().out
    assert "wrote " + str(tmp_path / "port.npz") in out
    assert "seed 0: " in out and "cpu (numpy)" in out
    assert (tmp_path / "port.npz").read_bytes() == \
        (tmp_path / "jax.npz").read_bytes()
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            port.main(flags + ["--out", str(tmp_path / "card.npz")])


def test_cli_taylor_green(tmp_path):
    port = _cli("generate_data_torch")
    path = tmp_path / "tg.npz"
    port.main(["--kind", "taylor_green", "--nx", "16", "--nz", "16",
               "--nt", "4", "--device", "cpu", "--out", str(path)])
    got = np.load(path)
    want = tgen.taylor_green_fields(nt=4, nz=16, nx=16)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
