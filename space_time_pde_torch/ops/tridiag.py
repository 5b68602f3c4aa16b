"""Batched tridiagonal solve: a CUDA kernel and its plain twin.

The Helmholtz solves of the RB2D Boussinesq data generator
(``data/rb2_solver.py``): for each Fourier mode k in x, a tridiagonal
system down z with real coefficients and a complex128 right-hand side,
every array ``[nz, nk]`` as ``torch.fft.rfft(f, dim=1)`` lays out a field
``f [nz, nx]``. Replaces no Pallas TPU kernel: the JAX package runs the
solver in numpy on the host (``space_time_pde_tpu/data/generator.py::
_thomas_batched``, the Thomas recurrence of its lines 86-99).

The coefficients do not depend on the right-hand side, so
:func:`factor` eliminates them once per operator (the recurrence of
``_thomas_batched``'s lines 89-94) into ``c`` and ``inv = 1 / denom``; a
solve (:func:`tridiag`) is then the d sweep and the back substitution.
numpy divides by a complex number of zero imaginary part as a product
with its reciprocal, and both the kernel and :func:`thomas_plain` do
exactly that, operation for operation.

:func:`tridiag` on a CUDA tensor launches ``stpde_tridiag_solve``
(``csrc/tridiag.cu``) and counts it in ``LAUNCHES`` (``CAPTURED`` under
graph capture), or raises; on a CPU
tensor it runs :func:`thomas_plain`, which the CPU tests hold against the
JAX package's ``_thomas_batched`` and ``chip_smoke.py`` holds the kernel
against on the card.
"""

from __future__ import annotations

import torch

from space_time_pde_torch.ops import _build

__all__ = ["LAUNCHES", "CAPTURED", "reset_launches", "ZERO_ROWS", "factor",
           "thomas_plain", "tridiag"]

# Kernel launches of stpde_tridiag_solve; only the CUDA branch of the
# wrapper adds to them: LAUNCHES outside graph capture, CAPTURED the
# launches recorded into a CUDA graph (each replay runs them again, and
# only a device trace sees that).
LAUNCHES = {"tridiag": 0}
CAPTURED = {"tridiag": 0}

# Which right-hand-side rows count as zero (``_solve_helmholtz`` zeroes
# them after its FFT): rows 0 and nz - 1 of every mode (Dirichlet); row 0
# of mode 0 (Neumann with the kx = 0 mode pinned).
ZERO_ROWS = {"walls": 1, "pin": 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = CAPTURED[k] = 0


def factor(lower: torch.Tensor, diag: torch.Tensor, upper: torch.Tensor):
    """Eliminate real float64 coefficients, ``diag`` and ``upper``
    ``[nz, nk]`` and ``lower`` ``[nz]`` (one sub-diagonal for every mode;
    ``lower[0]`` and ``upper[nz - 1]`` unused), into ``(c, inv)``:
    ``denom[0] = diag[0]``, ``denom[i] = diag[i] - lower[i] c[i - 1]``,
    ``inv = 1 / denom``, ``c = upper inv``, on the coefficients' device."""
    if not (diag.shape == upper.shape) or diag.ndim != 2 or \
            lower.shape != diag.shape[:1]:
        raise ValueError(f"diag and upper must be one [nz, nk] shape and "
                         f"lower [nz], got {tuple(lower.shape)}, "
                         f"{tuple(diag.shape)}, {tuple(upper.shape)}")
    if {lower.dtype, diag.dtype, upper.dtype} != {torch.float64}:
        raise ValueError("the coefficients must be float64")
    c = torch.empty_like(diag)
    inv = torch.empty_like(diag)
    inv[0] = 1.0 / diag[0]
    c[0] = upper[0] * inv[0]
    for i in range(1, diag.shape[0]):
        inv[i] = 1.0 / (diag[i] - lower[i] * c[i - 1])
        c[i] = upper[i] * inv[i]
    return c, inv


def _check(rhs, lower, c, inv, zero_rows) -> None:
    if rhs.ndim != 2 or rhs.dtype != torch.complex128:
        raise ValueError(f"rhs must be complex128 [nz, nk], got "
                         f"{rhs.dtype} {tuple(rhs.shape)}")
    for name, t, shape in (("lower", lower, rhs.shape[:1]),
                           ("c", c, rhs.shape), ("inv", inv, rhs.shape)):
        if t.shape != shape or t.dtype != torch.float64:
            raise ValueError(f"{name} must be float64 {tuple(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != rhs.device:
            raise ValueError(f"{name} is on {t.device}, rhs on {rhs.device}")
    if rhs.shape[0] < 2:
        raise ValueError(f"need nz >= 2 rows, got {rhs.shape[0]}")
    if zero_rows not in ZERO_ROWS:
        raise ValueError(f"zero_rows must be one of {sorted(ZERO_ROWS)}, "
                         f"got {zero_rows!r}")


def thomas_plain(rhs: torch.Tensor, lower: torch.Tensor, c: torch.Tensor,
                 inv: torch.Tensor, zero_rows: str) -> torch.Tensor:
    """The plain twin: the d sweep and the back substitution of
    ``_thomas_batched`` over the modes at once, on the real and imaginary
    parts (the coefficients are real)."""
    _check(rhs, lower, c, inv, zero_rows)
    nz = rhs.shape[0]
    r = torch.view_as_real(rhs).clone()               # [nz, nk, 2]
    if zero_rows == "walls":
        r[0] = 0.0
        r[nz - 1] = 0.0
    else:
        r[0, 0] = 0.0
    x = torch.empty_like(r)
    x[0] = r[0] * inv[0, :, None]
    for i in range(1, nz):
        x[i] = (r[i] - lower[i] * x[i - 1]) * inv[i, :, None]
    for i in range(nz - 2, -1, -1):
        x[i] = x[i] - c[i, :, None] * x[i + 1]
    return torch.view_as_complex(x)


def tridiag(rhs: torch.Tensor, lower: torch.Tensor, c: torch.Tensor,
            inv: torch.Tensor, zero_rows: str) -> torch.Tensor:
    """Solve the systems of :func:`factor`'s ``(c, inv)`` and ``lower``
    ``[nz]`` for ``rhs`` (complex128 ``[nz, nk]``; rows named by
    ``zero_rows`` read as 0):
    ``stpde_tridiag_solve`` on a CUDA tensor, :func:`thomas_plain` on a
    CPU tensor."""
    if rhs.device.type == "cpu":
        return thomas_plain(rhs, lower, c, inv, zero_rows)
    if rhs.device.type != "cuda":
        raise ValueError(f"no tridiagonal solve on {rhs.device}")
    _check(rhs, lower, c, inv, zero_rows)
    rhs = rhs.contiguous()
    lower, c, inv = lower.contiguous(), c.contiguous(), inv.contiguous()
    x = torch.empty_like(rhs)
    nz, nk = rhs.shape
    code = _build.load("tridiag").stpde_tridiag_solve(
        rhs.data_ptr(), lower.data_ptr(), c.data_ptr(), inv.data_ptr(),
        x.data_ptr(), nz, nk, ZERO_ROWS[zero_rows],
        torch.cuda.current_stream(rhs.device).cuda_stream)
    _build.check(code, "stpde_tridiag_solve")
    if torch.cuda.is_current_stream_capturing():
        CAPTURED["tridiag"] += 1
    else:
        LAUNCHES["tridiag"] += 1
    return x
