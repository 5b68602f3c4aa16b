"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources under ``space_time_pde_torch/csrc/`` have a plain C
interface, so they compile with ``nvcc`` alone in seconds (no PyTorch
headers) at first use, into ``space_time_pde_torch/_build/`` (listed in
``.gitignore``), under a name that carries a hash of the source and the
flags: an edited source never loads a stale library. Pointers cross as
``c_void_p``, and every entry point returns ``cudaGetLastError()``,
which :func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load", "check", "build_log"]

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "fused_query.cu"
_BUILD = _PKG / "_build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # table, cell_flat, frac, 9 weights, out, n, n_cells, c, dim, nf,
    # out_dim, act_code, negative_slope, stream
    "stpde_decode_blend_gather": [_P] * 13 + [_I] * 7 + [_F, _P],
    # feats2, frac, 9 weights, out, n, c, dim, nf, out_dim, act_code,
    # negative_slope, stream
    "stpde_decode_blend": [_P] * 12 + [_I] * 6 + [_F, _P],
}

_lib = None
_log = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): "
                       "the CUDA kernels are built on the machine with the "
                       "card")


def load():
    """The kernels' ``ctypes`` library, compiled on first call."""
    global _lib
    if _lib is not None:
        return _lib
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD / f"libstpde_fused_query_{tag}.so"
    if not so.exists():
        _BUILD.mkdir(exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
        _log.update(seconds=time.perf_counter() - t0,
                    ptxas=proc.stderr.strip())
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.stpde_block_rows.argtypes, lib.stpde_block_rows.restype = [], _I
    lib.stpde_error_string.argtypes = [ctypes.c_int]
    lib.stpde_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = _lib.stpde_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def build_log() -> dict:
    """``{"seconds", "ptxas"}`` of the build this process ran (empty if
    the library was already built)."""
    return dict(_log)
