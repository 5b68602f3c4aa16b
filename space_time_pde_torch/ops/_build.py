"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Every source under ``space_time_pde_torch/csrc/`` has a plain C
interface, so each compiles with ``nvcc`` alone in seconds (no PyTorch
headers) at first use, into ``space_time_pde_torch/_build/`` (listed in
``.gitignore``). All sources are compiled at once, one ``nvcc`` process
each, started together; every library's name carries one hash over all
the sources, the headers they share (``csrc/*.cuh``) and the flags, so an
edited source never loads a stale library. Pointers cross as ``c_void_p``, and every entry point returns
``cudaGetLastError()``, which :func:`check` turns into an exception.
There is no fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load", "check", "build_log", "library_path"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_SOURCES = ("fused_query", "fused_query_bf16", "fused_jet", "fused_jet_bf16",
            "tridiag")
_BUILD = _PKG / "_build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_ARGTYPES = {
    "fused_query": {
        # table, cell_flat, frac, tile image (fused_query.decode_tiles at
        # f32), its elements, w5, b5, out, n, n_cells, c, dim, nf, out_dim,
        # act_code, negative_slope, stream
        "stpde_decode_blend_gather": (
            [_P] * 4 + [_L] + [_P] * 3 + [_I] * 7 + [_F, _P], _I),
        # feats2, frac, tile image, its elements, w5, b5, out, n, c, dim,
        # nf, out_dim, act_code, negative_slope, stream
        "stpde_decode_blend": (
            [_P] * 3 + [_L] + [_P] * 3 + [_I] * 6 + [_F, _P], _I),
        "stpde_block_rows": ([], _I),
        # c, dim, nf, out[8]
        "stpde_decode_plan": ([_I] * 3 + [_P], None),
        "stpde_error_string": ([_I], ctypes.c_char_p),
    },
    "fused_query_bf16": {
        # table, cell_flat, frac, tile image (fused_query.decode_tiles), its
        # elements, w5, b5, out, n, n_cells, c, dim, nf, out_dim, act_code,
        # negative_slope, stream
        "stpde_decode_blend_gather_bf16": (
            [_P] * 4 + [_L] + [_P] * 3 + [_I] * 7 + [_F, _P], _I),
        # feats2, frac, tile image, its elements, w5, b5, out, n, c, dim,
        # nf, out_dim, act_code, negative_slope, stream
        "stpde_decode_blend_bf16": (
            [_P] * 3 + [_L] + [_P] * 3 + [_I] * 6 + [_F, _P], _I),
        "stpde_block_rows_bf16": ([], _I),
        # c, dim, nf, pregathered, out[6]
        "stpde_decode_bf16_plan": ([_I] * 4 + [_P], None),
    },
    "fused_jet": {
        # n, c, dim, nf, out_dim
        "stpde_jet_fwd_workspace": ([_I] * 5, _L),
        "stpde_jet_bwd_workspace": ([_I] * 5, _L),
        # feats2, frac, 9 weights, out, workspace, n, c, dim, nf, out_dim,
        # slope, stream
        "stpde_jet_fwd": ([_P] * 13 + [_I] * 5 + [_F, _P], _I),
        # feats2, frac, 9 weights, fwd workspace, ybar, dfeats, 9 grads,
        # workspace, n, c, dim, nf, out_dim, slope, stream
        "stpde_jet_bwd": ([_P] * 24 + [_I] * 5 + [_F, _P], _I),
        # n, c, dim, nf, out[2]; A tiles, columns a consumer, staging,
        # out[4]; m, ka, nb, out[5]
        "stpde_jet_f32_image_layout": ([_I] * 4 + [_P], None),
        "stpde_jet_f32_ring": ([_I] * 3 + [_P], None),
        "stpde_jet_f32_tn_plan": ([_L, _I, _I, _P], None),
    },
    # The same entry points at bf16 (feats2 and the weights but corner_bias
    # and b5 bf16; frac, out, ybar and every gradient f32).
    "fused_jet_bf16": {
        "stpde_jet_fwd_bf16_workspace": ([_I] * 5, _L),
        "stpde_jet_bwd_bf16_workspace": ([_I] * 5, _L),
        "stpde_jet_fwd_bf16": ([_P] * 13 + [_I] * 5 + [_F, _P], _I),
        "stpde_jet_bwd_bf16": ([_P] * 24 + [_I] * 5 + [_F, _P], _I),
        # A tiles a stage, staging, out[4]; m, ka, nb, out[5]
        "stpde_jet_bf16_ring": ([_I, _I, _P], None),
        "stpde_jet_bf16_tn_plan": ([_L, _I, _I, _P], None),
    },
    "tridiag": {
        # rhs, lower, c, inv, x, nz, nk, zero_rows, stream
        "stpde_tridiag_solve": ([_P] * 5 + [_I] * 3 + [_P], _I),
    },
}

_libs = {}
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


def _tag() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    files = [_CSRC / f"{name}.cu" for name in _SOURCES]
    for path in files + sorted(_CSRC.glob("*.cuh")):
        h.update(path.name.encode() + path.read_bytes())
    return h.hexdigest()[:16]


def _build_all() -> None:
    tag = _tag()
    targets = {name: _BUILD / f"libstpde_{name}_{tag}.so"
               for name in _SOURCES}
    todo = {n: so for n, so in targets.items() if not so.exists()}
    if todo:
        _BUILD.mkdir(exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for name, so in todo.items():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu: nvcc failed ({proc.returncode}):"
                              f"\n{out}{err}")
                continue
            os.replace(tmp, todo[name])
            _log[name] = err.strip()
        if failed:
            raise RuntimeError("\n".join(failed))
        _log["seconds"] = time.perf_counter() - t0
    for name, so in targets.items():
        lib = ctypes.CDLL(str(so))
        for fn_name, (argtypes, restype) in _ARGTYPES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, restype
        _libs[name] = lib


def load(name: str = "fused_query"):
    """The ``ctypes`` library of ``csrc/<name>.cu``; the first call
    compiles every source (in parallel) and loads them all."""
    if name not in _SOURCES:
        raise KeyError(f"no kernel source {name!r}; have {_SOURCES}")
    if not _libs:
        _build_all()
    return _libs[name]


def library_path(name: str) -> Path:
    """The built shared library of ``csrc/<name>.cu`` (after :func:`load`)."""
    load(name)
    return _BUILD / f"libstpde_{name}_{_tag()}.so"


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = load("fused_query").stpde_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def build_log() -> dict:
    """``{"seconds", <source>: ptxas output}`` of the build this process
    ran (empty if the libraries were already built)."""
    return dict(_log)
