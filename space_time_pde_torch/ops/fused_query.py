"""Fused local-implicit-grid decode: CUDA kernels and their plain twins.

Counterpart of ``space_time_pde_tpu/ops/fused_query.py``. Per query
point: the 2^D corner latents of its cell, the ImNet chain on
``[frac - offset_k ⊕ latent_k]`` for every corner k, and the
multilinear blend BEFORE the linear head (the weights sum to 1, so
``sum_k w_k (h_k W5 + b5) == (sum_k w_k h_k) W5 + b5``).

Entry points, each a wrapper with a plain-integer launch count in
``LAUNCHES``:

- :func:`decode_blend_gather` — cell-major table + flat cell ids
  (replaces the Pallas ``_kernel_gather``);
- :func:`decode_blend` — pre-gathered corner rows (replaces the Pallas
  ``_kernel``).

On a CUDA tensor a wrapper launches its kernel
(``csrc/fused_query.cu``) or raises; on a CPU tensor it runs the plain
PyTorch twin in this module (:func:`decode_blend_gather_plain`,
:func:`decode_blend_plain`), which the CPU tests hold against JAX and
``chip_smoke.py`` holds the kernels against on the card.

Dropped from the TPU module, with nothing in their place: the one-hot
MXU gather, ``corner_tables`` and the sorted 2 x 128-cell windows
(window anchors, the fits-check and its ``lax.cond`` pregather
fallback, the sort/unsort, ``points_sorted``), ``_augmented_xs`` /
``_augment_params`` / ``_FRAC_LANES`` and 128-lane padding
(``pad_to``): an H100 thread loads a cell's row by its id, so any point
order decodes on one path. The kernels are f32 only; a bf16 request
raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from space_time_pde_torch.models.nonlinearities import (
    ACTIVATION_CODES, get_activation)
from space_time_pde_torch.ops import _build
from space_time_pde_torch.ops.grid_interp import (
    _locate, _strides, corner_offsets)

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "block_points",
    "pack_imnet_params",
    "cell_major_features",
    "decode_blend",
    "decode_blend_gather",
    "decode_blend_plain",
    "decode_blend_gather_plain",
    "fused_query_local_implicit_grid",
]

_MULTS = (16, 8, 4, 2, 1)
_WEIGHTS = ("wx_feat", "wx_rel", "corner_bias", "wh1", "wh2", "wh3", "wh4",
            "w5", "b5")

# Kernel launches per entry point; only the CUDA branch of a wrapper
# adds to them.
LAUNCHES = {"decode_blend_gather": 0, "decode_blend": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack_imnet_params(imnet) -> Dict[str, torch.Tensor]:
    """Repack an :class:`~space_time_pde_torch.models.imnet.ImNet`'s
    weights for the fused decode (the JAX ``pack_imnet_params`` with
    ``pad_to=0``, f32).

    Layer i >= 1 consumes ``[h, x]``, so its weight rows split into
    ``Wh_i`` and an x block; the x blocks of all five layers stack into
    ``wx_rel [D, S]`` (coordinate rows) and ``wx_feat [C, S]`` (latent
    rows), S = 31 nf. ``rel_k = frac - offset_k`` folds the per-corner
    constant into ``corner_bias[k] = b_all - offset_k @ wx_rel``.
    """
    dim, nf = imnet.dim, imnet.nf
    widths = [nf * m for m in _MULTS]
    ks = [getattr(imnet, f"fc{i}").weight.detach().t() for i in range(6)]
    bs = [getattr(imnet, f"fc{i}").bias.detach() for i in range(6)]
    wx_parts, wh = [ks[0]], []
    for i in range(1, 5):
        wh.append(ks[i][:widths[i - 1]])
        wx_parts.append(ks[i][widths[i - 1]:])
    wx_all = torch.cat(wx_parts, dim=1)
    b_all = torch.cat(bs[:5])[None]
    wx_rel = wx_all[:dim]
    offs = torch.as_tensor(corner_offsets(dim), dtype=torch.float32,
                           device=wx_rel.device)
    packed = {
        "wx_feat": wx_all[dim:],
        "wx_rel": wx_rel,
        "corner_bias": b_all - offs @ wx_rel,
        "w5": ks[5],
        "b5": bs[5][None],
    }
    packed.update({f"wh{i + 1}": w for i, w in enumerate(wh)})
    return {k: v.float().contiguous() for k, v in packed.items()}


def cell_major_features(grid: torch.Tensor) -> torch.Tensor:
    """``[*spatial, C]`` node grid -> ``[n_cells, 2^D * C]``: row c holds
    the latents of cell c's corners in :func:`corner_offsets` order."""
    spatial = grid.shape[:-1]
    dim = len(spatial)
    slices = [grid[tuple(slice(int(o[d]), spatial[d] - 1 + int(o[d]))
                         for d in range(dim))]
              for o in corner_offsets(dim)]
    cells = torch.stack(slices, dim=-2)             # [*cells, 2^D, C]
    n_cells = int(np.prod([s - 1 for s in spatial]))
    return cells.reshape(n_cells, -1)


def _flat_cells(cell: torch.Tensor, spatial) -> torch.Tensor:
    """``[N, D]`` cell indices -> ``[N]`` int32 flat ids (row-major)."""
    strides = torch.as_tensor(_strides([s - 1 for s in spatial]),
                              device=cell.device)
    return (cell.to(torch.int64) * strides).sum(-1).to(torch.int32)


def _corner_weights(frac: torch.Tensor) -> torch.Tensor:
    """``[N, D]`` fractions -> ``[N, 2^D]`` multilinear weights, each a
    product over axes in axis order (as the kernels form it)."""
    dim = frac.shape[-1]
    cols = []
    for o in corner_offsets(dim):
        col = None
        for d in range(dim):
            term = frac[:, d] if o[d] else 1.0 - frac[:, d]
            col = term if col is None else col * term
        cols.append(col)
    return torch.stack(cols, dim=1)


def decode_blend_plain(feats2, frac, packed, *, nf: int, n_corners: int,
                       activation: str = "leaky_relu",
                       negative_slope: float = 0.01) -> torch.Tensor:
    """Plain PyTorch twin of :func:`decode_blend`: feats2 ``[N*K, C]``,
    frac ``[N, D]`` -> ``[N, out]``."""
    n = frac.shape[0]
    feats = feats2.reshape(n, n_corners, feats2.shape[-1])
    act = get_activation(activation, negative_slope)
    bounds = np.cumsum([0] + [nf * m for m in _MULTS])

    def skip(i):                                    # [N, K, width_i]
        sl = slice(int(bounds[i]), int(bounds[i + 1]))
        return (feats @ packed["wx_feat"][:, sl]
                + (frac @ packed["wx_rel"][:, sl])[:, None]
                + packed["corner_bias"][None, :, sl])

    h = act(skip(0))
    for i in range(1, 5):
        h = act(h @ packed[f"wh{i}"] + skip(i))
    w = _corner_weights(frac)
    hblend = (h * w[..., None]).sum(dim=1)
    return hblend @ packed["w5"] + packed["b5"]


def decode_blend_gather_plain(table, cell_flat, frac, packed, *, nf: int,
                              activation: str = "leaky_relu",
                              negative_slope: float = 0.01) -> torch.Tensor:
    """Plain PyTorch twin of :func:`decode_blend_gather`."""
    n_corners = 2 ** frac.shape[-1]
    c = table.shape[-1] // n_corners
    feats2 = table[cell_flat.long()].reshape(-1, c)
    return decode_blend_plain(feats2, frac, packed, nf=nf,
                              n_corners=n_corners, activation=activation,
                              negative_slope=negative_slope)


def _check(tensors: Dict[str, torch.Tensor], packed, *, n: int, c: int,
           dim: int, nf: int) -> torch.device:
    """Device, dtype, shape and contiguity checks shared by both
    wrappers; returns the common device."""
    s = 31 * nf
    k = 2 ** dim
    shapes = {"wx_feat": (c, s), "wx_rel": (dim, s), "corner_bias": (k, s),
              "wh1": (16 * nf, 8 * nf), "wh2": (8 * nf, 4 * nf),
              "wh3": (4 * nf, 2 * nf), "wh4": (2 * nf, nf)}
    missing = [name for name in _WEIGHTS if name not in packed]
    if missing:
        raise KeyError(f"packed params lack {missing}")
    out_dim = packed["w5"].shape[-1]
    shapes.update(w5=(nf, out_dim), b5=(1, out_dim))
    frac = tensors["frac"]
    if tuple(frac.shape) != (n, dim):
        raise ValueError(f"frac must be [{n}, {dim}], got "
                         f"{tuple(frac.shape)}")
    everything = dict(tensors, **{name: packed[name] for name in _WEIGHTS})
    device = frac.device
    for name, t in everything.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, frac on {device}")
        want = torch.int32 if name == "cell_flat" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got "
                             f"{tuple(t.shape)}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no decode kernel for device {device}")
    return device


def block_points(dim: int, device) -> int | None:
    """Points a kernel block decodes on ``device`` (None on the CPU,
    where the plain twin has no blocks). The kernel owns its block shape
    and shared-memory size; a launch whose nf and C need more shared
    memory than the card has returns the CUDA error, and the wrapper
    raises it."""
    if torch.device(device).type != "cuda":
        return None
    return _build.load().stpde_block_rows() >> dim


def decode_blend_gather(table, cell_flat, frac, packed, *, nf: int,
                        activation: str = "leaky_relu",
                        negative_slope: float = 0.01) -> torch.Tensor:
    """Decode with the gather fused in: table ``[n_cells, 2^D * C]``
    (:func:`cell_major_features`), cell_flat ``[N]`` int32, frac
    ``[N, D]`` -> ``[N, out]`` f32. A cell id outside the table decodes
    NaN on the card (the plain twin raises an IndexError)."""
    n, dim = frac.shape
    k = 2 ** dim
    c = table.shape[-1] // k
    if table.ndim != 2 or table.shape[-1] != k * c:
        raise ValueError(f"table must be [n_cells, {k}*C], got "
                         f"{tuple(table.shape)}")
    if cell_flat.shape != (n,):
        raise ValueError(f"cell_flat must be [{n}], got "
                         f"{tuple(cell_flat.shape)}")
    device = _check({"table": table, "cell_flat": cell_flat, "frac": frac},
                    packed, n=n, c=c, dim=dim, nf=nf)
    if device.type == "cpu":
        return decode_blend_gather_plain(
            table, cell_flat, frac, packed, nf=nf, activation=activation,
            negative_slope=negative_slope)
    lib = _build.load()
    out = torch.empty((n, packed["w5"].shape[-1]), dtype=torch.float32,
                      device=device)
    code = lib.stpde_decode_blend_gather(
        table.data_ptr(), cell_flat.data_ptr(), frac.data_ptr(),
        *[packed[name].data_ptr() for name in _WEIGHTS], out.data_ptr(),
        n, table.shape[0], c, dim, nf, out.shape[-1],
        ACTIVATION_CODES[activation], negative_slope,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(code, "decode_blend_gather")
    LAUNCHES["decode_blend_gather"] += 1
    return out


def decode_blend(feats2, frac, packed, *, nf: int, n_corners: int,
                 activation: str = "leaky_relu",
                 negative_slope: float = 0.01) -> torch.Tensor:
    """Decode pre-gathered corner rows: feats2 ``[N * 2^D, C]``, frac
    ``[N, D]`` -> ``[N, out]`` f32."""
    n, dim = frac.shape
    if n_corners != 2 ** dim:
        raise ValueError(f"n_corners {n_corners} != 2**{dim}")
    if feats2.ndim != 2 or feats2.shape[0] != n * n_corners:
        raise ValueError(f"feats2 must be [{n}*{n_corners}, C], got "
                         f"{tuple(feats2.shape)}")
    c = feats2.shape[-1]
    device = _check({"feats2": feats2, "frac": frac}, packed, n=n, c=c,
                    dim=dim, nf=nf)
    if device.type == "cpu":
        return decode_blend_plain(feats2, frac, packed, nf=nf,
                                  n_corners=n_corners, activation=activation,
                                  negative_slope=negative_slope)
    lib = _build.load()
    out = torch.empty((n, packed["w5"].shape[-1]), dtype=torch.float32,
                      device=device)
    code = lib.stpde_decode_blend(
        feats2.data_ptr(), frac.data_ptr(),
        *[packed[name].data_ptr() for name in _WEIGHTS], out.data_ptr(),
        n, c, dim, nf, out.shape[-1], ACTIVATION_CODES[activation],
        negative_slope, torch.cuda.current_stream(device).cuda_stream)
    _build.check(code, "decode_blend")
    LAUNCHES["decode_blend"] += 1
    return out


def fused_query_local_implicit_grid(imnet, latent_grid, pts, xmin=0.0,
                                    xmax=1.0, gather: str = "kernel",
                                    compute_dtype=torch.float32):
    """Fused counterpart of ``models.query_local_implicit_grid``:
    latent_grid ``[B, *spatial, C]``, pts ``[B, N, D]`` -> ``[B, N, out]``.

    ``gather``: "kernel" loads each point's cell row inside the kernel
    (:func:`decode_blend_gather`); "pregather" gathers ``[N*2^D, C]``
    rows first and runs :func:`decode_blend`. Both take any point order.
    """
    if compute_dtype != torch.float32:
        raise NotImplementedError(
            f"compute_dtype {compute_dtype}: the port's decode kernels are "
            "f32 only (bf16 is later work; the flagship decodes f32)")
    if gather not in ("kernel", "pregather"):
        raise ValueError(f"gather must be 'kernel' or 'pregather', got "
                         f"{gather!r}")
    packed = pack_imnet_params(imnet)
    common = dict(nf=imnet.nf, activation=imnet.activation,
                  negative_slope=imnet.negative_slope)
    outs = []
    for grid, p in zip(latent_grid, pts):
        spatial = tuple(grid.shape[:-1])
        cell, frac = _locate(p.contiguous(), spatial, xmin, xmax)
        cell_flat = _flat_cells(cell, spatial)
        table = cell_major_features(grid).float().contiguous()
        if gather == "kernel":
            outs.append(decode_blend_gather(table, cell_flat, frac, packed,
                                            **common))
        else:
            feats2 = table[cell_flat.long()].reshape(-1, grid.shape[-1])
            outs.append(decode_blend(feats2, frac, packed,
                                     n_corners=2 ** len(spatial), **common))
    return torch.stack(outs)
