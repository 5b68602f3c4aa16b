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
``chip_smoke.py`` holds the kernels against on the card. The kernels
have no backward, so the wrappers run under ``no_grad`` on every
device; the twins themselves stay differentiable.

The kernel runs its products on the tensor cores in 3xTF32 (each f32
operand split into two TF32 parts, three products, f32 accumulation) on
64 corner rows a block (:func:`block_points`). It takes its weights in
the layout of :func:`kernel_weights`, which the CUDA branch of each
wrapper builds from :func:`pack_imnet_params`'s output: each layer's
``[Wh_i ; Wx_feat[:, sl_i]]`` stacked, widths zero-padded to multiples
of 64 and C to a multiple of 32.

Dropped from the TPU module, with nothing in their place: the one-hot
MXU gather, ``corner_tables`` and the sorted 2 x 128-cell windows
(window anchors, the fits-check and its ``lax.cond`` pregather
fallback, the sort/unsort, ``points_sorted``), ``_augmented_xs`` /
``_augment_params`` / ``_FRAC_LANES`` and 128-lane padding
(``pad_to``): an H100 thread loads a cell's row by its id, so any point
order decodes on one path.

``compute_dtype=torch.bfloat16`` (the JAX kernels' default, the bf16
policy's decode) is the gather entry's second instantiation: a bf16
table, bf16 weights and Hopper's bf16 tensor cores
(``stpde_decode_blend_gather_bf16``, counted under
``decode_blend_gather_bf16``), rounding where ``_kernel_gather`` rounds
(:func:`decode_blend_gather_plain`). The pre-gathered entry is f32 only:
its TPU kernel rounds at other places (``corner_bias`` kept f32, the
skip buffer stored bf16), and a bf16 request raises
``NotImplementedError`` (ROADMAP queue 2).
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
    "kernel_weights",
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
# The kernel's padding: widths to its 8 column warps x 8 columns, the
# latent rows to its 32-row weight tile (csrc/fused_query.cu).
_WIDTH_ALIGN, _C_ALIGN = 64, 32

# Kernel launches per entry point (the gather entry's bf16 instantiation
# apart); only the CUDA branch of a wrapper adds to them.
LAUNCHES = {"decode_blend_gather": 0, "decode_blend": 0,
            "decode_blend_gather_bf16": 0}


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

    Differentiable: every packed tensor is built from ``fc0..fc5`` by
    slicing, concatenation and that fold, so autograd carries the packed
    gradients (the jet backward kernel's) back to the layers. The eval
    path runs under ``no_grad`` and builds no graph.
    """
    dim, nf = imnet.dim, imnet.nf
    widths = [nf * m for m in _MULTS]
    ks = [getattr(imnet, f"fc{i}").weight.t() for i in range(6)]
    bs = [getattr(imnet, f"fc{i}").bias for i in range(6)]
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
    # Fresh contiguous copies: a view of a parameter taken under
    # no_grad would still require grad.
    return {k: v.float().clone(memory_format=torch.contiguous_format)
            for k, v in packed.items()}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def kernel_weights(packed, *, nf: int,
                   dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """:func:`pack_imnet_params`'s output in the decode kernel's layout,
    in the order of its C arguments.

    Layer widths are zero-padded to multiples of ``_WIDTH_ALIGN`` (a
    block's 8 column warps x 8 columns) and the latent rows to a multiple
    of ``_C_ALIGN`` (the kernel's K tile), as the kernel derives them from
    nf and C; zero weights make the padding inert whatever the activation
    gives at 0.

    - ``wx0`` ``[Cp, W0]``: layer 0's latent projection;
    - ``rel`` ``[D, Sp]``, ``cb`` ``[2^D, Sp]``: ``wx_rel`` and
      ``corner_bias``, each layer's columns at their padded offset;
    - ``wb1..wb4`` ``[W_{i-1} + Cp, W_i]``: ``[Wh_i ; Wx_feat[:, sl_i]]``,
      so one K loop over ``[h_{i-1} | latents]`` gives the hidden product
      and the skip term together;
    - ``w5``, ``b5`` as packed.

    ``dtype=torch.bfloat16`` gives the bf16 instantiation's weights: all
    but ``b5`` rounded to bf16 (``cb`` from the f32 ``corner_bias``, as
    the TPU kernel's ``_augment_params`` rounds it), and ``wx0`` and
    ``wb1..wb4`` transposed (``[W, K]``, K contiguous: the layout of the
    bf16 tensor cores' B fragments).
    """
    c = packed["wx_feat"].shape[0]
    widths = [nf * m for m in _MULTS]
    padded = [_round_up(w, _WIDTH_ALIGN) for w in widths]
    bounds = np.cumsum([0] + widths)

    def cols(t, i):
        sl = t[:, int(bounds[i]):int(bounds[i + 1])]
        return torch.nn.functional.pad(sl, (0, padded[i] - widths[i]))

    wxf = torch.nn.functional.pad(packed["wx_feat"],
                                  (0, 0, 0, _round_up(c, _C_ALIGN) - c))
    out = {"wx0": cols(wxf, 0),
           "rel": torch.cat([cols(packed["wx_rel"], i) for i in range(5)], 1),
           "cb": torch.cat([cols(packed["corner_bias"], i)
                            for i in range(5)], 1)}
    for i in range(1, 5):
        wh = torch.nn.functional.pad(
            packed[f"wh{i}"], (0, padded[i] - widths[i],
                               0, padded[i - 1] - widths[i - 1]))
        out[f"wb{i}"] = torch.cat([wh, cols(wxf, i)], 0)
    out["w5"], out["b5"] = packed["w5"], packed["b5"]
    if dtype != torch.float32:
        for k in out:
            if k == "wx0" or k.startswith("wb"):
                out[k] = out[k].t()
            if k != "b5":
                out[k] = out[k].to(dtype)
    return {k: v.contiguous() for k, v in out.items()}


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
                              negative_slope: float = 0.01,
                              compute_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch twin of :func:`decode_blend_gather`.

    At ``compute_dtype=torch.bfloat16`` it rounds where the TPU's
    ``_kernel_gather`` does and multiplies in f32 (a product of two bf16
    values is exact in f32): the table (already bf16), frac for the skip
    product (the blend weights take the f32 frac), ``wx_feat``,
    ``wx_rel``, ``corner_bias`` (from the unrounded ``wx_rel``), each
    ``Wh_i`` and ``w5`` to bf16; the skip term and every layer's
    pre-activation and activation in f32; h rounded to bf16 before each
    ``Wh_i`` product; the blend in f32 and ``hblend`` rounded before the
    head; ``b5`` f32."""
    n_corners = 2 ** frac.shape[-1]
    c = table.shape[-1] // n_corners
    feats2 = table[cell_flat.long()].reshape(-1, c)
    if compute_dtype == torch.float32:
        return decode_blend_plain(feats2, frac, packed, nf=nf,
                                  n_corners=n_corners, activation=activation,
                                  negative_slope=negative_slope)
    rnd = lambda t: t.to(compute_dtype).float()
    n = frac.shape[0]
    feats = rnd(feats2).reshape(n, n_corners, c)
    act = get_activation(activation, negative_slope)
    bounds = np.cumsum([0] + [nf * m for m in _MULTS])
    xs = (feats @ rnd(packed["wx_feat"])
          + (rnd(frac) @ rnd(packed["wx_rel"]))[:, None]
          + rnd(packed["corner_bias"])[None])       # [N, K, S] f32
    sl = [slice(int(bounds[i]), int(bounds[i + 1])) for i in range(5)]
    h = act(xs[..., sl[0]])
    for i in range(1, 5):
        h = act(rnd(h) @ rnd(packed[f"wh{i}"]) + xs[..., sl[i]])
    hblend = (h * _corner_weights(frac)[..., None]).sum(dim=1)
    return rnd(hblend) @ rnd(packed["w5"]) + packed["b5"]


def _check(tensors: Dict[str, torch.Tensor], packed, *, n: int, c: int,
           dim: int, nf: int, compute_dtype=torch.float32) -> torch.device:
    """Device, dtype, shape and contiguity checks shared by both
    wrappers (the latent rows, ``table`` or ``feats2``, in
    ``compute_dtype``, the packed weights f32); returns the common
    device."""
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
        want = {"cell_flat": torch.int32, "table": compute_dtype,
                "feats2": compute_dtype}.get(name, torch.float32)
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
    where the plain twin has no blocks): 64 corner rows, 8 points at
    D = 3 and 4 at D = 4. The kernel owns its block shape and
    shared-memory size; a launch whose nf and C need more shared memory
    than the card has (nf above 64, or C above 96 at nf = 64) returns
    the CUDA error, and the wrapper raises it."""
    if torch.device(device).type != "cuda":
        return None
    return _build.load().stpde_block_rows() >> dim


@torch.no_grad()
def decode_blend_gather(table, cell_flat, frac, packed, *, nf: int,
                        activation: str = "leaky_relu",
                        negative_slope: float = 0.01,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """Decode with the gather fused in: table ``[n_cells, 2^D * C]``
    (:func:`cell_major_features`) in ``compute_dtype`` (f32, or bf16 for
    the bf16 instantiation), cell_flat ``[N]`` int32, frac ``[N, D]``
    f32 -> ``[N, out]`` f32. A cell id outside the table decodes NaN on
    the card (the plain twin raises an IndexError)."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"compute_dtype {compute_dtype}: the "
                                  "decode kernel has f32 and bf16 "
                                  "instantiations")
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
                    packed, n=n, c=c, dim=dim, nf=nf,
                    compute_dtype=compute_dtype)
    if device.type == "cpu":
        return decode_blend_gather_plain(
            table, cell_flat, frac, packed, nf=nf, activation=activation,
            negative_slope=negative_slope, compute_dtype=compute_dtype)
    lib = _build.load()
    out = torch.empty((n, packed["w5"].shape[-1]), dtype=torch.float32,
                      device=device)
    kw = kernel_weights(packed, nf=nf, dtype=compute_dtype)
    bf16 = compute_dtype == torch.bfloat16
    entry = "decode_blend_gather" + ("_bf16" if bf16 else "")
    code = getattr(lib, "stpde_" + entry)(
        table.data_ptr(), cell_flat.data_ptr(), frac.data_ptr(),
        *[w.data_ptr() for w in kw.values()], out.data_ptr(),
        n, table.shape[0], c, dim, nf, out.shape[-1],
        ACTIVATION_CODES[activation], negative_slope,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(code, entry)
    LAUNCHES[entry] += 1
    return out


@torch.no_grad()
def decode_blend(feats2, frac, packed, *, nf: int, n_corners: int,
                 activation: str = "leaky_relu",
                 negative_slope: float = 0.01,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """Decode pre-gathered corner rows: feats2 ``[N * 2^D, C]``, frac
    ``[N, D]`` -> ``[N, out]`` f32. f32 only: a bf16 ``compute_dtype``
    raises ``NotImplementedError`` (ROADMAP queue 2)."""
    if compute_dtype != torch.float32:
        raise NotImplementedError(
            f"compute_dtype {compute_dtype}: the bf16 pre-gathered decode "
            "(decode_blend's _kernel instantiation, ROADMAP queue 2) is not "
            "ported")
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
    kw = kernel_weights(packed, nf=nf)
    code = lib.stpde_decode_blend(
        feats2.data_ptr(), frac.data_ptr(),
        *[w.data_ptr() for w in kw.values()], out.data_ptr(),
        n, c, dim, nf, out.shape[-1], ACTIVATION_CODES[activation],
        negative_slope, torch.cuda.current_stream(device).cuda_stream)
    _build.check(code, "decode_blend")
    LAUNCHES["decode_blend"] += 1
    return out


@torch.no_grad()
def fused_query_local_implicit_grid(imnet, latent_grid, pts, xmin=0.0,
                                    xmax=1.0, gather: str = "kernel",
                                    compute_dtype=torch.float32):
    """Fused counterpart of ``models.query_local_implicit_grid``:
    latent_grid ``[B, *spatial, C]``, pts ``[B, N, D]`` -> ``[B, N, out]``.
    Inference only (the decode kernels have no backward; training takes
    its values from the jet, ``ops/fused_jet.py``), so it runs under
    ``no_grad`` on every device.

    ``gather``: "kernel" loads each point's cell row inside the kernel
    (:func:`decode_blend_gather`); "pregather" gathers ``[N*2^D, C]``
    rows first and runs :func:`decode_blend`. Both take any point order.
    ``compute_dtype``: f32, or bf16 (the latent table rounded to bf16, as
    the TPU path's ``gcast``; "kernel" only, as JAX's "auto" takes the
    gather kernel: "pregather" raises ``NotImplementedError``).
    """
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
        table = cell_major_features(grid.to(compute_dtype)).contiguous()
        if gather == "kernel":
            outs.append(decode_blend_gather(table, cell_flat, frac, packed,
                                            compute_dtype=compute_dtype,
                                            **common))
        else:
            feats2 = table[cell_flat.long()].reshape(-1, grid.shape[-1])
            outs.append(decode_blend(feats2, frac, packed,
                                     n_corners=2 ** len(spatial),
                                     compute_dtype=compute_dtype, **common))
    return torch.stack(outs)
