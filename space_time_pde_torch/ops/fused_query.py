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

On a CUDA tensor a wrapper launches its kernel (``csrc/fused_query.cu``
at f32, ``csrc/fused_query_bf16.cu`` at bf16) or raises; on a CPU tensor
it runs the plain PyTorch twin in this module
(:func:`decode_blend_gather_plain`, :func:`decode_blend_plain`), which
the CPU tests hold against JAX and ``chip_smoke.py`` holds the kernels
against on the card. The kernels have no backward, so the wrappers run
under ``no_grad`` on every device; the twins themselves stay
differentiable.

The f32 kernel (``csrc/fused_query.cu``, both f32 entries) runs its
products on Hopper's ``wgmma`` in 3xTF32 (each f32 operand split into
two TF32 parts, three products per k8 step into a temporary that is
added to an f32 accumulator outside the tensor cores) on 64 corner rows
a tile (:func:`block_points`). It takes its weights as one image of its
shared-memory stages with each weight split into TF32 hi and lo planes
(:func:`decode_tiles` at ``compute_dtype=torch.float32``), which a
decoder builds once and hands to every launch (``tiles=``).

Dropped from the TPU module, with nothing in their place: the one-hot
MXU gather, ``corner_tables`` and the sorted 2 x 128-cell windows
(window anchors, the fits-check and its ``lax.cond`` pregather
fallback, the sort/unsort, ``points_sorted``), ``_FRAC_LANES`` and
128-lane padding (``pad_to``): an H100 thread loads a cell's row by its
id, so any point order decodes on one path. (``_augmented_xs`` /
``_augment_params`` have a counterpart in the bf16 kernel only: its X
operand carries bf16(frac) and corner one-hot columns.)

``compute_dtype=torch.bfloat16`` (the JAX kernels' default, the bf16
policy's decode) runs each entry's bf16 kernel
(``csrc/fused_query_bf16.cu``: thread-block clusters, weight stages
multicast through an mbarrier ring, wgmma): bf16 latent rows, bf16
weights, Hopper's bf16 tensor cores, rounding where its TPU kernel
rounds. The gather entry (``stpde_decode_blend_gather_bf16``, counted
under ``decode_blend_gather_bf16``) rounds as ``_kernel_gather``
(:func:`decode_blend_gather_plain`); the pre-gathered one
(``stpde_decode_blend_bf16``, counted under ``decode_blend_bf16``) as
``_kernel``, which keeps ``corner_bias`` f32 and rounds the whole skip
term to bf16 (:func:`decode_blend_plain`). That kernel takes its weights
as one image of its shared-memory stages, :func:`decode_tiles`, which a
decoder builds once and hands to every launch (``tiles=``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from space_time_pde_torch.models.nonlinearities import (
    ACTIVATION_CODES, get_activation)
from space_time_pde_torch.ops import _build
from space_time_pde_torch.ops.grid_interp import (
    _locate, _strides, corner_offsets)
from space_time_pde_torch.utils.constants import device_constant

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "block_points",
    "pack_imnet_params",
    "kernel_weights",
    "DecodeTiles",
    "decode_tiles",
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
# kernel_weights' padding (the mma.sync f32 kernel's layout before the
# wgmma one; the bf16 image and the CPU emulations build from it): widths
# to multiples of 64, the latent rows to multiples of 32.
_WIDTH_ALIGN, _C_ALIGN = 64, 32

# The bf16 decode kernel's tile (csrc/fused_query_bf16.cu): a pass takes
# at most 512 columns and a weight stage 16 KB.
_BF16_PASS, _BF16_STAGE = 512, 16384

# The f32 decode kernel's tile (csrc/fused_query.cu): nf <= 64 runs at the
# widths of the smallest base in _F32_BASES that holds it (zero-padded),
# h_0 computed in 64-column chunks, the latents (X) padded to 8 columns.
_F32_BASES, _F32_CHUNK = (16, 32, 64), 64
# Within each 8-row block of Wh_i, the row the kernel's k = 0..7 reads: a
# layer stores its activations in the A fragment's order, where a thread's
# columns 2t and 2t + 1 are the next layer's k = t and k = t + 4.
_F32_PERM = (0, 2, 4, 6, 1, 3, 5, 7)


def _f32_h_order(w: int) -> torch.Tensor:
    """The h column the f32 kernel's k reads, for k in [0, w)."""
    k = np.arange(w)
    return torch.from_numpy(k // 8 * 8 + np.array(_F32_PERM)[k % 8])

# The packed weights the bf16 instantiations round to bf16 (corner_bias and
# b5 stay f32, as the TPU's pack_imnet_params keeps them).
_ROUNDED = ("wx_feat", "wx_rel", "wh1", "wh2", "wh3", "wh4", "w5")

# Kernel launches per entry point (each bf16 instantiation apart); only the
# CUDA branch of a wrapper adds to them, and not under graph capture.
LAUNCHES = {"decode_blend_gather": 0, "decode_blend": 0,
            "decode_blend_gather_bf16": 0, "decode_blend_bf16": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _count(table, key) -> None:
    """One launch of ``key``'s kernel. A launch recorded into a CUDA graph
    (under capture) runs at each replay instead, which only a device
    trace sees: it is not counted."""
    if not torch.cuda.is_current_stream_capturing():
        table[key] += 1


def pack_imnet_params(imnet,
                      dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Repack an :class:`~space_time_pde_torch.models.imnet.ImNet`'s
    weights for the fused decode (the JAX ``pack_imnet_params`` with
    ``pad_to=0``; ``dtype=torch.bfloat16`` rounds the weights of
    ``_ROUNDED`` to bf16, as the JAX one at ``dtype=bfloat16``, with
    ``corner_bias`` folded from the unrounded ``wx_rel`` and ``b5`` f32).

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
    offs = device_constant(corner_offsets(dim), torch.float32,
                           wx_rel.device)
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
    out = {k: v.float().clone(memory_format=torch.contiguous_format)
           for k, v in packed.items()}
    if dtype != torch.float32:
        out.update({k: out[k].to(dtype) for k in _ROUNDED})
    return out


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def kernel_weights(packed, *, nf: int, dtype=torch.float32,
                   f32=("b5",)) -> Dict[str, torch.Tensor]:
    """:func:`pack_imnet_params`'s output per layer, stacked and padded:
    the layout of the earlier mma.sync f32 decode, which the bf16 image
    (:func:`decode_tiles`) and the CPU emulations of the kernels read.

    Layer widths are zero-padded to multiples of ``_WIDTH_ALIGN`` and the
    latent rows to a multiple of ``_C_ALIGN``; zero weights make the
    padding inert whatever the activation gives at 0.

    - ``wx0`` ``[Cp, W0]``: layer 0's latent projection;
    - ``rel`` ``[D, Sp]``, ``cb`` ``[2^D, Sp]``: ``wx_rel`` and
      ``corner_bias``, each layer's columns at their padded offset;
    - ``wb1..wb4`` ``[W_{i-1} + Cp, W_i]``: ``[Wh_i ; Wx_feat[:, sl_i]]``,
      so one K loop over ``[h_{i-1} | latents]`` gives the hidden product
      and the skip term together;
    - ``w5``, ``b5`` as packed.

    ``dtype=torch.bfloat16`` gives the bf16 instantiations' weights: all
    but those named in ``f32`` rounded to bf16 (the gather entry's ``cb``
    from the f32 ``corner_bias``, as the TPU kernel's ``_augment_params``
    rounds it; the pre-gathered entry keeps ``cb`` f32 too), and ``wx0``
    and ``wb1..wb4`` transposed (``[W, K]``, K contiguous: the layout of
    the bf16 tensor cores' B fragments).
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
            if k not in f32:
                out[k] = out[k].to(dtype)
    return {k: v.contiguous() for k, v in out.items()}


def _bf16_plan(c: int, dim: int, nf: int, pregathered: bool):
    """The bf16 kernel's widths (each layer's padded to a power of two
    >= 32), its X width kx (C latents, D frac, ``pieces`` bf16 columns of
    each corner's one-hot, padded to 16) and ``pieces`` (3 for the
    pre-gathered entry's f32 corner bias, else 1)."""
    pieces = 3 if pregathered else 1
    widths = [max(32, 1 << (nf * m - 1).bit_length()) for m in _MULTS]
    return widths, _round_up(c + dim + (pieces << dim), 16), pieces


def _bf16_schedule(widths, kx):
    """``(layer, c0, np, k0, kn)`` of every weight stage in the order the
    bf16 kernel consumes them: layer by layer, column passes of at most
    512, K (X first, then h) in stages of 8192 / np rows, the last one
    ragged."""
    for layer, w in enumerate(widths):
        k = kx + (widths[layer - 1] if layer else 0)
        np_ = min(w, _BF16_PASS)
        kd = _BF16_STAGE // (2 * np_)
        for c0 in range(0, w, np_):
            for k0 in range(0, k, kd):
                yield layer, c0, np_, k0, min(kd, k - k0)


class DecodeTiles(NamedTuple):
    """A decode kernel's weights (:func:`decode_tiles`): the bf16 kernel's
    or, at ``compute_dtype=torch.float32``, the f32 kernel's (the same
    image for both f32 entries)."""

    image: torch.Tensor     # [elements], stage after stage
    w5: torch.Tensor        # [nf, out] in the compute type
    b5: torch.Tensor        # [1, out] f32
    c: int
    dim: int
    nf: int
    pregathered: bool
    compute_dtype: torch.dtype = torch.bfloat16


def _bf16_layer_matrices(packed, *, nf: int, dim: int, pregathered: bool):
    """Each layer's B^T for the bf16 kernel, f32 holding bf16 values:
    ``[W_i, kx + W_{i-1}]`` (padded widths), columns ``[Wx_feat_i | Wx_rel_i
    | corner_bias_i pieces | 0 | Wh_i]``, from
    ``kernel_weights(dtype=bfloat16)`` (``f32=("b5", "cb")`` for the
    pre-gathered entry, whose f32 corner bias is split exactly into three
    bf16 pieces, hi + mid + lo)."""
    kw = kernel_weights(packed, nf=nf, dtype=torch.bfloat16,
                        f32=("b5", "cb") if pregathered else ("b5",))
    c = packed["wx_feat"].shape[0]
    widths, kx, pieces = _bf16_plan(c, dim, nf, pregathered)
    true = [nf * m for m in _MULTS]
    pad64 = [_round_up(w, _WIDTH_ALIGN) for w in true]
    offs = np.cumsum([0] + pad64)
    mats = []
    for i in range(5):
        cols = slice(int(offs[i]), int(offs[i]) + true[i])
        b = torch.zeros(widths[i], kx + (widths[i - 1] if i else 0),
                        dtype=torch.float32, device=kw["rel"].device)
        lat = (kw["wx0"] if i == 0 else
               kw[f"wb{i}"][:, pad64[i - 1]:])[:true[i], :c]
        b[:true[i], :c] = lat.float()
        b[:true[i], c:c + dim] = kw["rel"][:, cols].t().float()
        rest = kw["cb"][:, cols].t().float()            # [w, 2^D]
        for j in range(pieces):
            piece = rest.to(torch.bfloat16).float()
            rest = rest - piece
            b[:true[i], c + dim + j:c + dim + (pieces << dim):pieces] = piece
        if i:
            b[:true[i], kx:kx + true[i - 1]] = \
                kw[f"wb{i}"][:true[i], :true[i - 1]].float()
        mats.append(b)
    return mats, kw


def _f32_base(nf: int) -> int:
    """The nf whose widths the f32 kernel runs for ``nf``: the smallest of
    ``_F32_BASES`` that holds it."""
    for base in _F32_BASES:
        if nf <= base:
            return base
    raise ValueError(f"the f32 decode kernel takes nf <= {_F32_BASES[-1]}, "
                     f"not {nf}")


def _f32_plan(c: int, nf: int):
    """The f32 kernel's widths (:func:`_f32_base`'s) and its X width kx
    (the C latents, padded to 8)."""
    return [_f32_base(nf) * m for m in _MULTS], _round_up(c, 8)


def _f32_schedule(widths, kx):
    """``(layer, c0, np, k0, kn)`` of every weight segment in the order
    the f32 kernel consumes them (rows c0:c0+np, K k0:k0+kn of layer
    ``layer``'s ``[W_i, kx + W_{i-1}]``): layer 0's first 64-column chunk,
    layer 1's X rows, then for each further chunk j + 1 the chunk and layer
    1's rows of chunk j, layer 1's rows of the last chunk, then layers 2-4,
    each its X rows and its h rows."""
    w1, nch = widths[1], widths[0] // _F32_CHUNK
    yield 0, 0, _F32_CHUNK, 0, kx
    yield 1, 0, w1, 0, kx
    for j in range(nch - 1):
        yield 0, _F32_CHUNK * (j + 1), _F32_CHUNK, 0, kx
        yield 1, 0, w1, kx + _F32_CHUNK * j, _F32_CHUNK
    yield 1, 0, w1, kx + _F32_CHUNK * (nch - 1), _F32_CHUNK
    for layer in range(2, 5):
        yield layer, 0, widths[layer], 0, kx
        yield layer, 0, widths[layer], kx, widths[layer - 1]


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _f32_layer_matrices(packed, *, nf: int):
    """Each layer's B^T for the f32 kernel, ``[W_i, kx + W_{i-1}]``
    (padded widths): columns ``[Wx_feat_i | 0 | Wh_i]``, the Wh_i rows of
    each 8-row block in the order of ``_F32_PERM``."""
    c = packed["wx_feat"].shape[0]
    widths, kx = _f32_plan(c, nf)
    true = [nf * m for m in _MULTS]
    bounds = np.cumsum([0] + true)
    mats = []
    for i in range(5):
        cols = slice(int(bounds[i]), int(bounds[i + 1]))
        b = torch.zeros(widths[i], kx + (widths[i - 1] if i else 0),
                        dtype=torch.float32,
                        device=packed["wx_feat"].device)
        b[:true[i], :c] = packed["wx_feat"][:, cols].t()
        if i:
            wp = widths[i - 1]
            wh = torch.zeros(widths[i], wp, dtype=torch.float32,
                             device=b.device)
            wh[:true[i], :true[i - 1]] = packed[f"wh{i}"].t()
            b[:, kx:] = wh[:, _f32_h_order(wp).to(b.device)]
        mats.append(b)
    return mats


def _f32_skip(packed, *, nf: int):
    """``wx_rel`` ``[D, S]`` and ``corner_bias`` ``[2^D, S]`` with each
    layer's columns at its offset in the f32 kernel's widths (S = 31 x
    :func:`_f32_base`), the rest 0: the kernel starts each accumulator at
    their f32 sum (the coordinate term and the corner bias)."""
    widths = [_f32_base(nf) * m for m in _MULTS]
    true = [nf * m for m in _MULTS]
    bounds, offs = np.cumsum([0] + true), np.cumsum([0] + widths)
    out = []
    for name in ("wx_rel", "corner_bias"):
        t = packed[name]
        z = torch.zeros(t.shape[0], int(offs[-1]), dtype=torch.float32,
                        device=t.device)
        for i in range(5):
            z[:, int(offs[i]):int(offs[i]) + true[i]] = \
                t[:, int(bounds[i]):int(bounds[i + 1])]
        out.append(z)
    return out


def _f32_image(packed, *, nf: int) -> torch.Tensor:
    """The f32 kernel's weight image: for each segment of
    :func:`_f32_schedule`, for each k8 step, the TF32 hi plane then the lo
    plane (``lo = tf32(w - hi)``), each in wgmma's K-major, no-swizzle B
    layout ``[8-column group][2 k halves][8 columns][4 k]``; then
    :func:`_f32_skip`'s ``rel`` and ``cb``, f32 as they are."""
    mats = _f32_layer_matrices(packed, nf=nf)
    c = packed["wx_feat"].shape[0]
    widths, kx = _f32_plan(c, nf)
    parts = []
    for layer, c0, np_, k0, kn in _f32_schedule(widths, kx):
        blk = mats[layer][c0:c0 + np_, k0:k0 + kn]
        hi = _tf32(blk)
        lo = _tf32(blk - hi)
        planes = torch.stack([hi, lo])          # [2, np, kn]
        parts.append(planes.reshape(2, np_ // 8, 8, kn // 8, 2, 4).permute(
            3, 0, 1, 4, 2, 5).reshape(-1))
    parts += [t.reshape(-1) for t in _f32_skip(packed, nf=nf)]
    return torch.cat(parts)


def decode_tiles(packed, *, nf: int, dim: int, pregathered: bool = False,
                 compute_dtype=torch.bfloat16) -> DecodeTiles:
    """A decode kernel's weights, built once per decoder, so the kernel
    loads each of its ring stages with one bulk copy; plus the head's
    weights (w5 in the compute type, b5 f32).

    - bf16 (csrc/fused_query_bf16.cu): every stage of
      :func:`_bf16_schedule` in the exact shared-memory image of wgmma's
      K-major, no-swizzle B operand, one contiguous bf16 run a stage
      (``[k16 block][8-column group][2 k halves][8 columns][8 k]``).
      ``pregathered`` picks the entry (:func:`decode_blend`'s, corner bias
      f32) or the gather one's.
    - f32 (csrc/fused_query.cu, ``compute_dtype=torch.float32``):
      :func:`_f32_image`, each weight split into TF32 hi and lo planes;
      one image serves both f32 entries."""
    if compute_dtype == torch.float32:
        with torch.no_grad():
            image = _f32_image(packed, nf=nf)
        return DecodeTiles(image, packed["w5"].contiguous(),
                           packed["b5"].contiguous(),
                           packed["wx_feat"].shape[0], dim, nf, pregathered,
                           torch.float32)
    mats, kw = _bf16_layer_matrices(packed, nf=nf, dim=dim,
                                    pregathered=pregathered)
    c = packed["wx_feat"].shape[0]
    widths, kx, _ = _bf16_plan(c, dim, nf, pregathered)
    parts = []
    for layer, c0, np_, k0, kn in _bf16_schedule(widths, kx):
        blk = mats[layer][c0:c0 + np_, k0:k0 + kn]
        parts.append(blk.reshape(np_ // 8, 8, kn // 16, 2, 8).permute(
            2, 0, 3, 1, 4).reshape(-1))
    image = torch.cat(parts).to(torch.bfloat16)
    return DecodeTiles(image, kw["w5"], kw["b5"], c, dim, nf, pregathered)


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
    strides = device_constant(_strides([s - 1 for s in spatial]),
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
                       negative_slope: float = 0.01,
                       compute_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch twin of :func:`decode_blend`: feats2 ``[N*K, C]``,
    frac ``[N, D]`` -> ``[N, out]``.

    At ``compute_dtype=torch.bfloat16`` it rounds where the TPU's
    ``_kernel`` does (:func:`_decode_bf16`, ``pregathered``): as the
    gather twin, except that ``corner_bias`` stays f32 and the whole skip
    term is rounded to bf16 before each layer adds it."""
    if compute_dtype != torch.float32:
        return _decode_bf16(feats2, frac, packed, nf=nf,
                            act=get_activation(activation, negative_slope),
                            pregathered=True)
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
    return _decode_bf16(feats2, frac, packed, nf=nf,
                        act=get_activation(activation, negative_slope),
                        pregathered=False)


def _decode_bf16(feats2, frac, packed, *, nf: int, act, pregathered: bool):
    """The bf16 decode of both TPU kernels, products of bf16 values in f32
    (exact): ``pregathered`` rounds as ``_kernel`` (the skip term
    ``feats @ wx_feat + (frac @ wx_rel + corner_bias)`` rounded to bf16 as
    a whole, ``corner_bias`` f32), else as ``_kernel_gather``
    (``corner_bias`` rounded, the skip term f32)."""
    rnd = lambda t: t.to(torch.bfloat16).float()
    n, dim = frac.shape
    n_corners = 2 ** dim
    feats = rnd(feats2).reshape(n, n_corners, feats2.shape[-1])
    bounds = np.cumsum([0] + [nf * m for m in _MULTS])
    xr = (rnd(frac) @ rnd(packed["wx_rel"]))[:, None]
    if pregathered:
        xs = rnd(feats @ rnd(packed["wx_feat"])
                 + (xr + packed["corner_bias"].float()[None]))
    else:
        xs = (feats @ rnd(packed["wx_feat"]) + xr
              + rnd(packed["corner_bias"])[None])   # [N, K, S] f32
    sl = [slice(int(bounds[i]), int(bounds[i + 1])) for i in range(5)]
    h = act(xs[..., sl[0]])
    for i in range(1, 5):
        h = act(rnd(h) @ rnd(packed[f"wh{i}"]) + xs[..., sl[i]])
    hblend = (h * _corner_weights(frac)[..., None]).sum(dim=1)
    return rnd(hblend) @ rnd(packed["w5"]) + packed["b5"]


def _check(tensors: Dict[str, torch.Tensor], packed, *, n: int, c: int,
           dim: int, nf: int, compute_dtype=torch.float32,
           packed_dtype=torch.float32) -> torch.device:
    """Device, dtype, shape and contiguity checks shared by the decode and
    jet wrappers (the latent rows, ``table`` or ``feats2``, in
    ``compute_dtype``; the packed weights of ``_ROUNDED`` in
    ``packed_dtype``, the rest f32); returns the common device."""
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
                "feats2": compute_dtype}.get(
                    name, packed_dtype if name in _ROUNDED else torch.float32)
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


def block_points(dim: int, device,
                 compute_dtype=torch.float32) -> int | None:
    """Points a kernel block (the bf16 kernel: a CTA's tile) of the
    ``compute_dtype`` decode takes at a time on ``device`` (None on the
    CPU, where the plain twin has no blocks): 64 corner rows in both, 8
    points at D = 3 and 4 at D = 4. Each kernel owns its tile and
    shared-memory plan; a launch whose nf and C need more shared memory
    than the card has returns the CUDA error, and the wrapper raises
    it."""
    if torch.device(device).type != "cuda":
        return None
    if compute_dtype == torch.bfloat16:
        return _build.load("fused_query_bf16").stpde_block_rows_bf16() >> dim
    return _build.load().stpde_block_rows() >> dim


def _launch(entry, rows, frac, packed, tiles, *, nf, dim, c, pregathered,
            args, activation, negative_slope, compute_dtype):
    """Launch the ``compute_dtype`` decode kernel of ``entry`` with
    ``tiles`` (built here when None) and count it. The f32 image serves
    both entries; the bf16 ones differ."""
    if tiles is None:
        tiles = decode_tiles(packed, nf=nf, dim=dim, pregathered=pregathered,
                             compute_dtype=compute_dtype)
    bf16 = compute_dtype == torch.bfloat16
    have = (tiles.c, tiles.dim, tiles.nf, tiles.compute_dtype,
            tiles.pregathered if bf16 else None)
    want = (c, dim, nf, compute_dtype, pregathered if bf16 else None)
    if have != want or tiles.image.device != frac.device:
        raise ValueError(f"tiles are for C={tiles.c} D={tiles.dim} "
                         f"nf={tiles.nf} {tiles.compute_dtype} "
                         f"pregathered={tiles.pregathered} on "
                         f"{tiles.image.device}, not C={c} D={dim} nf={nf} "
                         f"{compute_dtype} pregathered={pregathered} on "
                         f"{frac.device}")
    n = frac.shape[0]
    out = torch.empty((n, tiles.w5.shape[-1]), dtype=torch.float32,
                      device=frac.device)
    lib = _build.load("fused_query_bf16" if bf16 else "fused_query")
    code = getattr(lib, "stpde_" + entry)(
        rows.data_ptr(), *args, frac.data_ptr(), tiles.image.data_ptr(),
        tiles.image.numel(), tiles.w5.data_ptr(), tiles.b5.data_ptr(),
        out.data_ptr(), n, *([] if pregathered else [rows.shape[0]]), c,
        dim, nf, out.shape[-1], ACTIVATION_CODES[activation],
        negative_slope, torch.cuda.current_stream(frac.device).cuda_stream)
    _build.check(code, entry)
    _count(LAUNCHES, entry)
    return out


@torch.no_grad()
def decode_blend_gather(table, cell_flat, frac, packed, *, nf: int,
                        activation: str = "leaky_relu",
                        negative_slope: float = 0.01,
                        compute_dtype=torch.float32,
                        tiles: DecodeTiles | None = None) -> torch.Tensor:
    """Decode with the gather fused in: table ``[n_cells, 2^D * C]``
    (:func:`cell_major_features`) in ``compute_dtype`` (f32, or bf16 for
    the bf16 kernel), cell_flat ``[N]`` int32, frac ``[N, D]`` f32 ->
    ``[N, out]`` f32. A cell id outside the table decodes NaN on the card
    (the plain twin raises an IndexError). ``tiles``: the kernel's
    weights, ``decode_tiles(packed, ..., compute_dtype=compute_dtype)``
    built once by the caller (else per launch)."""
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
    entry = "decode_blend_gather" + (
        "_bf16" if compute_dtype == torch.bfloat16 else "")
    return _launch(entry, table, frac, packed, tiles, nf=nf, dim=dim, c=c,
                   pregathered=False, args=[cell_flat.data_ptr()],
                   activation=activation, negative_slope=negative_slope,
                   compute_dtype=compute_dtype)


@torch.no_grad()
def decode_blend(feats2, frac, packed, *, nf: int, n_corners: int,
                 activation: str = "leaky_relu",
                 negative_slope: float = 0.01,
                 compute_dtype=torch.float32,
                 tiles: DecodeTiles | None = None) -> torch.Tensor:
    """Decode pre-gathered corner rows: feats2 ``[N * 2^D, C]`` in
    ``compute_dtype`` (f32, or bf16 for the bf16 kernel), frac ``[N, D]``
    f32 -> ``[N, out]`` f32. ``tiles``: as :func:`decode_blend_gather`'s,
    ``decode_tiles(..., pregathered=True)`` at bf16 (the f32 image is the
    gather entry's)."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"compute_dtype {compute_dtype}: the "
                                  "decode kernel has f32 and bf16 "
                                  "instantiations")
    n, dim = frac.shape
    if n_corners != 2 ** dim:
        raise ValueError(f"n_corners {n_corners} != 2**{dim}")
    if feats2.ndim != 2 or feats2.shape[0] != n * n_corners:
        raise ValueError(f"feats2 must be [{n}*{n_corners}, C], got "
                         f"{tuple(feats2.shape)}")
    c = feats2.shape[-1]
    device = _check({"feats2": feats2, "frac": frac}, packed, n=n, c=c,
                    dim=dim, nf=nf, compute_dtype=compute_dtype)
    if device.type == "cpu":
        return decode_blend_plain(feats2, frac, packed, nf=nf,
                                  n_corners=n_corners, activation=activation,
                                  negative_slope=negative_slope,
                                  compute_dtype=compute_dtype)
    entry = "decode_blend" + (
        "_bf16" if compute_dtype == torch.bfloat16 else "")
    return _launch(entry, feats2, frac, packed, tiles, nf=nf, dim=dim, c=c,
                   pregathered=True, args=[], activation=activation,
                   negative_slope=negative_slope,
                   compute_dtype=compute_dtype)


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
    the TPU path's ``gcast``; each entry at its own TPU kernel's rounding
    points).
    """
    if gather not in ("kernel", "pregather"):
        raise ValueError(f"gather must be 'kernel' or 'pregather', got "
                         f"{gather!r}")
    packed = pack_imnet_params(imnet)
    common = dict(nf=imnet.nf, activation=imnet.activation,
                  negative_slope=imnet.negative_slope)
    if latent_grid.is_cuda:
        common["tiles"] = decode_tiles(packed, nf=imnet.nf,
                                       dim=latent_grid.ndim - 2,
                                       pregathered=gather == "pregather",
                                       compute_dtype=compute_dtype)
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
