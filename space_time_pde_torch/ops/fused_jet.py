"""Fused derivative jet of the decode: CUDA kernels and their plain twins.

Counterpart of ``space_time_pde_tpu/ops/fused_jet.py``. For every
query point, the value, coordinate Jacobian and upper-triangle Hessian
(in frac units) of the local-implicit-grid decode: the ImNet primal
chain and D tangent chains that reuse its masks, the multilinear blend
of the 2^D corners with the weights' first and second frac
derivatives, and one linear head over all ``1 + D + D(D+1)/2`` jet
blocks, ``b5`` on the value block only (see ``csrc/fused_jet.cu`` for
the math).

Entry points, each a wrapper with a plain-integer launch count in
``LAUNCHES`` per instantiation (only the CUDA branch adds to it):

- :func:`jet_fwd` -- feats2 ``[N*2^D, C]``, frac ``[N, D]`` -> jet
  ``[N, blocks, O]`` (replaces the Pallas ``_jet_fwd_kernel``);
- :func:`jet_bwd` -- the jet's cotangent -> d feats2 and the 9 packed
  parameter gradients (replaces the Pallas ``_jet_bwd_kernel``);

and :func:`fused_query_jet`, the drop-in for
``ops.jet.query_local_implicit_grid_jet`` that trains through them: a
``torch.autograd.Function`` runs :func:`jet_fwd` and, in its backward,
:func:`jet_bwd` (``frac`` gets no gradient: query coordinates are
data). On a CUDA tensor a wrapper launches its kernel or raises; on a
CPU tensor it runs the plain twin in this module: :func:`jet_fwd_plain`
computes the forward math in PyTorch, and :func:`jet_bwd_plain` is
autograd through it at f32, a derivation independent of the backward
kernel.

Each kernel has two instantiations, by ``compute_dtype``:

- f32 (``csrc/fused_jet.cu``, ``jet_fwd`` / ``jet_bwd``): the matrix
  products in 3xTF32 on Hopper's ``wgmma`` (each operand split into a TF32
  high and low part, three products a k8 step, each step's sum promoted
  into an f32 accumulator: f32-grade results), the rest in f32. The
  weights' operands are one image that the forward splits on the card
  into its workspace (:func:`f32_weight_image` mirrors it);
- bf16 (``csrc/fused_jet_bf16.cu``, ``jet_fwd_bf16`` / ``jet_bwd_bf16``;
  the jet of ``--use_bf16 --pde_bf16``): bf16 rows and packed weights
  (``pack_imnet_params(dtype=bfloat16)``) on the bf16 tensor cores,
  rounding where the TPU kernels round at ``compute_dtype=bfloat16``.
  Its twins write those points out: :func:`jet_fwd_plain` with
  ``compute_dtype``, and :func:`jet_bwd_bf16_plain`, the backward
  kernel's math (not autograd, which would not round the cotangents
  where JAX does). The kernels return f32 gradients; the autograd
  Function rounds those of bf16 tensors to bf16, as the TPU's
  ``jet_bwd`` casts them, and :func:`fused_query_jet` gathers the rows
  from a bf16 cell table whose backward sums the latent's cotangent in
  f32 and rounds it to bf16 once (JAX sums it in bf16).

Both take D = 3 (8 corners, the rb2d family) and D = 4 (16 corners, the
turb3d family); another D raises ``NotImplementedError`` on the card, and
so does another ``compute_dtype``. A non-piecewise-linear activation
raises ``ValueError``; ``relu`` is LeakyReLU with slope 0.

Dropped from the TPU module, each a TPU workaround: ``_axis_onehot``
(tangent injections are indexed rows), the ``_rep`` mask tiling,
``pad_to`` 128-lane padding, the block-major per-grid-block output
layout and ``block_pts`` padding (the output is ``[N, blocks, O]``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from space_time_pde_torch.models.nonlinearities import PIECEWISE_LINEAR
from space_time_pde_torch.ops import _build
from space_time_pde_torch.ops.fused_query import (
    _MULTS, _ROUNDED, _WEIGHTS, _check, _count, _flat_cells,
    cell_major_features, pack_imnet_params)
from space_time_pde_torch.ops.grid_interp import (
    _locate, corner_offsets, locate_dfrac)
from space_time_pde_torch.ops.jet import multilinear_weight_jet
from space_time_pde_torch.utils.constants import device_constant

__all__ = [
    "LAUNCHES",
    "CAPTURED",
    "reset_launches",
    "tri_pairs",
    "jet_slope",
    "jet_fwd",
    "jet_bwd",
    "jet_fwd_plain",
    "jet_bwd_plain",
    "jet_bwd_bf16_plain",
    "workspace_masks",
    "bf16_tn_plan",
    "bf16_ring",
    "f32_chain_cols",
    "f32_ring",
    "f32_tn_plan",
    "f32_image_layout",
    "f32_weight_image",
    "workspace_image",
    "fused_query_jet",
]

KERNEL_DIMS = (3, 4)
BF16 = torch.bfloat16

LAUNCHES = {"jet_fwd": 0, "jet_bwd": 0, "jet_fwd_bf16": 0,
            "jet_bwd_bf16": 0}
# Launches recorded into a CUDA graph under capture (``fused_query.py``).
CAPTURED = dict.fromkeys(LAUNCHES, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = CAPTURED[k] = 0


def tri_pairs(dim: int):
    """Upper-triangle index pairs (a <= b) in jet-block order."""
    return [(a, b) for a in range(dim) for b in range(a, dim)]


def jet_slope(activation: str, negative_slope: float) -> float:
    """The mask's negative-side slope; raises for an activation whose
    second derivative is not zero in a cell."""
    if activation not in PIECEWISE_LINEAR:
        raise ValueError(
            f"fused jet requires a piecewise-linear activation, got "
            f"{activation!r}; available: {sorted(PIECEWISE_LINEAR)}")
    return 0.0 if activation == "relu" else float(negative_slope)


def _n_blocks(dim: int) -> int:
    return 1 + dim + len(tri_pairs(dim))




def _rounder(compute_dtype):
    """An f32 value rounded to ``compute_dtype`` and read back as f32 (the
    identity at f32, so the f32 and float64 twins compute as written)."""
    if compute_dtype == torch.float32:
        return lambda t: t
    return lambda t: t.to(compute_dtype).float()


def _chains(feats2, frac, packed, *, nf: int, slope: float, masks,
            compute_dtype, keep: bool):
    """The primal and tangent chains (the TPU's ``_forward_chains``):
    (h ``[N, K, nf]`` and g ``[N, K, D, nf]`` of layer 4, the five primal
    pre-activations ``[N, K, w_i]``, and with ``keep`` every layer's
    (h, g, mask)). Below f32 the bf16 values compute in f32 (their
    products are exact there), rounded where the TPU kernel rounds."""
    n, dim = frac.shape
    k = 2 ** dim
    low = compute_dtype != torch.float32
    rnd = _rounder(compute_dtype)
    if low:
        feats2 = feats2.float()
        packed = {name: v.float() for name, v in packed.items()}
    feats = feats2.reshape(n, k, feats2.shape[-1])
    wxf, wxr, cb = packed["wx_feat"], packed["wx_rel"], packed["corner_bias"]
    frac_s = rnd(frac)
    bounds = [0]
    for m in _MULTS:
        bounds.append(bounds[-1] + nf * m)

    def skip(i):                                     # [N, K, w_i]
        sl = slice(bounds[i], bounds[i + 1])
        if low:      # the skip buffer, stored in bf16 (fused_jet.py:148)
            return rnd(feats @ wxf[:, sl] + ((frac_s @ wxr[:, sl])[:, None]
                                             + cb[None, :, sl]))
        return (feats @ wxf[:, sl] + (frac @ wxr[:, sl])[:, None]
                + cb[None, :, sl])

    def inj(i):                                      # [D, w_i]
        return wxr[:, bounds[i]:bounds[i + 1]]

    pres, layers = [], []

    def branch(i, pre):
        pres.append(pre)
        pos = pre >= 0 if masks is None else masks[i].reshape(pre.shape)
        return torch.where(pos, 1.0, slope).to(pre.dtype)

    pre = skip(0)
    mask = branch(0, pre)
    h = pre * mask
    g = mask[:, :, None] * inj(0)                    # [N, K, D, w_0]
    for i in range(1, 5):
        if keep:
            layers.append((h, g, mask))
        wh = packed[f"wh{i}"]
        pre = rnd(h) @ wh + skip(i)
        mask = branch(i, pre)
        h = pre * mask
        g = mask[:, :, None] * (rnd(g) @ wh + inj(i))
    if keep:
        layers.append((h, g, mask))
    return h, g, pres, layers


def jet_fwd_plain(feats2, frac, packed, *, nf: int, slope: float = 0.01,
                  masks=None, return_pre: bool = False,
                  compute_dtype=torch.float32):
    """Plain PyTorch twin of :func:`jet_fwd`: feats2 ``[N*2^D, C]``,
    frac ``[N, D]`` -> ``[N, blocks, O]`` (value, jac_a, hess_ab for
    a <= b).

    ``masks``: the five layers' branch decisions to use in place of
    ``pre >= 0`` (``[N*2^D, w_i]`` bool, e.g. a kernel's, from
    :func:`workspace_masks`); ``return_pre``: also return the five
    primal pre-activations ``[N, 2^D, w_i]``. Both serve the card
    checks, which tell a LeakyReLU branch flip at a pre-activation
    within rounding of 0 from an arithmetic fault.

    ``compute_dtype=torch.bfloat16``: feats2 and the packed weights of
    ``_ROUNDED`` bf16, rounding at ``_forward_chains``' points: frac for
    the skip term (the blend weights take the f32 frac), the skip term
    ``feats @ wx_feat + (frac @ wx_rel + corner_bias)`` as a whole, h and
    g before each ``Wh_i`` product, the blocks before the head; the masks
    from the f32 pre-activation, the blend in f32."""
    h, g, pres, _ = _chains(feats2, frac, packed, nf=nf, slope=slope,
                            masks=masks, compute_dtype=compute_dtype,
                            keep=False)
    out = _head(_stacked(h, g, frac), packed, _rounder(compute_dtype))
    return (out, pres) if return_pre else out


def _stacked(h, g, frac):
    """The jet blocks of layer 4's chains before the head, h ``[N, K,
    nf]`` (primal) and g ``[N, K, D, nf]`` (tangents): the multilinear
    blends of the value, Jacobian and Hessian -> ``[N, blocks, nf]``."""
    dim = frac.shape[1]
    w, dw, d2w = (t.to(h.dtype) for t in multilinear_weight_jet(frac))

    def blend(coef, x):                              # [N, K], [N, K, nf]
        return torch.einsum("nk,nkj->nj", coef, x)

    blocks = [blend(w, h)]
    for a in range(dim):
        blocks.append(blend(dw[..., a], h) + blend(w, g[:, :, a]))
    for a, b in tri_pairs(dim):
        acc = blend(dw[..., a], g[:, :, b]) + blend(dw[..., b], g[:, :, a])
        if a != b:
            acc = acc + blend(d2w[..., a, b], h)
        blocks.append(acc)
    return torch.stack(blocks, dim=1)


def _head(stacked, packed, rnd):
    """The linear head on the jet blocks, ``b5`` on the value block only
    -> ``[N, blocks, O]``."""
    out = rnd(stacked) @ packed["w5"].to(stacked.dtype)
    value = out[:, :1] + packed["b5"]
    return torch.cat([value, out[:, 1:]], dim=1)


def jet_bwd_plain(feats2, frac, packed, ybar, *, nf: int,
                  slope: float = 0.01, masks=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain twin of :func:`jet_bwd` at f32: autograd through
    :func:`jet_fwd_plain` (with its ``masks``) for the cotangent
    ``ybar [N, blocks, O]``."""
    with torch.enable_grad():
        f = feats2.detach().requires_grad_(True)
        ps = {name: packed[name].detach().requires_grad_(True)
              for name in _WEIGHTS}
        out = jet_fwd_plain(f, frac.detach(), ps, nf=nf, slope=slope,
                            masks=masks)
        grads = torch.autograd.grad(out, [f, *ps.values()], ybar)
    return grads[0], dict(zip(_WEIGHTS, grads[1:]))


def jet_bwd_bf16_plain(feats2, frac, packed, ybar, *, nf: int,
                       slope: float = 0.01, masks=None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain twin of :func:`jet_bwd` at bf16, written out from the TPU's
    ``_jet_bwd_kernel`` (``fused_jet.py:256-353``), not autograd: the
    forward chains recomputed as :func:`jet_fwd_plain` at bf16 (with its
    ``masks``); ybar, the blocks, the back-propagated chains P (pv, pt),
    the chains X, xsbar and its per-point sum rounded to bf16 at every
    product; db5, corner_bias's sums, the spread and P in f32. Returns d
    feats2 and every gradient in f32 (their sums), as the kernel does."""
    rnd = _rounder(BF16)
    n, dim = frac.shape
    c = feats2.shape[-1]
    h4, g4, _, layers = _chains(feats2, frac, packed, nf=nf, slope=slope,
                                masks=masks, compute_dtype=BF16, keep=True)
    p = {name: v.float() for name, v in packed.items()}
    w, dw, d2w = multilinear_weight_jet(frac)
    yb = rnd(ybar.float())
    grads = {"w5": torch.einsum("nbj,nbo->jo", rnd(_stacked(h4, g4, frac)),
                                yb),
             "b5": ybar[:, :1].float().sum(0)}
    bars = yb @ p["w5"].t()                          # [N, blocks, nf]
    # The blends' transpose (spread), f32.
    bj = [bars[:, 1 + a, None] for a in range(dim)]
    hbar = w[..., None] * bars[:, :1]
    for a in range(dim):
        hbar = hbar + dw[..., a, None] * bj[a]
    gbar = [w[..., None] * bj[a] for a in range(dim)]
    for i, (a, b) in enumerate(tri_pairs(dim)):
        bh = bars[:, 1 + dim + i, None]
        if a != b:
            hbar = hbar + d2w[..., a, b, None] * bh
        gbar[b] = gbar[b] + dw[..., a, None] * bh
        gbar[a] = gbar[a] + dw[..., b, None] * bh
    hcur, gcur = hbar, torch.stack(gbar, dim=2)      # [N, K(, D), nf]
    xsbar, segs = [None] * 5, [None] * 5
    for i in range(4, 0, -1):
        h_prev, g_prev, _ = layers[i - 1]
        m = layers[i][2]
        pv, pt = hcur * m, gcur * m[:, :, None]
        xsbar[i] = pv
        grads[f"wh{i}"] = (
            torch.einsum("nkp,nkq->pq", rnd(h_prev), rnd(pv))
            + torch.einsum("nkdp,nkdq->pq", rnd(g_prev), rnd(pt)))
        segs[i] = rnd(pt).sum((0, 1))                # [D, w_i]
        wht = p[f"wh{i}"].t()
        hcur, gcur = rnd(pv) @ wht, rnd(pt) @ wht
    m0 = layers[0][2]
    xsbar[0] = hcur * m0
    segs[0] = rnd(gcur * m0[:, :, None]).sum((0, 1))
    xsb = torch.cat(xsbar, dim=-1)                   # [N, K, S] f32
    feats = rnd(feats2.float()).reshape(n, 2 ** dim, c)
    dfeats = rnd(xsb) @ p["wx_feat"].t()             # [N, K, C]
    grads["wx_feat"] = torch.einsum("nkc,nks->cs", feats, rnd(xsb))
    grads["wx_rel"] = (rnd(frac).t() @ rnd(xsb.sum(1))
                       + torch.cat(segs, dim=-1))
    grads["corner_bias"] = xsb.sum(0)
    return dfeats.reshape(-1, c), {name: grads[name] for name in _WEIGHTS}


def workspace_masks(workspace, n: int, dim: int, nf: int,
                    compute_dtype=torch.float32):
    """The five layers' branch decisions that :func:`jet_fwd` stored in
    its workspace -> ``[R, w_i]`` bool tensors (R = N 2^D). The workspace
    holds every layer's chain planes ``[D+1, R, w_i]`` (f32 in
    ``csrc/fused_jet.cu``; bf16 for layers 0-3 and f32 for layer 4 in
    ``csrc/fused_jet_bf16.cu``), then every layer's masks, bytes
    ``[R, w_i]``."""
    rows = n * 2 ** dim
    widths = [nf * m for m in _MULTS]
    chains = rows * (dim + 1)
    if compute_dtype == torch.float32:
        start = 4 * chains * sum(widths)
    else:
        start = 2 * chains * sum(widths[:-1]) + 4 * chains * widths[-1]
    out = []
    for w in widths:
        out.append(workspace[start:start + rows * w].view(rows, w).bool())
        start += rows * w
    return out


# The bf16 kernels' product schedule (csrc/fused_jet_bf16.cu), mirrored
# here so that the CPU tests can follow it: 64 x 64 bf16 tiles, 128 columns
# an item (two consumer warpgroups of 64), a ring of (MT + 2)-tile stages.
BF16_TILE = 64
BF16_TILE_COLS = 128
_TARGET_BLOCKS = 4 * 132            # jet_common.cuh::kTargetBlocks
_MAX_SMEM, _ALIGN, _BAR_BYTES, _STAGING = 232448, 1024, 1024, 32768


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bf16_tn_plan(m: int, ka: int, nb: int):
    """The bf16 backward's split-K plan of ``A^T B`` over ``m`` rows into
    ``[ka, nb]`` (``tn_plan`` and ``jet_common.cuh::chunk_rows``): (A tiles
    an item (1, 2 or 4 by ka), output tiles along ka, along nb, chunk rows
    (a multiple of a stage), chunks). Each chunk's partial is written once
    and the partials are summed in a fixed order."""
    mt = 1 if ka <= BF16_TILE else (2 if ka <= 2 * BF16_TILE else 4)
    mtiles = _cdiv(ka, mt * BF16_TILE)
    ntiles = _cdiv(nb, BF16_TILE_COLS)
    want = max(1, min(_TARGET_BLOCKS // (mtiles * ntiles),
                      _cdiv(m, BF16_TILE)))
    chunk = max(_cdiv(_cdiv(m, want), BF16_TILE) * BF16_TILE, BF16_TILE)
    chunks = _cdiv(m, chunk) if m > 0 else 1
    return mt, mtiles, ntiles, chunk, chunks


def bf16_ring(mt: int, staging: bool):
    """The bf16 product kernel's ring with ``mt`` A tiles a stage
    (``gemm_ring``): (stage bytes, ring stages (0 if fewer than 3 fit in
    227 KB), dynamic shared-memory bytes); ``staging``: the epilogue's 32 KB
    of staging rows (the forward layers and the backward's chain
    product)."""
    stage = (mt + 2) * BF16_TILE * BF16_TILE * 2
    out = _STAGING if staging else 0
    n = min((_MAX_SMEM - _ALIGN - _BAR_BYTES - out) // stage, 6)
    return stage, (n if n >= 3 else 0), _ALIGN + n * stage + _BAR_BYTES + out


# The f32 kernels' product schedule (csrc/fused_jet.cu), mirrored here so
# that the CPU tests can follow it: A tiles of 64 rows x 32 f32 (one stage
# deep), two consumer warpgroups of ``kn`` columns each, a ring of MT A
# tiles and both consumers' B blocks (hi and lo) a stage.
F32_TILE_ROWS, F32_DEPTH = 64, 32
F32_FEAT_COLS, F32_TN_COLS = 32, 64   # d feats' and the weight gradients' kn
_F32_TILE_BYTES = F32_TILE_ROWS * F32_DEPTH * 4
# The K columns of a stage in the order of its 4 k8 steps x 8 positions: a
# thread's k = t and t + 4 of step s are columns 8t + 2s and 8t + 2s + 1
# (csrc/fused_jet.cu::load_rows); the weight image stores B's rows so.
F32_STEP_COLS = [8 * p + 2 * s if p < 4 else 8 * (p - 4) + 2 * s + 1
                 for s in range(4) for p in range(8)]


def f32_chain_cols(dim: int) -> int:
    """Columns a consumer warpgroup owns in the f32 forward layers and the
    backward's chain product: 64 at D = 3, 32 at D = 4 (five chains of
    accumulators)."""
    return 64 if dim == 3 else 32


def f32_ring(mt: int, kn: int, staging: bool):
    """The f32 product kernel's ring with ``mt`` A tiles and ``kn`` columns
    a consumer a stage (``f32_ring`` in csrc/fused_jet.cu): (stage bytes,
    ring stages (0 if fewer than 2 fit in 227 KB), dynamic shared-memory
    bytes); ``staging``: the epilogue's staging rows (8 warps x 16 rows x
    4 kn bytes; the forward layers and the chain product)."""
    stage = mt * _F32_TILE_BYTES + 2 * kn * F32_DEPTH * 8
    out = 8 * 16 * 4 * kn if staging else 0
    n = min((_MAX_SMEM - _ALIGN - _BAR_BYTES - out) // stage, 6)
    return stage, (n if n >= 2 else 0), _ALIGN + n * stage + _BAR_BYTES + out


def f32_tn_plan(m: int, ka: int, nb: int):
    """The f32 backward's split-K plan of ``A^T B`` over ``m`` rows into
    ``[ka, nb]`` (``tn_plan``, ``jet_common.cuh::chunk_rows`` at a stage's
    depth): (A tiles an item (1, 2 or 4 by ka), output tiles along ka,
    along nb, chunk rows (a multiple of a stage), chunks)."""
    mt = 1 if ka <= F32_TILE_ROWS else (2 if ka <= 2 * F32_TILE_ROWS else 4)
    mtiles = _cdiv(ka, mt * F32_TILE_ROWS)
    ntiles = _cdiv(nb, 2 * F32_TN_COLS)
    want = max(1, min(_TARGET_BLOCKS // (mtiles * ntiles),
                      _cdiv(m, F32_DEPTH)))
    chunk = max(_cdiv(_cdiv(m, want), F32_DEPTH) * F32_DEPTH, F32_DEPTH)
    chunks = _cdiv(m, chunk) if m > 0 else 1
    return mt, mtiles, ntiles, chunk, chunks


def _f32_segments(c: int, dim: int, nf: int):
    """The weight image's segments in order, (layer, kind, n, k, kn): per
    layer the forward's skip (``Wx_feat[:, sl_i]^T``) and hidden
    (``Wh_i^T``) B, the backward's chain-product (``Wh_i``) and d feats
    (``Wx_feat[:, sl_i]``) B, each ``[n, k]``."""
    kc = f32_chain_cols(dim)
    widths = [nf * m for m in _MULTS]
    out = []
    for i, w in enumerate(widths):
        out.append((i, "fwd_skip", w, c, kc))
        if i:
            out.append((i, "fwd_hidden", w, widths[i - 1], kc))
            out.append((i, "bwd_hidden", widths[i - 1], w, kc))
        out.append((i, "bwd_feats", c, w, F32_FEAT_COLS))
    return out


def _f32_segment_floats(n: int, k: int, kn: int) -> int:
    return 2 * _cdiv(n, 2 * kn) * _cdiv(k, F32_DEPTH) * 64 * kn


def f32_image_layout(n: int, c: int, dim: int, nf: int):
    """(byte offset, f32 values) of the weight image in :func:`jet_fwd`'s
    f32 workspace: it follows the chains and the masks, 128-byte
    aligned."""
    rows, s = n * 2 ** dim, 31 * nf
    end = 4 * rows * (dim + 1) * s + rows * s
    floats = sum(_f32_segment_floats(nn, k, kn)
                 for *_, nn, k, kn in _f32_segments(c, dim, nf))
    return _cdiv(end, 128) * 128, floats


def _tf32(t):
    """f32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as the kernels round (``(bits + 0x1000) & 0xffffe000``)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _f32_segment_image(b, kn: int):
    """One segment of the image from its B ``[n, k]``: per item column
    block (2 kn columns) and stage (32 K), both consumers' blocks, each 4
    k8 steps of [hi, lo] x [8-column group][2 k halves][8 columns][4 k],
    step s's position p at K column ``F32_STEP_COLS[8 s + p]``."""
    n, k = b.shape
    ncb, nkt = _cdiv(n, 2 * kn), _cdiv(k, F32_DEPTH)
    full = b.new_zeros(ncb * 2 * kn, nkt * F32_DEPTH)
    full[:n, :k] = b
    full = full.view(-1, nkt, F32_DEPTH)[:, :, F32_STEP_COLS]
    # n = (block, consumer, group, row), k = (stage, step, half, k)
    x = full.reshape(ncb, 2, kn // 8, 8, nkt, 4, 2, 4)
    x = x.permute(0, 4, 1, 5, 2, 6, 3, 7).contiguous()
    hi = _tf32(x)
    return torch.stack([hi, _tf32(x - hi)], dim=4).reshape(-1)


def f32_weight_image(packed, *, nf: int, dim: int):
    """The f32 kernels' weight image (``weight_image_kernel`` in
    csrc/fused_jet.cu), built on the host: every segment of
    :func:`_f32_segments` split into TF32 hi and lo planes, in the
    kernel's shared-memory order -> a 1-D f32 tensor of
    ``f32_image_layout(...)[1]`` values."""
    wxf = packed["wx_feat"].float()
    c = wxf.shape[0]
    bounds = [0]
    for m in _MULTS:
        bounds.append(bounds[-1] + nf * m)
    parts = []
    for i, kind, _, _, kn in _f32_segments(c, dim, nf):
        xf = wxf[:, bounds[i]:bounds[i + 1]]
        wh = packed[f"wh{i}"].float() if i else None
        b = {"fwd_skip": lambda: xf.t(), "fwd_hidden": lambda: wh.t(),
             "bwd_hidden": lambda: wh, "bwd_feats": lambda: xf}[kind]()
        parts.append(_f32_segment_image(b, kn))
    return torch.cat(parts)


def workspace_image(workspace, n: int, c: int, dim: int, nf: int):
    """The weight image that the f32 :func:`jet_fwd` wrote into its
    workspace (1-D f32 view)."""
    off, floats = f32_image_layout(n, c, dim, nf)
    return workspace[off:off + 4 * floats].view(torch.float32)


def _kernel_args(feats2, frac, packed, *, nf: int, compute_dtype):
    """Shared checks of both wrappers -> (device, n, c, dim, out_dim,
    the library's entry-point suffix)."""
    if compute_dtype not in (torch.float32, BF16):
        raise NotImplementedError(f"compute_dtype {compute_dtype}: the jet "
                                  "kernels have f32 and bf16 "
                                  "instantiations")
    n, dim = frac.shape
    k = 2 ** dim
    if feats2.ndim != 2 or feats2.shape[0] != n * k:
        raise ValueError(f"feats2 must be [{n}*{k}, C], got "
                         f"{tuple(feats2.shape)}")
    c = feats2.shape[-1]
    device = _check({"feats2": feats2, "frac": frac}, packed, n=n, c=c,
                    dim=dim, nf=nf, compute_dtype=compute_dtype,
                    packed_dtype=compute_dtype)
    if device.type == "cuda" and dim not in KERNEL_DIMS:
        raise NotImplementedError(
            f"the jet kernels take D in {KERNEL_DIMS}, got D = {dim}")
    suffix = "_bf16" if compute_dtype == BF16 else ""
    return device, n, c, dim, packed["w5"].shape[-1], suffix


def jet_fwd(feats2, frac, packed, *, nf: int, slope: float = 0.01,
            compute_dtype=torch.float32):
    """Jet of the decode: feats2 ``[N*2^D, C]`` and the packed weights in
    ``compute_dtype`` (f32; or bf16, ``corner_bias`` and ``b5`` f32),
    frac ``[N, D]`` f32 -> (jet ``[N, blocks, O]`` f32, the kernel's
    workspace: every layer's chains and masks, which :func:`jet_bwd`
    reads; None on the CPU)."""
    device, n, c, dim, out_dim, sfx = _kernel_args(
        feats2, frac, packed, nf=nf, compute_dtype=compute_dtype)
    if device.type == "cpu":
        return jet_fwd_plain(feats2, frac, packed, nf=nf, slope=slope,
                             compute_dtype=compute_dtype), None
    lib = _build.load("fused_jet" + sfx)
    nbytes = getattr(lib, f"stpde_jet_fwd{sfx}_workspace")(
        n, c, dim, nf, out_dim)
    if nbytes < 0:
        raise ValueError(f"jet kernel rejects n={n} c={c} dim={dim} "
                         f"nf={nf} out={out_dim}")
    ws = torch.empty(nbytes, dtype=torch.uint8, device=device)
    out = torch.empty((n, _n_blocks(dim), out_dim), dtype=torch.float32,
                      device=device)
    code = getattr(lib, f"stpde_jet_fwd{sfx}")(
        feats2.data_ptr(), frac.data_ptr(),
        *[packed[name].data_ptr() for name in _WEIGHTS], out.data_ptr(),
        ws.data_ptr(), n, c, dim, nf, out_dim, slope,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(code, "jet_fwd" + sfx)
    _count(LAUNCHES, CAPTURED, "jet_fwd" + sfx)
    return out, ws


def jet_bwd(feats2, frac, packed, workspace, ybar, *, nf: int,
            slope: float = 0.01, compute_dtype=torch.float32
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Backward of :func:`jet_fwd` for the cotangent ``ybar`` (its
    output's layout), reading the forward's ``workspace``: (d feats2,
    {name: d packed[name]}), every one f32 (their sums; at bf16 the
    autograd Function rounds them to the tensors' types)."""
    device, n, c, dim, out_dim, sfx = _kernel_args(
        feats2, frac, packed, nf=nf, compute_dtype=compute_dtype)
    want = (n, _n_blocks(dim), out_dim)
    if tuple(ybar.shape) != want:
        raise ValueError(f"ybar must be {want}, got {tuple(ybar.shape)}")
    if device.type == "cpu":
        plain = jet_bwd_bf16_plain if sfx else jet_bwd_plain
        return plain(feats2, frac, packed, ybar, nf=nf, slope=slope)
    ybar = ybar.to(torch.float32).contiguous()
    if ybar.device != device:
        raise ValueError(f"ybar is on {ybar.device}, frac on {device}")
    lib = _build.load("fused_jet" + sfx)
    if workspace is None or workspace.numel() != getattr(
            lib, f"stpde_jet_fwd{sfx}_workspace")(n, c, dim, nf, out_dim):
        raise ValueError("jet_bwd needs the workspace jet_fwd returned "
                         "for the same shapes")
    scratch = torch.empty(
        getattr(lib, f"stpde_jet_bwd{sfx}_workspace")(n, c, dim, nf,
                                                      out_dim),
        dtype=torch.uint8, device=device)
    dfeats = torch.empty(feats2.shape, dtype=torch.float32, device=device)
    grads = {name: torch.empty(packed[name].shape, dtype=torch.float32,
                               device=device) for name in _WEIGHTS}
    code = getattr(lib, f"stpde_jet_bwd{sfx}")(
        feats2.data_ptr(), frac.data_ptr(),
        *[packed[name].data_ptr() for name in _WEIGHTS],
        workspace.data_ptr(), ybar.data_ptr(), dfeats.data_ptr(),
        *[grads[name].data_ptr() for name in _WEIGHTS], scratch.data_ptr(),
        n, c, dim, nf, out_dim, slope,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(code, "jet_bwd" + sfx)
    _count(LAUNCHES, CAPTURED, "jet_bwd" + sfx)
    return dfeats, grads


class _Jet(torch.autograd.Function):
    """feats2, frac, 9 packed tensors -> jet ``[N, blocks, O]``; the
    backward is :func:`jet_bwd` (``frac`` gets None), its gradients
    rounded to the types of the tensors they belong to (at bf16, as the
    TPU's ``jet_bwd`` casts them; at f32 nothing changes)."""

    @staticmethod
    def forward(ctx, nf, slope, compute_dtype, feats2, frac, *params):
        packed = dict(zip(_WEIGHTS, params))
        out, ws = jet_fwd(feats2, frac, packed, nf=nf, slope=slope,
                          compute_dtype=compute_dtype)
        ctx.nf, ctx.slope, ctx.dtype, ctx.ws = nf, slope, compute_dtype, ws
        ctx.save_for_backward(feats2, frac, *params)
        return out

    @staticmethod
    def backward(ctx, ybar):
        feats2, frac, *params = ctx.saved_tensors
        packed = dict(zip(_WEIGHTS, params))
        dfeats, grads = jet_bwd(feats2, frac, packed, ctx.ws, ybar,
                                nf=ctx.nf, slope=ctx.slope,
                                compute_dtype=ctx.dtype)
        ctx.ws = None
        return (None, None, None, dfeats.to(feats2.dtype), None,
                *[grads[name].to(packed[name].dtype) for name in _WEIGHTS])


class _Bf16Rows(torch.autograd.Function):
    """grid ``[*spatial, C]`` f32, cell_flat ``[N]`` -> the cells' corner
    rows ``[N, 2^D C]`` from the bf16 cell table (the TPU path's
    ``cell_major_features(grid.astype(bf16))`` and ``take``). The
    backward sums the rows' cotangent into the grid in f32 (an
    accumulating ``index_put_``, deterministic on either device, then the
    2^D corner slices in order) and rounds the sum to bf16 once; JAX's
    transposes sum it in bf16."""

    @staticmethod
    def forward(ctx, grid, cell_flat):
        ctx.save_for_backward(cell_flat)
        ctx.spatial = tuple(grid.shape[:-1])
        return cell_major_features(grid.to(BF16))[cell_flat.long()]

    @staticmethod
    def backward(ctx, g):
        (cell_flat,) = ctx.saved_tensors
        spatial, dim = ctx.spatial, len(ctx.spatial)
        cells = [s - 1 for s in spatial]
        c = g.shape[-1] >> dim
        table = torch.zeros((math.prod(cells), g.shape[-1]),
                            dtype=torch.float32, device=g.device)
        table.index_put_((cell_flat.long(),), g.float(), accumulate=True)
        table = table.reshape(*cells, 2 ** dim, c)
        grid = torch.zeros((*spatial, c), dtype=torch.float32,
                           device=g.device)
        for k, off in enumerate(corner_offsets(dim)):
            grid[tuple(slice(int(off[d]), cells[d] + int(off[d]))
                       for d in range(dim))] += table[..., k, :]
        return grid.to(BF16).float(), None


def fused_query_jet(imnet, latent_grid, pts, xmin=0.0, xmax=1.0,
                    compute_dtype=torch.float32):
    """Drop-in for ``ops.jet.query_local_implicit_grid_jet``: latent_grid
    ``[B, *spatial, C]``, pts ``[B, N, D]`` -> (value ``[B, N, O]``, jac
    ``[B, N, O, D]``, hess ``[B, N, O, D, D]``) in ``pts`` units,
    differentiable w.r.t. ``imnet``'s parameters and ``latent_grid``.

    The corner rows are gathered here (torch indexing; its backward is
    an index add; at bf16 :class:`_Bf16Rows`), all B * N points go
    through one kernel launch, and the frac-unit jet is rescaled by
    d frac / d p afterwards. ``compute_dtype``: f32, or bf16 (the TPU
    trainer's jet under ``--use_bf16 --pde_bf16``: bf16 rows and packed
    weights, the bf16 kernels)."""
    if compute_dtype not in (torch.float32, BF16):
        raise NotImplementedError(f"compute_dtype {compute_dtype}: the jet "
                                  "kernels have f32 and bf16 "
                                  "instantiations")
    slope = jet_slope(imnet.activation, imnet.negative_slope)
    dim = pts.shape[-1]
    if latent_grid.ndim != dim + 2:
        raise ValueError(
            f"latent_grid rank {latent_grid.ndim} incompatible with "
            f"pts dim {dim}; expected [B, *spatial({dim}), C]")
    b, n = pts.shape[0], pts.shape[1]
    c = latent_grid.shape[-1]
    packed = pack_imnet_params(imnet, dtype=compute_dtype)
    rows, fracs, dfracs = [], [], []
    for grid, p in zip(latent_grid, pts):
        spatial = tuple(grid.shape[:-1])
        cell, frac = _locate(p, spatial, xmin, xmax)
        dfracs.append(locate_dfrac(p, spatial, xmin, xmax))
        cell_flat = _flat_cells(cell, spatial)
        if compute_dtype == BF16:
            rows.append(_Bf16Rows.apply(grid, cell_flat))
        else:
            rows.append(cell_major_features(grid)[cell_flat.long()])
        fracs.append(frac)
    feats2 = torch.cat(rows).reshape(-1, c).to(compute_dtype).contiguous()
    frac = torch.cat(fracs).float().contiguous()
    out = _Jet.apply(imnet.nf, slope, compute_dtype, feats2, frac,
                     *[packed[name] for name in _WEIGHTS])
    value = out[:, 0]
    jac_f = out[:, 1:1 + dim].transpose(1, 2)                 # [BN, O, D]
    pair_block = {p: 1 + dim + i for i, p in enumerate(tri_pairs(dim))}
    # The index as a device constant: a Python list would be copied to
    # the card on every call.
    idx = device_constant([pair_block[(min(a, b_), max(a, b_))]
                           for a in range(dim) for b_ in range(dim)],
                          torch.int64, out.device)
    hess_f = out[:, idx].reshape(-1, dim, dim, out.shape[-1]) \
        .permute(0, 3, 1, 2)                                  # [BN, O, D, D]
    dfrac = torch.cat(dfracs).to(value.dtype)
    jac = jac_f * dfrac[:, None, :]
    hess = hess_f * dfrac[:, None, :, None] * dfrac[:, None, None, :]
    o = value.shape[-1]
    return (value.reshape(b, n, o), jac.reshape(b, n, o, dim),
            hess.reshape(b, n, o, dim, dim))
