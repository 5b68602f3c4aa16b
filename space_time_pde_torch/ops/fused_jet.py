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
``LAUNCHES`` (only the CUDA branch adds to it):

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
autograd through it, a derivation independent of the backward kernel.

The kernels are f32 and take D = 3 (8 corners, the rb2d family) and
D = 4 (16 corners, the turb3d family); a bf16 ``compute_dtype`` raises
``NotImplementedError``, and so does another D on the card. A
non-piecewise-linear activation raises ``ValueError``; ``relu`` is
LeakyReLU with slope 0.

Dropped from the TPU module, each a TPU workaround: ``_axis_onehot``
(tangent injections are indexed rows), the ``_rep`` mask tiling,
``pad_to`` 128-lane padding, the block-major per-grid-block output
layout and ``block_pts`` padding (the output is ``[N, blocks, O]``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from space_time_pde_torch.models.nonlinearities import PIECEWISE_LINEAR
from space_time_pde_torch.ops import _build
from space_time_pde_torch.ops.fused_query import (
    _MULTS, _WEIGHTS, _check, _flat_cells, cell_major_features,
    pack_imnet_params)
from space_time_pde_torch.ops.grid_interp import _locate, locate_dfrac
from space_time_pde_torch.ops.jet import multilinear_weight_jet

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "tri_pairs",
    "jet_slope",
    "jet_fwd",
    "jet_bwd",
    "jet_fwd_plain",
    "jet_bwd_plain",
    "workspace_masks",
    "fused_query_jet",
]

KERNEL_DIMS = (3, 4)

LAUNCHES = {"jet_fwd": 0, "jet_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def jet_fwd_plain(feats2, frac, packed, *, nf: int, slope: float = 0.01,
                  masks=None, return_pre: bool = False):
    """Plain PyTorch twin of :func:`jet_fwd`: feats2 ``[N*2^D, C]``,
    frac ``[N, D]`` -> ``[N, blocks, O]`` (value, jac_a, hess_ab for
    a <= b).

    ``masks``: the five layers' branch decisions to use in place of
    ``pre >= 0`` (``[N*2^D, w_i]`` bool, e.g. a kernel's, from
    :func:`workspace_masks`); ``return_pre``: also return the five
    primal pre-activations ``[N, 2^D, w_i]``. Both serve the card
    checks, which tell a LeakyReLU branch flip at a pre-activation
    within rounding of 0 from an arithmetic fault."""
    n, dim = frac.shape
    k = 2 ** dim
    feats = feats2.reshape(n, k, feats2.shape[-1])
    wxf, wxr, cb = packed["wx_feat"], packed["wx_rel"], packed["corner_bias"]
    bounds = [0]
    for m in _MULTS:
        bounds.append(bounds[-1] + nf * m)

    def skip(i):                                     # [N, K, w_i]
        sl = slice(bounds[i], bounds[i + 1])
        return (feats @ wxf[:, sl] + (frac @ wxr[:, sl])[:, None]
                + cb[None, :, sl])

    def inj(i):                                      # [D, w_i]
        return wxr[:, bounds[i]:bounds[i + 1]]

    pres = []

    def branch(i, pre):
        pres.append(pre)
        pos = pre >= 0 if masks is None else masks[i].reshape(pre.shape)
        return torch.where(pos, 1.0, slope).to(pre.dtype)

    pre = skip(0)
    mask = branch(0, pre)
    h = pre * mask
    g = mask[:, :, None] * inj(0)                    # [N, K, D, w_0]
    for i in range(1, 5):
        wh = packed[f"wh{i}"]
        pre = h @ wh + skip(i)
        mask = branch(i, pre)
        h = pre * mask
        g = mask[:, :, None] * (g @ wh + inj(i))
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
    out = torch.stack(blocks, dim=1) @ packed["w5"]  # [N, blocks, O]
    value = out[:, :1] + packed["b5"]
    out = torch.cat([value, out[:, 1:]], dim=1)
    return (out, pres) if return_pre else out


def jet_bwd_plain(feats2, frac, packed, ybar, *, nf: int,
                  slope: float = 0.01, masks=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Plain twin of :func:`jet_bwd`: autograd through
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


def workspace_masks(workspace, n: int, dim: int, nf: int):
    """The five layers' branch decisions that :func:`jet_fwd` stored in
    its workspace (``csrc/fused_jet.cu``: every layer's chains, f32
    ``[R, D+1, w_i]``, then every layer's masks, bytes ``[R, w_i]``,
    R = N 2^D) -> ``[R, w_i]`` bool tensors."""
    rows = n * 2 ** dim
    widths = [nf * m for m in _MULTS]
    start = 4 * rows * (dim + 1) * sum(widths)
    out = []
    for w in widths:
        out.append(workspace[start:start + rows * w].view(rows, w).bool())
        start += rows * w
    return out


def _kernel_args(feats2, frac, packed, *, nf: int):
    """Shared checks of both wrappers -> (device, n, c, dim, out_dim)."""
    n, dim = frac.shape
    k = 2 ** dim
    if feats2.ndim != 2 or feats2.shape[0] != n * k:
        raise ValueError(f"feats2 must be [{n}*{k}, C], got "
                         f"{tuple(feats2.shape)}")
    c = feats2.shape[-1]
    device = _check({"feats2": feats2, "frac": frac}, packed, n=n, c=c,
                    dim=dim, nf=nf)
    if device.type == "cuda" and dim not in KERNEL_DIMS:
        raise NotImplementedError(
            f"the jet kernels take D in {KERNEL_DIMS}, got D = {dim}")
    return device, n, c, dim, packed["w5"].shape[-1]


def jet_fwd(feats2, frac, packed, *, nf: int, slope: float = 0.01):
    """Jet of the decode: feats2 ``[N*2^D, C]``, frac ``[N, D]`` ->
    (jet ``[N, blocks, O]`` f32, the kernel's workspace: every layer's
    chains and masks, which :func:`jet_bwd` reads; None on the CPU)."""
    device, n, c, dim, out_dim = _kernel_args(feats2, frac, packed, nf=nf)
    if device.type == "cpu":
        return jet_fwd_plain(feats2, frac, packed, nf=nf, slope=slope), None
    lib = _build.load("fused_jet")
    nbytes = lib.stpde_jet_fwd_workspace(n, c, dim, nf, out_dim)
    if nbytes < 0:
        raise ValueError(f"jet kernel rejects n={n} c={c} dim={dim} "
                         f"nf={nf} out={out_dim}")
    ws = torch.empty(nbytes, dtype=torch.uint8, device=device)
    out = torch.empty((n, _n_blocks(dim), out_dim), dtype=torch.float32,
                      device=device)
    code = lib.stpde_jet_fwd(
        feats2.data_ptr(), frac.data_ptr(),
        *[packed[name].data_ptr() for name in _WEIGHTS], out.data_ptr(),
        ws.data_ptr(), n, c, dim, nf, out_dim, slope,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(code, "jet_fwd")
    LAUNCHES["jet_fwd"] += 1
    return out, ws


def jet_bwd(feats2, frac, packed, workspace, ybar, *, nf: int,
            slope: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Backward of :func:`jet_fwd` for the cotangent ``ybar`` (its
    output's layout), reading the forward's ``workspace``: (d feats2,
    {name: d packed[name]})."""
    device, n, c, dim, out_dim = _kernel_args(feats2, frac, packed, nf=nf)
    want = (n, _n_blocks(dim), out_dim)
    if tuple(ybar.shape) != want:
        raise ValueError(f"ybar must be {want}, got {tuple(ybar.shape)}")
    if device.type == "cpu":
        return jet_bwd_plain(feats2, frac, packed, ybar, nf=nf, slope=slope)
    ybar = ybar.to(torch.float32).contiguous()
    if ybar.device != device:
        raise ValueError(f"ybar is on {ybar.device}, frac on {device}")
    lib = _build.load("fused_jet")
    if workspace is None or workspace.numel() != \
            lib.stpde_jet_fwd_workspace(n, c, dim, nf, out_dim):
        raise ValueError("jet_bwd needs the workspace jet_fwd returned "
                         "for the same shapes")
    scratch = torch.empty(lib.stpde_jet_bwd_workspace(n, c, dim, nf,
                                                      out_dim),
                          dtype=torch.uint8, device=device)
    dfeats = torch.empty_like(feats2)
    grads = {name: torch.empty_like(packed[name]) for name in _WEIGHTS}
    code = lib.stpde_jet_bwd(
        feats2.data_ptr(), frac.data_ptr(),
        *[packed[name].data_ptr() for name in _WEIGHTS],
        workspace.data_ptr(), ybar.data_ptr(), dfeats.data_ptr(),
        *[grads[name].data_ptr() for name in _WEIGHTS], scratch.data_ptr(),
        n, c, dim, nf, out_dim, slope,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(code, "jet_bwd")
    LAUNCHES["jet_bwd"] += 1
    return dfeats, grads


class _Jet(torch.autograd.Function):
    """feats2, frac, 9 packed tensors -> jet ``[N, blocks, O]``; the
    backward is :func:`jet_bwd` (``frac`` gets None)."""

    @staticmethod
    def forward(ctx, nf, slope, feats2, frac, *params):
        packed = dict(zip(_WEIGHTS, params))
        out, ws = jet_fwd(feats2, frac, packed, nf=nf, slope=slope)
        ctx.nf, ctx.slope, ctx.ws = nf, slope, ws
        ctx.save_for_backward(feats2, frac, *params)
        return out

    @staticmethod
    def backward(ctx, ybar):
        feats2, frac, *params = ctx.saved_tensors
        dfeats, grads = jet_bwd(feats2, frac, dict(zip(_WEIGHTS, params)),
                                ctx.ws, ybar, nf=ctx.nf, slope=ctx.slope)
        ctx.ws = None
        return (None, None, dfeats, None,
                *[grads[name] for name in _WEIGHTS])


def fused_query_jet(imnet, latent_grid, pts, xmin=0.0, xmax=1.0,
                    compute_dtype=torch.float32):
    """Drop-in for ``ops.jet.query_local_implicit_grid_jet``: latent_grid
    ``[B, *spatial, C]``, pts ``[B, N, D]`` -> (value ``[B, N, O]``, jac
    ``[B, N, O, D]``, hess ``[B, N, O, D, D]``) in ``pts`` units,
    differentiable w.r.t. ``imnet``'s parameters and ``latent_grid``.

    The corner rows are gathered here (torch indexing; its backward is
    an index add), all B * N points go through one kernel launch, and
    the frac-unit jet is rescaled by d frac / d p afterwards."""
    if compute_dtype != torch.float32:
        raise NotImplementedError(
            f"compute_dtype {compute_dtype}: the jet kernels are f32 only "
            "(the flagship trains its jet in f32)")
    slope = jet_slope(imnet.activation, imnet.negative_slope)
    dim = pts.shape[-1]
    if latent_grid.ndim != dim + 2:
        raise ValueError(
            f"latent_grid rank {latent_grid.ndim} incompatible with "
            f"pts dim {dim}; expected [B, *spatial({dim}), C]")
    b, n = pts.shape[0], pts.shape[1]
    c = latent_grid.shape[-1]
    packed = pack_imnet_params(imnet)
    rows, fracs, dfracs = [], [], []
    for grid, p in zip(latent_grid, pts):
        spatial = tuple(grid.shape[:-1])
        cell, frac = _locate(p, spatial, xmin, xmax)
        dfracs.append(locate_dfrac(p, spatial, xmin, xmax))
        table = cell_major_features(grid)
        rows.append(table[_flat_cells(cell, spatial).long()])  # [N, K*C]
        fracs.append(frac)
    feats2 = torch.cat(rows).reshape(-1, c).float().contiguous()
    frac = torch.cat(fracs).float().contiguous()
    out = _Jet.apply(imnet.nf, slope, feats2, frac,
                     *[packed[name] for name in _WEIGHTS])
    value = out[:, 0]
    jac_f = out[:, 1:1 + dim].transpose(1, 2)                 # [BN, O, D]
    pair_block = {p: 1 + dim + i for i, p in enumerate(tri_pairs(dim))}
    idx = [pair_block[(min(a, b_), max(a, b_))]
           for a in range(dim) for b_ in range(dim)]
    hess_f = out[:, idx].reshape(-1, dim, dim, out.shape[-1]) \
        .permute(0, 3, 1, 2)                                  # [BN, O, D, D]
    dfrac = torch.cat(dfracs).to(value.dtype)
    jac = jac_f * dfrac[:, None, :]
    hess = hess_f * dfrac[:, None, :, None] * dfrac[:, None, None, :]
    o = value.shape[-1]
    return (value.reshape(b, n, o), jac.reshape(b, n, o, dim),
            hess.reshape(b, n, o, dim, dim))
