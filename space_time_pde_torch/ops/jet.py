"""Analytic derivative jet of the local-implicit-grid query (PyTorch).

Counterpart of ``space_time_pde_tpu/ops/jet.py`` and the port's jet
oracle: value, coordinate Jacobian and Hessian of

    pred(p) = sum_k  w_k(f) * M(rel_k(f), feats_k),      f = frac(p)

for a decoder ``M`` that is piecewise-linear in its coordinate inputs
(ImNet with LeakyReLU / ReLU), so that its in-cell second derivative is
zero and the Hessian reduces to multilinear-weight cross terms:

    d_a  pred = sum_k [ (d_a w_k) v_k + w_k J_k[:, a] ]           * s_a
    d_ab pred = sum_k [ (d_ab w_k) v_k + (d_a w_k) J_k[:, b]
                        + (d_b w_k) J_k[:, a] ]                   * s_a s_b

with ``s_a = d frac_a / d p_a`` from :func:`grid_interp.locate_dfrac`
(half the grid scale exactly on a domain face, as JAX's clip gives).
One primal pass and D tangent passes (``torch.func.jvp`` batched over
the D unit tangents with ``torch.func.vmap``, so the primal runs once)
give the whole jet; it stays differentiable w.r.t. the decoder's
parameters and the latent grid, which the ``jet_jnp`` training mode
uses.

Dropped from the JAX module: its ``dim >= 4`` guard, which stopped an
XLA:TPU compiler crash and has no counterpart here.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import jvp, vmap

from space_time_pde_torch.ops.grid_interp import (
    _locate, corner_offsets, gather_corner_feats, locate_dfrac)
from space_time_pde_torch.utils.constants import device_constant

__all__ = [
    "multilinear_weight_jet",
    "decode_blend_jet",
    "query_local_implicit_grid_jet",
]


def multilinear_weight_jet(frac: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """frac ``[N, D]`` -> w ``[N, K]``, dw ``[N, K, D]`` (d w / d
    frac_a), d2w ``[N, K, D, D]`` (zero diagonal: w is multilinear);
    K = 2^D in :func:`corner_offsets` order."""
    dim = frac.shape[-1]
    offs = device_constant(corner_offsets(dim), device=frac.device)
    sign = (2 * offs - 1).to(frac.dtype)                    # [K, D]
    per_axis = torch.where(offs[None].bool(), frac[:, None, :],
                           1.0 - frac[:, None, :])          # [N, K, D]
    w = torch.prod(per_axis, dim=-1)

    def prod_excluding(excl):
        keep = [d for d in range(dim) if d not in excl]
        if not keep:
            return torch.ones(per_axis.shape[:-1], dtype=frac.dtype,
                              device=frac.device)
        return torch.prod(per_axis[..., keep], dim=-1)

    dw = torch.stack([prod_excluding((a,)) * sign[None, :, a]
                      for a in range(dim)], dim=-1)         # [N, K, D]
    zeros = torch.zeros_like(w)
    d2w = torch.stack([
        torch.stack([zeros if a == b else
                     prod_excluding((a, b)) * sign[None, :, a]
                     * sign[None, :, b] for b in range(dim)], dim=-1)
        for a in range(dim)], dim=-2)                       # [N, K, D, D]
    return w, dw, d2w


def decode_blend_jet(decoder_fn: Callable[[torch.Tensor], torch.Tensor],
                     feats: torch.Tensor, frac: torch.Tensor):
    """Jet of decode + blend in frac units: feats ``[N, K, C]``, frac
    ``[N, D]`` -> (value ``[N, O]``, jac ``[N, O, D]``, hess
    ``[N, O, D, D]``)."""
    dim = frac.shape[-1]
    offs = device_constant(corner_offsets(dim), frac.dtype, frac.device)
    rel = frac[:, None, :] - offs[None]                     # [N, K, D]

    def dec_rel(r):
        return decoder_fn(torch.cat([r, feats], dim=-1))

    eye = torch.eye(dim, dtype=rel.dtype, device=rel.device)
    value_c, jac_c = vmap(
        lambda t: jvp(dec_rel, (rel,), (t.expand_as(rel),)),
        out_dims=(None, -1))(eye)                   # [N,K,O], [N,K,O,D]

    w, dw, d2w = (t.to(value_c.dtype) for t in multilinear_weight_jet(frac))
    value = torch.einsum("nko,nk->no", value_c, w)
    jac = (torch.einsum("nko,nka->noa", value_c, dw)
           + torch.einsum("nkoa,nk->noa", jac_c, w))
    hess = (torch.einsum("nko,nkab->noab", value_c, d2w)
            + torch.einsum("nkob,nka->noab", jac_c, dw)
            + torch.einsum("nkoa,nkb->noab", jac_c, dw))
    return value, jac, hess


def query_local_implicit_grid_jet(
        decoder_fn: Callable[[torch.Tensor], torch.Tensor],
        latent_grid: torch.Tensor, pts: torch.Tensor, xmin=0.0, xmax=1.0):
    """latent_grid ``[B, *spatial, C]``, pts ``[B, N, D]`` -> (value
    ``[B, N, O]``, jac ``[B, N, O, D]``, hess ``[B, N, O, D, D]``) in
    ``pts`` units."""
    dim = pts.shape[-1]
    if latent_grid.ndim != dim + 2:
        raise ValueError(
            f"latent_grid rank {latent_grid.ndim} incompatible with "
            f"pts dim {dim}; expected [B, *spatial({dim}), C]")
    values, jacs, hesss = [], [], []
    for grid, p in zip(latent_grid, pts):
        spatial = tuple(grid.shape[:-1])
        cell, frac = _locate(p, spatial, xmin, xmax)
        dfrac = locate_dfrac(p, spatial, xmin, xmax)
        feats = gather_corner_feats(grid, cell)             # [N, K, C]
        value, jac_f, hess_f = decode_blend_jet(decoder_fn, feats, frac)
        dfrac = dfrac.to(value.dtype)
        values.append(value)
        jacs.append(jac_f * dfrac[:, None, :])
        hesss.append(hess_f * dfrac[:, None, :, None]
                     * dfrac[:, None, None, :])
    return torch.stack(values), torch.stack(jacs), torch.stack(hesss)
