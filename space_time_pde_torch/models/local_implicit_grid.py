"""Local Implicit Grid query (PyTorch) — the port's decode oracle.

Counterpart of ``space_time_pde_tpu/models/local_implicit_grid.py``:
for each continuous point, gather the 2**D corner latents of its cell,
evaluate the decoder once per corner on ``[relative coord ⊕ latent]``
and blend the outputs with the multilinear weights. Plain tensor code
on any device; the fused path (``ops/fused_query.py``) is checked
against it.

The JAX module's dim >= 4 guard is dropped: it stopped a compiler
crash of XLA:TPU and has no counterpart here.
"""

from __future__ import annotations

from typing import Callable

import torch

from space_time_pde_torch.ops.grid_interp import grid_interp_coefficients

__all__ = ["query_local_implicit_grid"]


def query_local_implicit_grid(
    decoder_fn: Callable[[torch.Tensor], torch.Tensor],
    latent_grid: torch.Tensor,
    pts: torch.Tensor,
    xmin=0.0,
    xmax=1.0,
) -> torch.Tensor:
    """latent_grid ``[B, *spatial, C]``, pts ``[B, N, D]`` ->
    ``[B, N, out]``; ``decoder_fn`` maps ``[..., D + C] -> [..., out]``."""
    dim = pts.shape[-1]
    if latent_grid.ndim != dim + 2:
        raise ValueError(
            f"latent_grid rank {latent_grid.ndim} incompatible with "
            f"pts dim {dim}; expected [B, *spatial({dim}), C]")
    outs = []
    for grid, p in zip(latent_grid, pts):
        feats, weights, rel = grid_interp_coefficients(grid, p, xmin, xmax)
        out = decoder_fn(torch.cat([rel, feats], dim=-1))   # [N, K, out]
        outs.append(torch.einsum("nko,nk->no", out,
                                 weights.to(out.dtype)))
    return torch.stack(outs)
