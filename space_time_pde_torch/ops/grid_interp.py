"""Regular N-d grid multilinear interpolation (PyTorch).

Counterpart of ``space_time_pde_tpu/ops/grid_interp.py``: locate each
continuous point's enclosing cell, gather the ``2**D`` corner feature
vectors, and build the multilinear weights and signed relative
coordinates the ImNet decoder consumes. Layout is channels-last
``[*spatial, C]`` as in the JAX package.

``_locate`` keeps the JAX operation order exactly
(``(p - xmin) / (xmax - xmin) * (n - 1)``, clip, floor, clip): on a
dense lattice many points land on cell faces, and another order rounds
some of them into the neighbouring cell. Its clip is
``minimum(maximum(s, 0), n - 1)``, as ``jnp.clip`` is, and not
``torch.clamp``: both give the same values, but at a point exactly on a
clip bound the derivative of ``maximum``/``minimum`` splits the tie
(0.5) in both frameworks, where ``torch.clamp``'s is 1.
:func:`locate_dfrac` writes that derivative out for the jets.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from space_time_pde_torch.utils.constants import device_constant

__all__ = [
    "corner_offsets",
    "gather_corner_feats",
    "grid_interp_coefficients",
    "locate_dfrac",
    "multilinear_interp",
]


@functools.lru_cache(maxsize=None)
def corner_offsets(dim: int) -> np.ndarray:
    """Static ``(2**dim, dim)`` int32 array of cell-corner offsets in
    {0, 1}, lexicographic with the last axis fastest."""
    grid = np.indices((2,) * dim).reshape(dim, -1).T
    return np.ascontiguousarray(grid.astype(np.int32))


def _bounds(x, dim, dtype, device):
    """``xmin`` / ``xmax`` (a number or one per axis, or a tensor: the
    sharded query's shard bounds) as a ``[dim]`` tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device).expand(dim)
    return device_constant(np.broadcast_to(np.asarray(x), (dim,)), dtype,
                           device)


def _locate(pts, spatial, xmin, xmax):
    """Map points in ``[xmin, xmax]`` to (cell [..., D] int32, frac
    [..., D]) with cell in [0, n-2] and frac in [0, 1]; out-of-domain
    points clamp to the boundary cell."""
    dim = len(spatial)
    sizes = device_constant(spatial, pts.dtype, pts.device)
    xmin = _bounds(xmin, dim, pts.dtype, pts.device)
    xmax = _bounds(xmax, dim, pts.dtype, pts.device)
    s = (pts - xmin) / (xmax - xmin) * (sizes - 1.0)
    s = torch.minimum(torch.maximum(s, torch.zeros_like(s)), sizes - 1.0)
    hi = device_constant([n - 2 for n in spatial], torch.int32, pts.device)
    cell = torch.clamp(torch.floor(s).to(torch.int32),
                       torch.zeros_like(hi), hi)
    frac = s - cell.to(pts.dtype)
    return cell, frac


def locate_dfrac(pts, spatial, xmin, xmax):
    """``d frac_a / d p_a`` of :func:`_locate`, ``[..., D]``: the grid
    scale ``(n - 1) / (xmax - xmin)`` strictly inside the clip, half of
    it exactly on a clip bound, 0 outside -- what ``jax.jvp`` gives
    through the JAX ``_locate`` (``jnp.clip`` splits a tie 0.5/0.5), so
    that both packages' jets agree on the domain faces."""
    dim = len(spatial)
    sizes = device_constant(spatial, pts.dtype, pts.device)
    xmin = _bounds(xmin, dim, pts.dtype, pts.device)
    xmax = _bounds(xmax, dim, pts.dtype, pts.device)
    s = (pts - xmin) / (xmax - xmin) * (sizes - 1.0)
    top = sizes - 1.0
    side = torch.where((s > 0) & (s < top), 1.0,
                       torch.where((s == 0) | (s == top), 0.5, 0.0))
    # The jvp's order: (1 / (xmax - xmin)) * (n - 1), then the clip.
    scale = 1.0 / (xmax - xmin) * (sizes - 1.0)
    return (scale * side).to(pts.dtype)


def _strides(shape) -> np.ndarray:
    """Row-major element strides of ``shape`` (int64)."""
    strides = np.ones(len(shape), dtype=np.int64)
    for a in range(len(shape) - 2, -1, -1):
        strides[a] = strides[a + 1] * shape[a + 1]
    return strides


def gather_corner_feats(grid, cell):
    """grid ``[*spatial, C]``, cell ``[N, D]`` -> ``[N, 2**D, C]``
    (corner order of :func:`corner_offsets`)."""
    spatial = grid.shape[:-1]
    dim = len(spatial)
    offs = device_constant(corner_offsets(dim), torch.int64,
                           grid.device)                     # [K, D]
    corner_idx = cell.to(torch.int64)[:, None, :] + offs[None]  # [N, K, D]
    strides = device_constant(_strides(spatial), device=grid.device)
    flat_idx = (corner_idx * strides).sum(-1)               # [N, K]
    return grid.reshape(-1, grid.shape[-1])[flat_idx]       # [N, K, C]


def grid_interp_coefficients(grid, pts, xmin=0.0, xmax=1.0):
    """Corner latents ``[N, 2**D, C]``, multilinear weights
    ``[N, 2**D]`` and relative coordinates ``[N, 2**D, D]`` for
    ``pts [N, D]`` in a ``[*spatial, C]`` grid."""
    spatial = tuple(grid.shape[:-1])
    dim = len(spatial)
    if pts.shape[-1] != dim:
        raise ValueError(
            f"pts last dim {pts.shape[-1]} != grid spatial rank {dim}")
    cell, frac = _locate(pts, spatial, xmin, xmax)
    corner_feats = gather_corner_feats(grid, cell)
    offs = device_constant(corner_offsets(dim), device=pts.device)
    offs_f = offs.to(frac.dtype)
    per_axis = torch.where(offs[None].bool(), frac[:, None, :],
                           1.0 - frac[:, None, :])
    weights = torch.prod(per_axis, dim=-1)                  # [N, K]
    rel_coords = frac[:, None, :] - offs_f[None]            # [N, K, D]
    return corner_feats, weights, rel_coords


def multilinear_interp(grid, pts, xmin=0.0, xmax=1.0):
    """Plain multilinear interpolation: ``[*spatial, C]`` at
    ``[N, D]`` -> ``[N, C]``."""
    corner_feats, weights, _ = grid_interp_coefficients(grid, pts,
                                                        xmin, xmax)
    return torch.einsum("nkc,nk->nc", corner_feats, weights)
