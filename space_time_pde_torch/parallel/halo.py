"""The x-sharded latent grid: one-node halo exchange and sharded queries.

Counterpart of ``space_time_pde_tpu/parallel/halo.py``. The latent grid
is split along one spatial axis over the ranks of a space group; rank
``s`` receives rank ``s + 1``'s first node plane (the last rank takes
its own last plane, a degenerate phantom cell that resolves the global
upper bound exactly) and queries only the points that lie in its own
coordinate range, with the ordinary local-implicit-grid machinery and
per-rank bounds. The units stay global: the local grid has
``n_loc + 1`` nodes over ``n_loc`` spans, so cells and fracs equal the
unsharded ones, and the jet's derivatives are in global units.

The sharded jet goes through ``ops/fused_jet.py::fused_query_jet`` (the
CUDA jet kernels on a card, their plain twins on the CPU) with length-D
local bounds; the sharded value query is the plain, differentiable one
(the training step's towers and its jet-free loss take it).

Correctness contract (the JAX module's): the sharded axis' node count
divides by the group size, and each rank's points lie in its own range
(:func:`bin_points_by_shard`, or ``parallel/dp_sp.py::make_dp_sp_batch``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from space_time_pde_torch.models import query_local_implicit_grid
from space_time_pde_torch.parallel.collectives import exchange

__all__ = [
    "halo_exchange",
    "shard_bounds",
    "sharded_query_local_implicit_grid",
    "sharded_query_jet",
    "bin_points_by_shard",
]


def halo_exchange(latent_shard: torch.Tensor, mesh,
                  spatial_axis: int = -2) -> torch.Tensor:
    """Append the right neighbour's first node plane along
    ``spatial_axis``: ``[..., n_loc, C] -> [..., n_loc + 1, C]``; the
    last rank of the space group appends its own last plane.
    Differentiable (the halo's cotangent goes back to its owner)."""
    ax = spatial_axis % latent_shard.ndim
    first = latent_shard.narrow(ax, 0, 1)
    last = latent_shard.narrow(ax, latent_shard.shape[ax] - 1, 1)
    from_right, _ = exchange(first, None, mesh.space_ranks,
                             mesh.space_index, mesh.space_group)
    if mesh.space_index == mesh.n_space - 1:
        # Zeros arrive here; adding them keeps the exchange on this
        # rank's gradient path, so its backward returns the left
        # neighbour's cotangent of this rank's first plane.
        halo = from_right + last
    else:
        halo = from_right
    return torch.cat([latent_shard, halo], dim=ax)


def shard_bounds(index: int, n_shards: int, n_nodes_global: int,
                 xmin=0.0, xmax=1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) f32 coordinates of shard ``index``'s local grid with its
    halo, global nodes ``[index n_loc, index n_loc + n_loc]``, computed
    as the JAX ``shard_bounds`` computes them (f32 span, then
    ``xmin + nodes * span``)."""
    if n_nodes_global % n_shards:
        raise ValueError(f"sharded-axis nodes {n_nodes_global} not "
                         f"divisible by {n_shards} shards")
    n_loc = n_nodes_global // n_shards
    xmin = torch.as_tensor(xmin, dtype=torch.float32)
    xmax = torch.as_tensor(xmax, dtype=torch.float32)
    span = (xmax - xmin) / (n_nodes_global - 1)
    lo = xmin + torch.tensor(float(index * n_loc)) * span
    hi = xmin + torch.tensor(float(index * n_loc + n_loc)) * span
    return lo, hi


def _halo_and_local_bounds(latent_shard, pts_shard, mesh, n_nodes_global,
                           xmin, xmax, spatial_axis):
    """The halo-extended shard and its length-D local (xmin, xmax)."""
    grid_loc = halo_exchange(latent_shard, mesh, spatial_axis)
    dim = pts_shard.shape[-1]
    sa = spatial_axis % latent_shard.ndim
    coord_axis = sa - (latent_shard.ndim - 1 - dim)   # batch + channels
    xmin_v = torch.broadcast_to(torch.as_tensor(xmin, dtype=torch.float32),
                                (dim,)).clone()
    xmax_v = torch.broadcast_to(torch.as_tensor(xmax, dtype=torch.float32),
                                (dim,)).clone()
    lo, hi = shard_bounds(mesh.space_index, mesh.n_space, n_nodes_global,
                          xmin_v[coord_axis], xmax_v[coord_axis])
    xmin_v[coord_axis], xmax_v[coord_axis] = lo, hi
    dev = pts_shard.device
    return grid_loc, xmin_v.to(dev), xmax_v.to(dev)


def sharded_query_local_implicit_grid(decoder, latent_shard, pts_shard, mesh,
                                      n_nodes_global: int, xmin=0.0,
                                      xmax=1.0, spatial_axis: int = -2
                                      ) -> torch.Tensor:
    """Values of this rank's points ``[B, N_loc, D]`` on the sharded
    latent grid ``[B, ..., n_loc, C]`` (the sharded axis second to last
    by default: x of a ``[B, T, Z, X, C]`` grid); ``xmin`` / ``xmax``
    are the global bounds. The plain, differentiable query, ``decoder``
    mapping ``[..., D + C] -> [..., out]`` (an ImNet)."""
    grid_loc, lo, hi = _halo_and_local_bounds(
        latent_shard, pts_shard, mesh, n_nodes_global, xmin, xmax,
        spatial_axis)
    return query_local_implicit_grid(decoder, grid_loc, pts_shard, lo, hi)


def sharded_query_jet(imnet, latent_shard, pts_shard, mesh,
                      n_nodes_global: int, xmin=0.0, xmax=1.0,
                      spatial_axis: int = -2, fused: bool = True):
    """(value, jac, hess) of the sharded query, derivatives in the global
    point units; the contract of :func:`sharded_query_local_implicit_grid`.
    ``fused``: ``fused_query_jet`` (the jet kernels on a card), else the
    plain analytic jet of ``ops/jet.py``."""
    from space_time_pde_torch.ops.fused_jet import fused_query_jet
    from space_time_pde_torch.ops.jet import query_local_implicit_grid_jet

    grid_loc, lo, hi = _halo_and_local_bounds(
        latent_shard, pts_shard, mesh, n_nodes_global, xmin, xmax,
        spatial_axis)
    if fused:
        return fused_query_jet(imnet, grid_loc, pts_shard, lo, hi)
    return query_local_implicit_grid_jet(imnet, grid_loc, pts_shard, lo, hi)


def bin_points_by_shard(pts: np.ndarray, n_shards: int,
                        n_nodes_global: int, coord_axis: int = 2,
                        xmin: float = 0.0, xmax: float = 1.0
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side routing of arbitrary points to grid shards: (binned
    ``[n_shards, M, D]``, mask ``[n_shards, M]``, the inverse permutation
    that restores the original order from the concatenated valid
    outputs). M is the largest bin; bins are padded with their first
    point (an empty bin with ``xmin``), and the mask selects real
    outputs. The JAX function, line for line."""
    n = pts.shape[0]
    n_loc = n_nodes_global // n_shards
    span = (xmax - xmin) / (n_nodes_global - 1)
    x = pts[:, coord_axis]
    cellf = np.clip((x - xmin) / span, 0, n_nodes_global - 1 - 1e-6)
    shard = np.clip((cellf // n_loc).astype(int), 0, n_shards - 1)
    order = np.argsort(shard, kind="stable")
    counts = np.bincount(shard, minlength=n_shards)
    m = int(counts.max()) if n else 1
    binned = np.zeros((n_shards, m, pts.shape[1]), pts.dtype)
    mask = np.zeros((n_shards, m), bool)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for s in range(n_shards):
        sel = order[starts[s]:starts[s] + counts[s]]
        binned[s, :counts[s]] = pts[sel]
        if counts[s] < m and counts[s] > 0:
            binned[s, counts[s]:] = pts[sel[0]]
        elif counts[s] == 0:
            binned[s, :] = xmin
        mask[s, :counts[s]] = True
    inverse = np.argsort(order, kind="stable")
    return binned, mask, inverse
