"""Training on a data x space world: data parallelism times the x-sharded
latent grid.

Counterpart of ``space_time_pde_tpu/parallel/dp_sp.py``. The world is
``[n_data][n_space]`` (``parallel/dp.py::make_mesh``):

- ``data``: each data row holds a block of the batch's crops;
- ``space``: the latent grid is split along x, and each rank queries only
  the points binned to its x range (:func:`make_dp_sp_batch`), through
  the one-node halo of ``parallel/halo.py``.

Two encoders: replicated (every space rank encodes its crops whole and
keeps its x slice of the latent) or sharded (``ShardedUNet3d`` /
``ShardedUNet4d``, each rank encoding its x shard of the input with halo
convs: no rank ever holds the whole grid).

The loss is a masked mean over the global point count (the ragged bins
are padded and masked): each rank differentiates only its local part,
normalised by the global count, which is all-reduced without gradient;
after ``backward`` the gradients are all-reduced as a SUM over the whole
world, which is the gradient of the global masked mean (an average of
the ranks' gradients would be another step). The metrics are summed
the same way. Unlike the JAX step, which squares both terms whatever
the configuration asks, the regression term honours ``reg_loss_type``
(l1 / l2 / huber) and the PDE term ``pde_loss_type`` (l2 / huber), as
masked means of the same penalties the single-device loss takes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from space_time_pde_torch.models.nonlinearities import PIECEWISE_LINEAR
from space_time_pde_torch.parallel.dp import Mesh, make_grad_sync
from space_time_pde_torch.parallel.halo import (
    sharded_query_jet, sharded_query_local_implicit_grid)
from space_time_pde_torch.train.trainer import (
    make_multi_step, make_train_step)

__all__ = ["make_dp_sp_batch", "stack_dp_sp_batches", "dp_sp_block",
           "make_dp_sp_loss_fn", "make_dp_sp_train_step"]

PTS_KEYS = ("point_coord", "point_value", "point_mask")


def make_dp_sp_batch(batch: Dict[str, np.ndarray], n_space: int,
                     n_nodes_x: int, m_round: int = 64
                     ) -> Dict[str, np.ndarray]:
    """Bin each sample's points by x shard (their LAST coordinate, 3-D
    and 4-D alike); pad the ragged bins and mask them.

    In: point_coord ``[B, N, D]``, point_value ``[B, N, V]``, lres. Out:
    point_coord ``[B, S, M, D]``, point_value ``[B, S, M, V]``,
    point_mask ``[B, S, M]``; lres unchanged. M is the largest bin
    rounded up to a multiple of ``m_round``; padded slots sit at their
    shard's lower x bound. Vectorised numpy, the JAX function's output
    bit for bit."""
    coords = batch["point_coord"]
    values = batch["point_value"]
    b, n, d = coords.shape
    n_loc = n_nodes_x // n_space
    span = 1.0 / (n_nodes_x - 1)

    x = coords[..., -1]
    cellf = np.clip(x / span, 0, n_nodes_x - 1 - 1e-6)
    shard = np.clip((cellf // n_loc).astype(np.int64), 0,
                    n_space - 1)                               # [B, N]
    order = np.argsort(shard, axis=1, kind="stable")           # [B, N]
    sshard = np.take_along_axis(shard, order, axis=1)          # [B, N]
    counts = (sshard[:, :, None]
              == np.arange(n_space)[None, None]).sum(1)        # [B, S]
    m_max = int(counts.max()) if n else 1
    m = (max(m_round, -(-m_max // m_round) * m_round)
         if m_round else m_max)
    starts = np.concatenate(
        [np.zeros((b, 1), counts.dtype), np.cumsum(counts, 1)[:, :-1]],
        axis=1)                                                # [B, S]
    rank = (np.arange(n)[None]
            - np.take_along_axis(starts, sshard, axis=1))      # [B, N]
    bidx = np.broadcast_to(np.arange(b)[:, None], (b, n))

    pad_coord = np.zeros((n_space, d), coords.dtype)
    pad_coord[:, -1] = np.arange(n_space) * n_loc * span
    binned = np.broadcast_to(
        pad_coord[None, :, None, :], (b, n_space, m, d)).copy()
    vals = np.zeros((b, n_space, m, values.shape[-1]), values.dtype)
    mask = np.zeros((b, n_space, m), np.float32)
    binned[bidx, sshard, rank] = np.take_along_axis(
        coords, order[..., None], axis=1)
    vals[bidx, sshard, rank] = np.take_along_axis(
        values, order[..., None], axis=1)
    mask[bidx, sshard, rank] = 1.0

    out = dict(batch)
    out["point_coord"] = binned
    out["point_value"] = vals
    out["point_mask"] = mask
    return out


def stack_dp_sp_batches(batches) -> Dict[str, np.ndarray]:
    """Stack G dp-sp batches on a new leading axis (``--inner_steps``);
    ragged M axes are edge-padded (the last slot of a bin is always an
    in-range point), the mask with zeros."""
    m = max(bb["point_coord"].shape[2] for bb in batches)

    def pad_m(a, masked):
        if a.shape[2] == m:
            return a
        width = [(0, 0)] * a.ndim
        width[2] = (0, m - a.shape[2])
        return np.pad(a, width, mode="constant" if masked else "edge")

    out = {}
    for k in batches[0]:
        if k in PTS_KEYS:
            out[k] = np.stack([pad_m(bb[k], masked=(k == "point_mask"))
                               for bb in batches])
        else:
            out[k] = np.stack([bb[k] for bb in batches])
    return out


def dp_sp_block(batch: Dict[str, np.ndarray], mesh: Mesh,
                sharded_encoder: bool, stacked: bool = False
                ) -> Dict[str, np.ndarray]:
    """This rank's part of a global dp-sp batch: its data block of crops,
    its space bin of the points (``[b_loc, M, ...]``), and its x shard of
    lres with the sharded encoder (whole crops otherwise). ``stacked``:
    the arrays have a leading ``--inner_steps`` axis."""
    a = 1 if stacked else 0
    out = {}
    for k, v in batch.items():
        b = v.shape[a]
        if b % mesh.n_data:
            raise ValueError(f"{k}: batch of {b} not divisible by "
                             f"{mesh.n_data} data ranks")
        bl = b // mesh.n_data
        v = np.take(v, np.arange(mesh.data_index * bl,
                                 (mesh.data_index + 1) * bl), axis=a)
        if k in PTS_KEYS:
            v = np.take(v, mesh.space_index, axis=a + 1)
        elif k == "lres" and sharded_encoder:
            ax = v.ndim - 2                              # x, before C
            xl = v.shape[ax] // mesh.n_space
            v = np.take(v, np.arange(mesh.space_index * xl,
                                     (mesh.space_index + 1) * xl), axis=ax)
        out[k] = np.ascontiguousarray(v)
    return out


def _point_penalty(kind: str, err: torch.Tensor) -> torch.Tensor:
    """The elementwise penalty of ``trainer._reg_loss`` (l1, l2, huber
    with delta 1)."""
    if kind == "l1":
        return torch.abs(err)
    if kind == "l2":
        return torch.square(err)
    if kind == "huber":
        a = torch.abs(err)
        q = torch.clamp(a, max=1.0)
        return 0.5 * q ** 2 + (a - q)
    raise ValueError(f"unknown reg_loss_type {kind!r}")


def _pde_penalty(kind: str, r: torch.Tensor, delta: float = 1.0):
    """The elementwise penalty of ``PDELayer.residual_loss``."""
    if kind == "l2":
        return torch.square(r)
    if kind == "huber":
        a = torch.abs(r)
        return torch.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta))
    raise ValueError(f"unknown pde loss kind: {kind!r}")


def make_dp_sp_loss_fn(cfg, unet, imnet, pde_layer, mesh: Mesh,
                       sharded_encoder: bool = False):
    """loss_fn(block) -> (local loss, local metrics) on this rank's block
    (:func:`dp_sp_block`): lres ``[b_loc, *grid(_loc), C]``, point_coord
    ``[b_loc, M, D]``, point_value ``[b_loc, M, V]``, point_mask
    ``[b_loc, M]``. ``unet`` is the sharded encoder (its input is the x
    shard) when ``sharded_encoder``. The metrics are this rank's shares;
    their all-reduced SUM is the global masked mean."""
    alpha = cfg.train.alpha_pde
    reg_kind = cfg.train.reg_loss_type
    pde_kind = cfg.train.pde_loss_type
    use_jet = (pde_layer is not None and alpha > 0
               and cfg.train.pde_derivs in ("jet", "jet_jnp")
               and imnet.activation in PIECEWISE_LINEAR
               and pde_layer.max_derivative_order() <= 2)
    fused = cfg.train.pde_derivs == "jet" and cfg.model.fused_query

    def loss_fn(batch):
        lres = batch["lres"]
        coords, values = batch["point_coord"], batch["point_value"]
        mask = batch["point_mask"]
        unet.train()
        if sharded_encoder:
            latent_shard = unet(lres)
            x_nodes = latent_shard.shape[-2] * mesh.n_space
        else:
            latent = unet(lres)
            x_nodes = latent.shape[-2]
            n_loc = x_nodes // mesh.n_space
            latent_shard = latent.narrow(latent.ndim - 2,
                                         mesh.space_index * n_loc, n_loc)

        def fwd(pts):
            return sharded_query_local_implicit_grid(
                imnet, latent_shard, pts, mesh, x_nodes)

        if use_jet:
            jet = sharded_query_jet(imnet, latent_shard, coords, mesh,
                                    x_nodes, fused=fused)
            pred = jet[0]
        else:
            jet = None
            pred = fwd(coords)
        with torch.no_grad():
            cnt = mask.sum()
            if mesh.world_group is not None:
                dist.all_reduce(cnt, group=mesh.world_group)
            cnt = cnt + 1e-8
        err = _point_penalty(reg_kind, pred - values).sum(-1)
        reg = torch.sum(err * mask) / (cnt * values.shape[-1])
        metrics = {"reg_loss": reg}
        loss = reg
        if pde_layer is not None and alpha > 0:
            res = pde_layer(coords, fwd=fwd, jet=jet)
            pde = 0.0
            for name, r in res.items():
                eq = torch.sum(_pde_penalty(pde_kind, r) * mask) / cnt
                metrics[f"pde/{name}"] = eq
                pde = pde + eq
            metrics["pde_loss"] = pde
            loss = loss + alpha * pde
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def make_dp_sp_train_step(loss_fn, opt, mesh: Mesh, n_inner: int = 1,
                          debug_nans: bool = False):
    """step(state, block): the port's train step on
    :func:`make_dp_sp_loss_fn`'s loss, its gradients and metrics
    all-reduced as a SUM over the world before the optimizer step;
    ``n_inner`` > 1 chains steps over stacked blocks."""
    sync = make_grad_sync(mesh.world_group, mesh.world, average=False)
    if n_inner > 1:
        return make_multi_step(loss_fn, opt, n_inner, debug_nans, sync)
    return make_train_step(loss_fn, opt, debug_nans, sync)
