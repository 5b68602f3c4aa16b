"""The train CLIs' parallel layout: ``--space_devices``,
``--sharded_encoder``, ``--multihost``.

The JAX drivers (``experiments/rb2d/train.py``,
``experiments/turb3d/train.py``) lay a device mesh out of the local (or,
under ``--multihost``, the global) devices; here the world is the
ranks ``torchrun`` (or the ``STPDE_*`` variables) started, one device
each, and :class:`Layout` applies the JAX drivers' rules to it:

- ``--sharded_encoder`` requires ``--space_devices > 1``;
- ``--multihost`` scales the data axis only (``--space_devices 1``),
  and each process draws its own rows from ``seed + 1000 * rank``;
- otherwise every rank draws the same global batch (``batch_size_per_gpu
  x n_data`` crops) from the seed and keeps its block, so a run of N
  ranks sees the batches of the JAX driver on N devices;
- the space size must divide the world;
- batches are assembled on the device only when the space size is 1.

Rank 0 alone writes logs, checkpoints and the eval line; every rank
takes the same non-finite and cliff decisions from the all-reduced
metrics.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.distributed as dist

from space_time_pde_torch.models.unet3d import UNet3d, set_norm_group
from space_time_pde_torch.parallel.dp import (
    batch_block, init_multihost, make_dp_multi_step,
    launch_env, make_dp_train_step, make_mesh, rank_device,
    replicate_state)
from space_time_pde_torch.parallel.dp_sp import (
    dp_sp_block, make_dp_sp_batch, make_dp_sp_loss_fn,
    make_dp_sp_train_step, stack_dp_sp_batches)
from space_time_pde_torch.train.trainer import (
    make_multi_step, make_train_step)

__all__ = ["Layout"]


class Layout:
    """Joins the world (when launched), checks the flags and lays out the
    ``[data][space]`` mesh; builds the step and draws this rank's
    batches."""

    def __init__(self, space_devices: int, sharded_encoder: bool,
                 multihost: bool, device: str, num_devices: int = 0):
        n_space = max(1, space_devices)
        if sharded_encoder and n_space < 2:
            raise SystemExit("--sharded_encoder requires --space_devices>1")
        if multihost and n_space > 1:
            raise SystemExit(
                "--multihost scales the data axis only (the halo exchange "
                "and the query binning stay within a host); use "
                "--space_devices on single-host runs")
        kind = torch.device(device).type
        self.launched = multihost or bool(launch_env())
        if self.launched:
            self.rank, self.world = init_multihost(kind)
            self.device = rank_device(kind)
        else:
            self.rank, self.world = 0, 1
            self.device = torch.device(device)
        if num_devices and num_devices != self.world:
            raise SystemExit(f"--num_devices {num_devices} != the world of "
                             f"{self.world} rank(s) this run was launched "
                             "with")
        if self.world % n_space:
            raise SystemExit(f"--space_devices {n_space} must divide device "
                             f"count {self.world}")
        self.n_space, self.n_data = n_space, self.world // n_space
        self.sharded, self.multihost = sharded_encoder, multihost
        self.mesh = make_mesh(self.n_data, n_space)
        self.is_main = self.rank == 0
        self.encoder = None

    def describe(self) -> str:
        backend = dist.get_backend() if self.launched else "none"
        enc = ("sharded (halo convs)" if self.sharded else
               "replicated" if self.n_space > 1 else "whole")
        return (f"world={self.world} (data {self.n_data} x space "
                f"{self.n_space}) backend={backend} encoder={enc}")

    def global_rows(self, per_rank: int) -> int:
        """Crops a step: ``batch_size_per_gpu x n_data``."""
        return per_rank * self.n_data

    def prepare(self, unet: torch.nn.Module, norm: str) -> None:
        """BatchNorm statistics synced over the data group (the JAX
        drivers' ``bn_axis_name="data"``), and the sharded encoder: a
        twin of ``unet`` sharing its parameters (``ShardedUNet3d`` /
        ``ShardedUNet4d``), its BatchNorms synced over the world."""
        if norm == "batch" and self.launched:
            set_norm_group(unet, self.mesh.data_group)
        self.encoder = unet
        if self.sharded:
            if isinstance(unet, UNet3d):
                from space_time_pde_torch.parallel.sharded_unet import (
                    ShardedUNet3d as cls)
            else:
                from space_time_pde_torch.parallel.sharded_unet4d import (
                    ShardedUNet4d as cls)
            self.encoder = cls.from_plain(unet, self.mesh)

    def replicate(self, state):
        """Rank 0's state on every rank, checked (``dp.replicate_state``)."""
        return replicate_state(state, self.mesh) if self.launched else state

    def make_step(self, cfg, imnet, pde_layer, loss_fn, opt, inner: int,
                  debug_nans: bool = False) -> Callable:
        """The step for this layout: ``loss_fn`` (the single-device loss,
        possibly device-sampled) whole or data-parallel; the data x space
        loss on :attr:`encoder` when the space size exceeds 1."""
        if self.n_space > 1:
            sp_loss = make_dp_sp_loss_fn(cfg, self.encoder, imnet, pde_layer,
                                         self.mesh, self.sharded)
            return make_dp_sp_train_step(sp_loss, opt, self.mesh, inner,
                                         debug_nans)
        if self.launched:
            if inner > 1:
                return make_dp_multi_step(loss_fn, opt, inner, self.mesh,
                                          debug_nans)
            return make_dp_train_step(loss_fn, opt, self.mesh, debug_nans)
        if inner > 1:
            return make_multi_step(loss_fn, opt, inner, debug_nans)
        return make_train_step(loss_fn, opt, debug_nans)

    def draw(self, one_batch: Callable[[int], Dict[str, np.ndarray]],
             per_rank: int, inner: int, x_nodes: int = 0
             ) -> Dict[str, np.ndarray]:
        """This rank's host batch for one step (``inner`` stacked):
        ``one_batch(rows)`` draws ``rows`` crops."""
        rows = per_rank if self.multihost else self.global_rows(per_rank)
        bs = [one_batch(rows) for _ in range(inner)]
        if self.n_space > 1:
            bs = [make_dp_sp_batch(b, self.n_space, x_nodes) for b in bs]
            raw = stack_dp_sp_batches(bs) if inner > 1 else bs[0]
            return dp_sp_block(raw, self.mesh, self.sharded, inner > 1)
        raw = bs[0] if inner == 1 else {
            k: np.stack([b[k] for b in bs]) for k in bs[0]}
        if self.multihost or self.n_data == 1:
            return raw
        return batch_block(raw, self.mesh.data_index, self.n_data,
                           axis=1 if inner > 1 else 0)

    def barrier(self) -> None:
        if self.launched:
            if dist.get_backend() == "nccl":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()
