"""Data parallelism over ``torch.distributed`` process groups.

Counterpart of ``space_time_pde_tpu/parallel/dp.py``. The JAX package
runs one jitted ``shard_map`` step on a device mesh; here every rank is
a process with one device, and the world is laid out as the JAX mesh
lays out its devices, ``[data][space]`` (:func:`make_mesh`). The step is
the port's own ``train/trainer.py`` step; after ``backward`` one
all-reduce over the data group averages the gradients (JAX's
``pmean``), in one flat buffer in the parameters' fixed order, and the
metrics the same way; the optimizer then runs unchanged on every rank,
so the replicas stay equal bit for bit.

This is an explicit all-reduce, not ``DistributedDataParallel``: the
step differentiates through two modules and the jet's autograd
Function, owns its optimizer (``train/optim.py``, optax's semantics),
and the data x space step (``parallel/dp_sp.py``) needs a SUM where DDP
averages.

Backends: ``nccl`` when each rank has a card of its own, ``gloo`` when
several ranks share one card or run on the CPU (NCCL refuses two ranks
on one device). The choice is printed; a backend that fails to start
raises, there is no fallback.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from space_time_pde_torch.train.trainer import (
    make_multi_step, make_train_step)

__all__ = ["Mesh", "launch_env", "init_multihost", "rank_device",
           "make_mesh", "batch_block", "replicate_state", "make_grad_sync",
           "make_dp_train_step", "make_dp_multi_step"]


def launch_env() -> Dict:
    """{init_method, world_size, rank, local_rank, local_world} from
    ``torchrun``'s variables, else from the JAX test's ``STPDE_*`` ones;
    {} when neither is set (a run of one process)."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        world = int(env["WORLD_SIZE"])
        return dict(init_method="env://", world_size=world,
                    rank=int(env["RANK"]),
                    local_rank=int(env.get("LOCAL_RANK", env["RANK"])),
                    local_world=int(env.get("LOCAL_WORLD_SIZE", world)))
    if "STPDE_COORDINATOR" in env:
        addr = env["STPDE_COORDINATOR"]
        if "://" not in addr:
            addr = f"tcp://{addr}"
        world = int(env["STPDE_NUM_PROCESSES"])
        rank = int(env["STPDE_PROCESS_ID"])
        # One process per host in the JAX test's layout.
        return dict(init_method=addr, world_size=world, rank=rank,
                    local_rank=0, local_world=1)
    return {}


def rank_device(kind: str = "cuda", local_rank: Optional[int] = None
                ) -> torch.device:
    """This rank's device: ``cuda:<local rank mod cards>`` (ranks share
    the cards round robin) or the CPU."""
    if kind == "cpu":
        return torch.device("cpu")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local_rank % max(1, torch.cuda.device_count()))


def init_multihost(device_kind: str = "cuda", backend: Optional[str] = None,
                   **kw) -> Tuple[int, int]:
    """Join the run's process group; returns ``(rank, world)``.

    Under ``torchrun`` the ranks come from ``RANK`` / ``WORLD_SIZE`` /
    ``LOCAL_RANK`` (``env://``); otherwise from ``STPDE_COORDINATOR``
    (``host:port`` or an init URL such as ``file://...``),
    ``STPDE_NUM_PROCESSES`` and ``STPDE_PROCESS_ID``; ``kw``
    (``init_method``, ``world_size``, ``rank``) overrides either.
    ``backend`` None picks ``nccl`` when every local rank has a card of
    its own and ``gloo`` otherwise (ranks sharing a card, or the CPU);
    a named backend that cannot start raises. One barrier runs at once,
    as the JAX package's ``sync_global_devices`` does. A second call in
    a process that already joined returns its ranks."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    spec = launch_env()
    spec.update(kw)
    if "init_method" not in spec:
        raise RuntimeError(
            "init_multihost: no process-group address (run under torchrun, "
            "or set STPDE_COORDINATOR / STPDE_NUM_PROCESSES / "
            "STPDE_PROCESS_ID)")
    local_rank = spec.get("local_rank", 0)
    local_world = spec.get("local_world", 1)
    cards = torch.cuda.device_count() if device_kind == "cuda" else 0
    if backend is None:
        backend = "nccl" if 0 < local_world <= cards else "gloo"
    if backend == "nccl" and device_kind != "cuda":
        raise ValueError("the nccl backend needs CUDA devices")
    device = rank_device(device_kind, local_rank)
    extra = {}
    if backend == "nccl":
        torch.cuda.set_device(device)
        extra["device_id"] = device
    dist.init_process_group(backend, init_method=spec["init_method"],
                            world_size=spec["world_size"],
                            rank=spec["rank"], **extra)
    if backend == "nccl":
        dist.barrier(device_ids=[device.index])
    else:
        dist.barrier()
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"multihost: process {spec['rank']}/{spec['world_size']}, "
          f"backend {backend}, device {device} ({name}), "
          f"{local_world} local rank(s) on {cards} card(s)", flush=True)
    return dist.get_rank(), dist.get_world_size()


@dataclass
class Mesh:
    """This rank's place in a ``[data][space]`` world: world rank
    ``d * n_space + s``. The groups are None only without a process
    group (a world of 1, no collective); a joined world of 1 keeps its
    groups, so its collectives still run on the backend."""
    n_data: int
    n_space: int
    data_index: int
    space_index: int
    data_group: Optional[object]
    space_group: Optional[object]
    world_group: Optional[object]
    space_ranks: List[int]            # world ranks of this space group

    @property
    def world(self) -> int:
        return self.n_data * self.n_space


def make_mesh(n_data: int, n_space: int = 1) -> Mesh:
    """Lay out the world as ``[n_data][n_space]``, as the JAX package's
    ``dp_sp`` reshapes its devices. Every rank calls ``dist.new_group``
    for every group, in one fixed order; a world of 1 needs no process
    group."""
    world = n_data * n_space
    if not dist.is_initialized():
        if world != 1:
            raise RuntimeError(f"a {n_data} x {n_space} mesh needs a process "
                               "group: call init_multihost first")
        return Mesh(1, 1, 0, 0, None, None, None, [0])
    if dist.get_world_size() != world:
        raise ValueError(f"mesh {n_data} x {n_space} != world "
                         f"{dist.get_world_size()}")
    rank = dist.get_rank()
    d, s = divmod(rank, n_space)
    data_group = space_group = None
    for si in range(n_space):
        g = dist.new_group([di * n_space + si for di in range(n_data)])
        if si == s:
            data_group = g
    for di in range(n_data):
        g = dist.new_group([di * n_space + si for si in range(n_space)])
        if di == d:
            space_group = g
    return Mesh(n_data, n_space, d, s, data_group, space_group,
                dist.group.WORLD, [d * n_space + si for si in range(n_space)])


def batch_block(batch: Dict, index: int, n: int, axis: int = 0) -> Dict:
    """Rank ``index``'s block of every array of a global batch, split in
    ``n`` equal blocks along ``axis`` (the batch axis; 1 for batches
    stacked for ``--inner_steps``)."""
    out = {}
    for k, v in batch.items():
        rows = v.shape[axis]
        if rows % n:
            raise ValueError(f"{k}: batch of {rows} not divisible by {n} "
                             "ranks")
        b = rows // n
        out[k] = np.take(v, np.arange(index * b, (index + 1) * b), axis=axis) \
            if isinstance(v, np.ndarray) else \
            v.narrow(axis, index * b, b)
    return out


def _state_tensors(state) -> List[torch.Tensor]:
    ts = list(state.params().values()) + list(state.buffers().values())
    for m in ("mu", "nu"):
        ts += list(state.opt_state[m].values())
    return ts


_COUNTERS = ("count", "notfinite_count", "total_notfinite")


@torch.no_grad()
def replicate_state(state, mesh: Mesh):
    """Broadcast rank 0's parameters, buffers and optimizer state (moments
    and counters) to every rank, then check that every rank holds the
    same bits (an all-reduce MAX and MIN of the flat state agree);
    raises otherwise. Identity without a process group."""
    if mesh.world_group is None:
        return state
    ts = _state_tensors(state)
    device = ts[0].device
    flat = torch.cat([t.reshape(-1).float() for t in ts])
    counters = torch.tensor([float(state.opt_state[k]) for k in _COUNTERS]
                            + [float(state.step)], dtype=torch.float64,
                            device=device)
    dist.broadcast(flat, 0)
    dist.broadcast(counters, 0)
    off = 0
    for t in ts:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    for k, v in zip(_COUNTERS, counters.tolist()[:-1]):
        state.opt_state[k] = int(v)
    state.step = int(counters[-1])
    lo, hi = flat.clone(), flat.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    if not torch.equal(lo, hi):
        raise RuntimeError("replicate_state: the ranks' states differ after "
                           "the broadcast")
    return state


def make_grad_sync(group, size: int, average: bool):
    """sync(grads, metrics): all-reduce every gradient (one flat buffer,
    the parameters' order) and every 0-d metric (sorted by name) over
    ``group``; ``average`` divides by ``size`` (JAX's ``pmean``), else a
    SUM (``psum``). None when there is nothing to reduce."""
    if group is None:
        return None

    @torch.no_grad()
    def sync(grads: Dict[str, torch.Tensor], metrics: Dict):
        keys = list(grads)
        flat = torch.cat([grads[k].reshape(-1) for k in keys])
        names = sorted(metrics)
        vals = torch.stack([metrics[k].detach().float().reshape(())
                            for k in names]).to(flat.device)
        buf = torch.cat([flat, vals])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        if average:
            buf /= size
        off = 0
        for k in keys:
            n = grads[k].numel()
            grads[k] = buf[off:off + n].view_as(grads[k])
            off += n
        for i, k in enumerate(names):
            metrics[k] = buf[off + i]

    return sync


def make_dp_train_step(loss_fn, opt, mesh: Mesh, debug_nans: bool = False):
    """step(state, batch) on this rank's block of the global batch; the
    gradients and metrics are averaged over the data group before the
    optimizer step (``make_dp_train_step`` of the JAX package)."""
    return make_train_step(
        loss_fn, opt, debug_nans,
        sync=make_grad_sync(mesh.data_group, mesh.n_data, average=True))


def make_dp_multi_step(loss_fn, opt, n_inner: int, mesh: Mesh,
                       debug_nans: bool = False):
    """``n_inner`` data-parallel steps over batches stacked on a leading
    axis (this rank's block along axis 1); the last step's metrics."""
    return make_multi_step(
        loss_fn, opt, n_inner, debug_nans,
        sync=make_grad_sync(mesh.data_group, mesh.n_data, average=True))
