"""UNet3d on an x-sharded grid (halo convs).

Counterpart of ``space_time_pde_tpu/parallel/sharded_unet.py``: the
port's :class:`~space_time_pde_torch.models.unet3d.UNet3d` with its
3x3x3 convs as :class:`~space_time_pde_torch.parallel.halo_conv.HaloConv3d`
and its GroupNorms as ``ShardedGroupNorm`` (BatchNorm keeps its class
and syncs its statistics over a process group instead). The 1x1x1 convs
and the k=2/s=2 transposed convs (each output voxel has one input, a
shard-local scatter) run unchanged on the shard. Same modules, same
order, same state-dict names as ``UNet3d``, so one checkpoint loads
into either, and :func:`ShardedUNet3d.from_plain` builds one that
shares the plain module's parameters and buffers (an optimizer step on
either moves both): the training step runs the sharded module, the eval
and the checkpoints the plain one.

Input: this rank's x shard ``[B, T, Z, X_loc, C]`` of the global
``igres``; output: its latent shard. The local x must stay even through
every level (``X / n_space`` divisible by ``2**levels``).
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn

from space_time_pde_torch.models.policy import Conv3d
from space_time_pde_torch.models.unet3d import BatchNorm, GroupNorm, UNet3d
from space_time_pde_torch.parallel.halo_conv import (
    HaloConv3d, ShardedGroupNorm)

__all__ = ["ShardedUNet3d", "share_tensors", "shard_layers", "sharded_twin"]


def _halo_conv(conv: Conv3d, mesh) -> HaloConv3d:
    return HaloConv3d(conv.in_channels, conv.out_channels, conv.kernel_size,
                      conv.stride, conv.bias is not None, mesh, conv.dtype)


def shard_layers(module: nn.Module, mesh, conv4d=None) -> None:
    """Swap, in place and in order, every 3x3x3 conv below ``module``
    (the policy's ``Conv3d``) for a :class:`HaloConv3d` of its dtype and
    every ``nn.GroupNorm`` for a :class:`ShardedGroupNorm` over ``mesh``;
    every ``BatchNorm`` syncs
    its statistics over the whole world (each rank sees part of the
    positions and part of the batch). ``conv4d(child, mesh)``, where
    given, replaces each ``Conv4d`` with a spatial kernel above 1."""
    from space_time_pde_torch.models.unet4d import Conv4d

    for name, child in list(module.named_children()):
        if isinstance(child, Conv4d):
            if conv4d is not None and child.ks > 1:
                setattr(module, name, conv4d(child, mesh))
        elif type(child) is Conv3d and child.kernel_size[-1] > 1:
            setattr(module, name, _halo_conv(child, mesh))
        elif type(child) in (nn.GroupNorm, GroupNorm):
            setattr(module, name, ShardedGroupNorm(
                child.num_groups, child.num_channels, mesh, child.eps))
        elif isinstance(child, BatchNorm):
            child.group = None if mesh is None else mesh.world_group
        else:
            shard_layers(child, mesh, conv4d)


@torch.no_grad()
def share_tensors(dst: nn.Module, src: nn.Module) -> nn.Module:
    """Make ``dst``'s parameters and buffers ``src``'s own tensors (the
    two state-dict key sets must match)."""
    want = set(dict(src.named_parameters())) | set(dict(src.named_buffers()))
    have = set(dict(dst.named_parameters())) | set(dict(dst.named_buffers()))
    if want != have:
        raise ValueError(f"state-dict names differ: {sorted(want ^ have)[:5]}")
    for table in ("_parameters", "_buffers"):
        named = (src.named_parameters() if table == "_parameters"
                 else src.named_buffers())
        for name, t in named:
            path, _, leaf = name.rpartition(".")
            mod = dst.get_submodule(path) if path else dst
            getattr(mod, table)[leaf] = t
    return dst


def sharded_twin(cls, unet: nn.Module, mesh, conv4d=None) -> nn.Module:
    """``unet``'s modules copied in order as a ``cls`` over ``mesh``
    (:func:`shard_layers`), then given ``unet``'s own parameters and
    buffers (:func:`share_tensors`)."""
    memo = {id(m.group): m.group for m in unet.modules()
            if isinstance(m, BatchNorm) and m.group is not None}
    twin = copy.deepcopy(unet, memo)
    twin.__class__ = cls
    twin.mesh = mesh
    shard_layers(twin, mesh, conv4d)
    return share_tensors(twin, unet)


class ShardedUNet3d(UNet3d):
    """x-sharded UNet3d; ``mesh`` is the rank's
    :class:`~space_time_pde_torch.parallel.dp.Mesh`, ``igres`` the
    global (T, Z, X)."""

    def __init__(self, *args, mesh=None, **kw):
        super().__init__(*args, **kw)
        self.mesh = mesh
        shard_layers(self, mesh)

    @classmethod
    def from_plain(cls, unet: UNet3d, mesh) -> "ShardedUNet3d":
        """The sharded twin of ``unet``, sharing its parameters and
        buffers."""
        return sharded_twin(cls, unet, mesh)

    def _down(self, i: int, h: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"down{i}")(h)      # HaloConv3d pads itself

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: ``[B, T, Z, X_loc, C]`` -> ``[B, T, Z, X_loc, out]``."""
        n_space = 1 if self.mesh is None else self.mesh.n_space
        want = self.igres[:2] + (self.igres[2] // n_space,)
        if tuple(x.shape[1:4]) != want or self.igres[2] % n_space:
            raise ValueError(f"ShardedUNet3d built for igres {self.igres} "
                             f"over {n_space} shards, got {tuple(x.shape)}")
        if x.shape[3] % (2 ** self.levels):
            raise ValueError(f"local x {x.shape[3]} not divisible by "
                             f"2^{self.levels}")
        return self._body(x)
