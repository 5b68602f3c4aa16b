"""UNet4d on an x-sharded 4-D grid (halo convs).

Counterpart of ``space_time_pde_tpu/parallel/sharded_unet4d.py``. The
4-D conv is factorized (``models/unet4d.py::Conv4d``): a 3-D conv over
(z, y, x) with time folded into the batch, then a 1-D conv over t with
space folded into the batch. Only the spatial factor sees the sharded x
axis, so :class:`HaloConv4d` is ``Conv4d`` with its spatial factor a
:class:`~space_time_pde_torch.parallel.halo_conv.HaloConv3d` (SAME in
(z, y), halo in x) and ``Conv4d``'s own temporal matrix product,
reused. The 1x1x1x1 convs, the nearest x2 up-sampling (a per-shard
repeat of a block partition equals the global repeat) and the temporal
factor are shard-local; the GroupNorms become ``ShardedGroupNorm``.
Same modules, order and state-dict names as ``UNet4d``.
"""

from __future__ import annotations

import torch

from space_time_pde_torch.models.unet4d import Conv4d, UNet4d
from space_time_pde_torch.parallel.halo_conv import HaloConv3d
from space_time_pde_torch.parallel.sharded_unet import (
    shard_layers, sharded_twin)

__all__ = ["HaloConv4d", "ShardedUNet4d"]


class HaloConv4d(Conv4d):
    """``Conv4d`` on an x-sharded block ``[B, C, T, Z, Y, X_loc]``: the
    spatial factor is a ``HaloConv3d`` (no bias); the temporal factor is
    ``Conv4d``'s."""

    def __init__(self, in_channels: int, features: int,
                 kernel_spatial: int = 3, kernel_time: int = 3,
                 stride: int = 1, use_bias: bool = True, mesh=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, features, kernel_spatial, kernel_time,
                         stride, use_bias, dtype)
        self.spatial = HaloConv3d(in_channels, features, kernel_spatial,
                                  stride, bias=False, mesh=mesh, dtype=dtype)

    @classmethod
    def like(cls, conv: Conv4d, mesh) -> "HaloConv4d":
        return cls(conv.spatial.in_channels, conv.spatial.out_channels,
                   conv.ks, conv.kt, conv.stride,
                   conv.temporal.bias is not None, mesh, conv.dtype)

    def _conv_space(self, h: torch.Tensor) -> torch.Tensor:
        return self.spatial(h)                   # HaloConv3d pads itself


class ShardedUNet4d(UNet4d):
    """x-sharded UNet4d: ``[B, T, Z, Y, X_loc, C]`` -> the latent shard;
    ``igres`` is the global (T, Z, Y, X); the local x must stay even
    through every level. GroupNorm only (as ``UNet4d``)."""

    def __init__(self, *args, mesh=None, **kw):
        super().__init__(*args, **kw)
        self.mesh = mesh
        shard_layers(self, mesh, conv4d=HaloConv4d.like)

    @classmethod
    def from_plain(cls, unet: UNet4d, mesh) -> "ShardedUNet4d":
        """The sharded twin of ``unet``, sharing its parameters."""
        return sharded_twin(cls, unet, mesh, conv4d=HaloConv4d.like)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_space = 1 if self.mesh is None else self.mesh.n_space
        lv = self.levels
        if tuple(x.shape[1:4]) != self.igres[:3]:
            raise ValueError(f"ShardedUNet4d built for global igres "
                             f"{self.igres}, got input T/Z/Y "
                             f"{tuple(x.shape[1:4])}")
        if x.shape[4] * n_space != self.igres[3]:
            raise ValueError(f"local x {x.shape[4]} x {n_space} shards does "
                             f"not tile global X {self.igres[3]}")
        if x.shape[4] % (2 ** lv):
            raise ValueError(f"local x {x.shape[4]} not divisible by 2^{lv}")
        return self._body(x)
