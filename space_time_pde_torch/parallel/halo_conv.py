"""Convolutions on an x-sharded grid: halo exchange, HaloConv3d,
ShardedGroupNorm.

Counterpart of ``space_time_pde_tpu/parallel/halo_conv.py``, the pieces
of the sharded encoders (``sharded_unet.py``, ``sharded_unet4d.py``):

- :func:`halo_exchange_x`: widen a block with ``left`` planes of the
  left neighbour and ``right`` planes of the right neighbour along x,
  zeros at the global edges, so a VALID conv over the widened block is
  the global SAME conv;
- :class:`HaloConv3d`: an ``nn.Conv3d`` (same parameters and names) on
  channels-first ``[B, C, T, Z, X_loc]``: SAME in (t, z) with XLA's
  padding split (the odd pad at the end, ``models/unet3d.py::same_pad``),
  halo plus VALID in x. Stride 2 (kernel 3) needs an even local x and
  takes a right halo of 1 only (XLA's SAME at even sizes pads (0, 1));
- :class:`ShardedGroupNorm`: an ``nn.GroupNorm`` (eps 1e-6) whose
  per-(sample, group) sums are all-reduced over the space group with
  gradient, the variance as ``mean_sq - mean**2`` (the JAX module's
  form, not ``nn.GroupNorm``'s two-pass one).

With a space group of one rank (or none) each equals the unsharded op,
which is how parity is tested.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from space_time_pde_torch.parallel.collectives import (
    all_reduce_sum, exchange)

__all__ = ["halo_exchange_x", "HaloConv3d", "ShardedGroupNorm"]


def halo_exchange_x(h: torch.Tensor, mesh, left: int = 1, right: int = 1,
                    axis: int = -2) -> torch.Tensor:
    """``h`` widened along ``axis`` (x; -2 is channels-last's x, the
    modules pass -1 for channels-first) by ``left`` planes from the left
    neighbour's right edge and ``right`` planes from the right
    neighbour's left edge; zeros at the global edges. Differentiable."""
    ax = axis % h.ndim
    n = h.shape[ax]
    if left and right and left != right:
        raise ValueError("halo_exchange_x: unequal left/right halos")
    to_left = h.narrow(ax, 0, right) if right else None
    to_right = h.narrow(ax, n - left, left) if left else None
    from_right, from_left = exchange(to_left, to_right, mesh.space_ranks,
                                     mesh.space_index, mesh.space_group)
    parts = ([from_left] if left else []) + [h] + \
        ([from_right] if right else [])
    return torch.cat(parts, dim=ax)


def _same(n: int, k: int, s: int):
    """XLA "SAME" padding of one axis: (low, high), the odd pad high."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class HaloConv3d(nn.Conv3d):
    """3-D conv on an x-sharded block ``[B, C, T, Z, X_loc]`` (see the
    module docstring); ``mesh`` is the rank's
    :class:`~space_time_pde_torch.parallel.dp.Mesh` (its space group)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3,
                 stride=1, bias: bool = True, mesh=None):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, bias=bias)
        self.mesh = mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kt, kz, kx = self.kernel_size
        st, sz, sx = self.stride
        if sx == 1:
            left = right = (kx - 1) // 2
        elif sx == 2:
            if x.shape[-1] % 2:
                raise ValueError("stride-2 HaloConv3d needs an even local x, "
                                 f"got {x.shape[-1]}")
            left, right = 0, kx - 1 - (kx - 1) // 2
        else:
            raise ValueError(f"unsupported x stride {sx}")
        if left or right:
            x = halo_exchange_x(x, self.mesh, left, right, axis=-1)
        pt, pz = _same(x.shape[2], kt, st), _same(x.shape[3], kz, sz)
        x = F.pad(x, (0, 0) + pz + pt)
        return F.conv3d(x, self.weight, self.bias, self.stride)


class ShardedGroupNorm(nn.GroupNorm):
    """GroupNorm over channels-first ``[B, C, *S_loc]`` with statistics
    across the space group (see the module docstring)."""

    def __init__(self, num_groups: int, num_channels: int, mesh=None,
                 eps: float = 1e-6):
        super().__init__(num_groups, num_channels, eps=eps)
        self.mesh = mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        g = self.num_groups
        xg = x.reshape(b, g, -1)
        n_space = 1 if self.mesh is None else self.mesh.n_space
        cnt = float(xg.shape[-1] * n_space)
        group = None if self.mesh is None else self.mesh.space_group
        sums = all_reduce_sum(torch.stack([xg.sum(-1), (xg * xg).sum(-1)]),
                              group)
        mean, mean_sq = sums[0] / cnt, sums[1] / cnt
        inv = torch.rsqrt(mean_sq - mean * mean + self.eps)
        xn = ((xg - mean[..., None]) * inv[..., None]).reshape(x.shape)
        shape = (1, c) + (1,) * (x.ndim - 2)
        return xn * self.weight.reshape(shape) + self.bias.reshape(shape)
