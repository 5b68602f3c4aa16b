"""UNet3d spatiotemporal encoder (PyTorch).

Counterpart of ``space_time_pde_tpu/models/unet3d.py``: lift the
physical channels to ``nf``, encode with bottleneck residual blocks and
stride-2 convs (filters doubling, capped at ``mf``), decode with
transposed convs and skip concatenation, and emit a latent grid at the
input's (t, z, x) resolution. The public layout stays channels-last
``[B, T, Z, X, C]``; the convs run channels-first inside.

What has to match the flax model exactly:

- the stride-2 "SAME" down-convs pad ``(0, 1)`` per axis at even sizes
  (XLA puts the odd pad at the end); ``nn.Conv3d(padding=1)`` would pad
  ``(1, 1)`` and shift the output by one voxel, so :func:`same_pad`
  pads explicitly;
- GroupNorm eps is 1e-6 (flax's default, torch's is 1e-5), with the
  group count of :func:`_num_groups`;
- BatchNorm (eps 1e-5) in train mode computes flax's statistics, not
  ``nn.BatchNorm3d``'s: over (B, T, Z, X), the variance in the fast form
  ``max(0, E[x^2] - E[x]^2)``, and the running averages updated as
  ``0.9 ra + 0.1 stat`` with that biased variance (torch's own update
  uses the unbiased one); in eval mode it runs on its running
  statistics (:class:`BatchNorm`). With a process group set
  (:func:`set_norm_group`), train mode averages the per-channel mean and
  mean of squares over the group's ranks before the variance, with
  gradient, as flax's ``nn.BatchNorm(axis_name=...)`` pmeans them; the
  running update and eval mode are unchanged;
- the transposed-conv kernel is the flax kernel flipped in space
  (flax convolves, torch cross-correlates) — done by ``bridge.py``.

GroupNorm (the default) acts the same in both modes; with BatchNorm the
module's ``train()`` / ``eval()`` mode picks batch or running
statistics, as flax's ``train`` argument does.

``dtype`` is flax's compute policy (``models/policy.py``): at bf16 every
conv and transposed conv casts its input, kernel and bias and returns
bf16, the parameters stay f32, and the norms compute and return f32, as
flax's do without a ``dtype`` of their own. So ``conv_in``'s and the
``up{i}`` activations run on bf16, the ones after a norm on f32, the
residual add and the skip concatenation promote to f32, and the output
is cast to f32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.distributed as dist
import torch.nn.functional as F

from space_time_pde_torch.models.nonlinearities import get_activation
from space_time_pde_torch.models.policy import (
    Conv3d, ConvTranspose3d, widen)
from space_time_pde_torch.parallel.collectives import all_reduce_sum

__all__ = ["UNet3d", "ResBlock3D", "BatchNorm", "GroupNorm", "make_norm",
           "same_pad", "set_norm_group"]

BN_MOMENTUM = 0.9          # flax's: ra <- 0.9 ra + 0.1 stat


def _num_groups(ch: int) -> int:
    """Largest group count <= 8 that divides ch."""
    for g in (8, 4, 2, 1):
        if ch % g == 0:
            return g
    return 1


class BatchNorm(nn.BatchNorm3d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    axis of ``[B, C, *S]``. Train mode normalises with the batch's own
    statistics, computed as flax computes them, and moves the running
    averages (buffers, as in ``nn.BatchNorm3d``, so state dicts and the
    bridge are unchanged); eval mode is ``nn.BatchNorm3d``'s running-stat
    path."""

    def __init__(self, ch: int):
        super().__init__(ch, eps=1e-5, momentum=1 - BN_MOMENTUM)
        self.group = None               # process group of synced stats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        axes = [0] + list(range(2, x.ndim))
        mean, mean_sq = x.mean(axes), (x * x).mean(axes)
        if self.group is not None:
            both = all_reduce_sum(torch.stack([mean, mean_sq]), self.group)
            mean, mean_sq = both / dist.get_world_size(self.group)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        with torch.no_grad():
            for ra, stat in ((self.running_mean, mean),
                             (self.running_var, var)):
                ra.copy_(BN_MOMENTUM * ra + (1 - BN_MOMENTUM) * stat)
            self.num_batches_tracked += 1
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)


def set_norm_group(module: nn.Module, group) -> None:
    """Sync the batch statistics of every :class:`BatchNorm` in
    ``module`` over ``group`` (None: each rank's own)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` that also normalises a group of one value, as
    flax's ``GroupNorm`` does (to 0, so the output is the offset):
    ``F.group_norm`` refuses such an input in Python ("Expected more
    than 1 value per channel when training", in eval mode too), while
    the ATen op it calls computes it. So this calls the op directly,
    with ``F.group_norm``'s arguments: on every other shape the output
    is ``nn.GroupNorm``'s, bit for bit. It shows at batch 1 where the
    bottleneck is one voxel with one channel a group (UNet4d nf 2 / mf 8
    at igres (4, 4, 4, 4))."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.group_norm(x, self.num_groups, self.weight, self.bias,
                                self.eps, torch.backends.cudnn.enabled)


def make_norm(norm: str, ch: int) -> nn.Module:
    if norm == "batch":
        return BatchNorm(ch)
    if norm == "group":
        return GroupNorm(_num_groups(ch), ch, eps=1e-6)
    raise ValueError(f"unknown norm {norm!r}; available: group, batch")


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Pad the spatial axes of ``x [B, C, *S]`` as XLA's "SAME" does:
    total ``max((ceil(n/s) - 1) * s + k - n, 0)`` per axis, the smaller
    half first."""
    pads = []
    for n in reversed(x.shape[2:]):
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class ResBlock3D(nn.Module):
    """1x1x1 reduce -> 3x3x3 -> 1x1x1 expand with norms, activation and
    a projected shortcut when channel counts differ."""

    def __init__(self, in_channels: int, neck_channels: int,
                 out_channels: int, negative_slope: float = 0.01,
                 activation: str = "leaky_relu", norm: str = "group",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = get_activation(activation, negative_slope)
        self.conv1 = Conv3d(in_channels, neck_channels, 1, dtype=dtype)
        self.norm1 = make_norm(norm, neck_channels)
        self.conv2 = Conv3d(neck_channels, neck_channels, 3, padding=1,
                            dtype=dtype)
        self.norm2 = make_norm(norm, neck_channels)
        self.conv3 = Conv3d(neck_channels, out_channels, 1, dtype=dtype)
        self.norm3 = make_norm(norm, out_channels)
        self.proj = (Conv3d(in_channels, out_channels, 1, bias=False,
                            dtype=dtype)
                     if in_channels != out_channels else None)

    def forward(self, x):
        h = self.act(self.norm1(widen(self.conv1(x))))
        h = self.act(self.norm2(widen(self.conv2(h))))
        h = self.norm3(widen(self.conv3(h)))
        if self.proj is not None:
            x = self.proj(x)
        return self.act(h + x)


class UNet3d(nn.Module):
    """3-D (t, z, x) U-Net encoder; module names follow the flax model
    (``conv_in``, ``down_res{i}``, ``down{i}``, ``bottleneck``,
    ``up{i}``, ``up_res{i}``, ``conv_out``)."""

    def __init__(self, in_features: int = 4, out_features: int = 32,
                 igres: Sequence[int] = (4, 16, 16), nf: int = 16,
                 mf: int = 512, negative_slope: float = 0.01,
                 activation: str = "leaky_relu", norm: str = "group",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.igres = tuple(igres)
        self.dtype = dtype
        self.levels = int(math.floor(math.log2(min(self.igres))))
        for r in self.igres:
            if r % (2 ** self.levels) != 0:
                raise ValueError(f"igres {self.igres} not divisible by "
                                 f"2^{self.levels}")
        self.act = get_activation(activation, negative_slope)
        blk = lambda cin, ch: ResBlock3D(cin, max(ch // 2, 1), ch,
                                         negative_slope, activation, norm,
                                         dtype)
        self.conv_in = Conv3d(in_features, nf, 3, padding=1, dtype=dtype)
        chs = []
        ch = nf
        for i in range(self.levels):
            self.add_module(f"down_res{i}", blk(ch, ch))
            chs.append(ch)
            nxt = min(ch * 2, mf)
            self.add_module(f"down{i}", Conv3d(ch, nxt, 3, stride=2,
                                               dtype=dtype))
            ch = nxt
        self.bottleneck = blk(ch, ch)
        for i in reversed(range(self.levels)):
            self.add_module(f"up{i}", ConvTranspose3d(
                ch, chs[i], 2, stride=2, dtype=dtype))
            self.add_module(f"up_res{i}", blk(2 * chs[i], chs[i]))
            ch = chs[i]
        self.conv_out = Conv3d(ch, out_features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, T, Z, X, in_features] -> [B, T, Z, X, out_features]."""
        if tuple(x.shape[1:4]) != self.igres:
            raise ValueError(f"UNet3d built for igres={self.igres}, "
                             f"got input grid {tuple(x.shape[1:4])}")
        return self._body(x)

    def _down(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """The stride-2 down-conv of level i, "SAME"-padded."""
        return getattr(self, f"down{i}")(same_pad(h, 3, 2))

    def _body(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(self.conv_in(x.permute(0, 4, 1, 2, 3)))
        skips = []
        for i in range(self.levels):
            h = getattr(self, f"down_res{i}")(h)
            skips.append(h)
            h = self.act(self._down(i, h))
        h = self.bottleneck(h)
        for i in reversed(range(self.levels)):
            h = self.act(getattr(self, f"up{i}")(h))
            h = getattr(self, f"up_res{i}")(torch.cat([h, skips[i]], 1))
        return widen(self.conv_out(h)).permute(0, 2, 3, 4, 1)
