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
- BatchNorm runs on its running statistics (eval mode), eps 1e-5;
- the transposed-conv kernel is the flax kernel flipped in space
  (flax convolves, torch cross-correlates) — done by ``bridge.py``.

Eval only: there is no train mode (slice 2 brings training).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from space_time_pde_torch.models.nonlinearities import get_activation

__all__ = ["UNet3d", "ResBlock3D", "make_norm", "same_pad"]


def _num_groups(ch: int) -> int:
    """Largest group count <= 8 that divides ch."""
    for g in (8, 4, 2, 1):
        if ch % g == 0:
            return g
    return 1


def make_norm(norm: str, ch: int) -> nn.Module:
    if norm == "batch":
        return nn.BatchNorm3d(ch, eps=1e-5, momentum=0.1)
    if norm == "group":
        return nn.GroupNorm(_num_groups(ch), ch, eps=1e-6)
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
                 activation: str = "leaky_relu", norm: str = "group"):
        super().__init__()
        self.act = get_activation(activation, negative_slope)
        self.conv1 = nn.Conv3d(in_channels, neck_channels, 1)
        self.norm1 = make_norm(norm, neck_channels)
        self.conv2 = nn.Conv3d(neck_channels, neck_channels, 3, padding=1)
        self.norm2 = make_norm(norm, neck_channels)
        self.conv3 = nn.Conv3d(neck_channels, out_channels, 1)
        self.norm3 = make_norm(norm, out_channels)
        self.proj = (nn.Conv3d(in_channels, out_channels, 1, bias=False)
                     if in_channels != out_channels else None)

    def forward(self, x):
        h = self.act(self.norm1(self.conv1(x)))
        h = self.act(self.norm2(self.conv2(h)))
        h = self.norm3(self.conv3(h))
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
                 activation: str = "leaky_relu", norm: str = "group"):
        super().__init__()
        self.igres = tuple(igres)
        self.levels = int(math.floor(math.log2(min(self.igres))))
        for r in self.igres:
            if r % (2 ** self.levels) != 0:
                raise ValueError(f"igres {self.igres} not divisible by "
                                 f"2^{self.levels}")
        self.act = get_activation(activation, negative_slope)
        blk = lambda cin, ch: ResBlock3D(cin, max(ch // 2, 1), ch,
                                         negative_slope, activation, norm)
        self.conv_in = nn.Conv3d(in_features, nf, 3, padding=1)
        chs = []
        ch = nf
        for i in range(self.levels):
            self.add_module(f"down_res{i}", blk(ch, ch))
            chs.append(ch)
            nxt = min(ch * 2, mf)
            self.add_module(f"down{i}", nn.Conv3d(ch, nxt, 3, stride=2))
            ch = nxt
        self.bottleneck = blk(ch, ch)
        for i in reversed(range(self.levels)):
            self.add_module(f"up{i}", nn.ConvTranspose3d(ch, chs[i], 2,
                                                         stride=2))
            self.add_module(f"up_res{i}", blk(2 * chs[i], chs[i]))
            ch = chs[i]
        self.conv_out = nn.Conv3d(ch, out_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, T, Z, X, in_features] -> [B, T, Z, X, out_features]."""
        if tuple(x.shape[1:4]) != self.igres:
            raise ValueError(f"UNet3d built for igres={self.igres}, "
                             f"got input grid {tuple(x.shape[1:4])}")
        h = self.act(self.conv_in(x.permute(0, 4, 1, 2, 3)))
        skips = []
        for i in range(self.levels):
            h = getattr(self, f"down_res{i}")(h)
            skips.append(h)
            h = self.act(getattr(self, f"down{i}")(same_pad(h, 3, 2)))
        h = self.bottleneck(h)
        for i in reversed(range(self.levels)):
            h = self.act(getattr(self, f"up{i}")(h))
            h = getattr(self, f"up_res{i}")(torch.cat([h, skips[i]], 1))
        return self.conv_out(h).permute(0, 2, 3, 4, 1)
