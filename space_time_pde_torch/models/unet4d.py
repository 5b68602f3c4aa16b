"""UNet4d: the 4-D (t, z, y, x) encoder of the turb3d stack (PyTorch).

Counterpart of ``space_time_pde_tpu/models/unet4d.py``. A 4-D conv is
factorized as in the flax model: a 3-D conv over (z, y, x) with time
folded into the batch (``spatial``, no bias), then a 1-D conv over t
with space folded into the batch (``temporal``, with the bias). The
public layout stays channels-last ``[B, T, Z, Y, X, C]``; inside, the
activations are channels-first ``[B, C, T, Z, Y, X]``.

What has to match the flax model exactly:

- the stride-2 "SAME" convs pad ``(0, 1)`` per axis at even sizes (XLA
  puts the odd pad at the end), for the spatial 3x3x3 and the temporal
  size-3 conv alike; :func:`~space_time_pde_torch.models.unet3d.same_pad`
  pads explicitly (``padding=1`` would pad ``(1, 1)``);
- the fold order: the spatial conv's batch is (b, t), the temporal
  conv's (b, z, y, x). The temporal conv runs as one matrix product over
  the unfolded time windows (``[B Z Y X T', F k] @ [F k, F']``), not as
  ``nn.Conv1d``'s forward: without cuDNN (the training step's setting)
  PyTorch's Conv1d loops over its batch one sample at a time, 2,048
  samples at the turb3d training igres, which took 1.16 s a training
  step on an H100. ``nn.Conv1d`` still holds the weight and bias, so
  the bridge and the init see the flax layer's counterpart;
- the up path is nearest-neighbour x2 on all four axes
  (``repeat_interleave``, as ``jnp.repeat``) then a ``Conv4d``, with no
  transposed conv;
- GroupNorm eps 1e-6 with the group count of ``_num_groups``, over
  ``[B, C, T, Z, Y, X]``.

Module names follow the flax model (``conv_in``, ``down_res{i}``,
``down{i}``, ``bottleneck``, ``up{i}``, ``up_res{i}``, ``conv_out``, each
``Conv4d`` with ``spatial`` and ``temporal``), so ``bridge.py`` maps the
trees one to one.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from space_time_pde_torch.models.nonlinearities import get_activation
from space_time_pde_torch.models.unet3d import _num_groups, same_pad

__all__ = ["UNet4d", "Conv4d", "ResBlock4D"]


def _group_norm(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(_num_groups(ch), ch, eps=1e-6)


class Conv4d(nn.Module):
    """Factorized 4-D convolution: 3-D spatial (no bias), then 1-D
    temporal (bias). ``x [B, Cin, T, Z, Y, X] -> [B, Cout, T', Z', Y',
    X']``; ``stride`` applies to all four axes. ``temporal`` holds the
    1-D conv's parameters; its product runs in :meth:`forward`."""

    def __init__(self, in_channels: int, features: int,
                 kernel_spatial: int = 3, kernel_time: int = 3,
                 stride: int = 1, use_bias: bool = True):
        super().__init__()
        self.ks, self.kt, self.stride = kernel_spatial, kernel_time, stride
        self.spatial = nn.Conv3d(in_channels, features, kernel_spatial,
                                 stride=stride, bias=False)
        self.temporal = nn.Conv1d(features, features, kernel_time,
                                  stride=stride, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t = x.shape[:3]
        # Spatial conv, time folded into the batch: [B*T, C, Z, Y, X].
        h = x.transpose(1, 2).reshape(b * t, c, *x.shape[3:])
        h = self._conv_space(h)
        f, z2, y2, x2 = h.shape[1:]
        # Temporal conv, space folded into the batch: the "SAME"-padded
        # time windows of every (b, z, y, x) as rows of one product.
        h = h.reshape(b, t, f, z2, y2, x2).permute(0, 3, 4, 5, 1, 2)
        total = max((-(-t // self.stride) - 1) * self.stride + self.kt - t,
                    0)
        h = F.pad(h, (0, 0, total // 2, total - total // 2))
        cols = h.unfold(4, self.kt, self.stride)   # [B, Z, Y, X, T', F, k]
        t2 = cols.shape[4]
        w = self.temporal.weight                    # [F', F, k]
        h = cols.reshape(-1, f * self.kt) @ w.reshape(w.shape[0], -1).t()
        if self.temporal.bias is not None:
            h = h + self.temporal.bias
        return h.reshape(b, z2, y2, x2, t2, -1).permute(0, 5, 4, 1, 2, 3)


    def _conv_space(self, h: torch.Tensor) -> torch.Tensor:
        """The spatial factor on ``[B*T, C, Z, Y, X]``, "SAME"-padded."""
        return self.spatial(same_pad(h, self.ks, self.stride))


class ResBlock4D(nn.Module):
    """Bottleneck residual block with factorized 4-D convs: 1x1 reduce,
    3x3 (space and time), 1x1 expand, GroupNorms, and a projected
    shortcut when the channel counts differ."""

    def __init__(self, in_channels: int, neck_channels: int,
                 out_channels: int, negative_slope: float = 0.01,
                 activation: str = "leaky_relu"):
        super().__init__()
        self.act = get_activation(activation, negative_slope)
        self.conv1 = Conv4d(in_channels, neck_channels, 1, 1)
        self.norm1 = _group_norm(neck_channels)
        self.conv2 = Conv4d(neck_channels, neck_channels, 3, 3)
        self.norm2 = _group_norm(neck_channels)
        self.conv3 = Conv4d(neck_channels, out_channels, 1, 1)
        self.norm3 = _group_norm(out_channels)
        self.proj = (Conv4d(in_channels, out_channels, 1, 1, use_bias=False)
                     if in_channels != out_channels else None)

    def forward(self, x):
        h = self.act(self.norm1(self.conv1(x)))
        h = self.act(self.norm2(self.conv2(h)))
        h = self.norm3(self.conv3(h))
        if self.proj is not None:
            x = self.proj(x)
        return self.act(h + x)


class UNet4d(nn.Module):
    """4-D U-Net encoder: ``[B, T, Z, Y, X, in_features]`` -> a latent
    grid ``[B, T, Z, Y, X, out_features]`` at the input resolution.
    Strided down-convs (filters doubling, capped at ``mf``), depth
    ``floor(log2(min(igres)))``, nearest-neighbour up-sampling with a
    ``Conv4d``, skip concatenation."""

    def __init__(self, in_features: int = 4, out_features: int = 32,
                 igres: Sequence[int] = (4, 8, 8, 8), nf: int = 16,
                 mf: int = 512, negative_slope: float = 0.01,
                 activation: str = "leaky_relu"):
        super().__init__()
        self.igres = tuple(igres)
        self.levels = int(math.floor(math.log2(min(self.igres))))
        for r in self.igres:
            if r % (2 ** self.levels) != 0:
                raise ValueError(f"igres {self.igres} not divisible by "
                                 f"2^{self.levels}")
        self.act = get_activation(activation, negative_slope)
        blk = lambda cin, ch: ResBlock4D(cin, max(ch // 2, 1), ch,
                                         negative_slope, activation)
        self.conv_in = Conv4d(in_features, nf, 3, 3)
        chs = []
        ch = nf
        for i in range(self.levels):
            self.add_module(f"down_res{i}", blk(ch, ch))
            chs.append(ch)
            nxt = min(ch * 2, mf)
            self.add_module(f"down{i}", Conv4d(ch, nxt, 3, 3, stride=2))
            ch = nxt
        self.bottleneck = blk(ch, ch)
        for i in reversed(range(self.levels)):
            self.add_module(f"up{i}", Conv4d(ch, chs[i], 3, 3))
            self.add_module(f"up_res{i}", blk(2 * chs[i], chs[i]))
            ch = chs[i]
        self.conv_out = Conv4d(ch, out_features, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, T, Z, Y, X, in_features] -> [B, T, Z, Y, X, out]."""
        if tuple(x.shape[1:5]) != self.igres:
            raise ValueError(f"UNet4d built for igres={self.igres}, got "
                             f"input grid {tuple(x.shape[1:5])}")
        return self._body(x)

    def _body(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(self.conv_in(x.permute(0, 5, 1, 2, 3, 4)))
        skips = []
        for i in range(self.levels):
            h = getattr(self, f"down_res{i}")(h)
            skips.append(h)
            h = self.act(getattr(self, f"down{i}")(h))
        h = self.bottleneck(h)
        for i in reversed(range(self.levels)):
            for ax in (2, 3, 4, 5):
                h = h.repeat_interleave(2, dim=ax)
            h = self.act(getattr(self, f"up{i}")(h))
            h = getattr(self, f"up_res{i}")(torch.cat([h, skips[i]], 1))
        return self.conv_out(h).permute(0, 2, 3, 4, 5, 1)
