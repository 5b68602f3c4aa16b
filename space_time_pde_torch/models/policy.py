"""The compute policy: flax's ``dtype`` on a layer, in PyTorch.

A flax ``nn.Conv`` / ``nn.ConvTranspose`` / ``nn.Dense`` built with
``dtype=jnp.bfloat16`` keeps its parameters in f32, casts its input,
kernel and bias to bf16, rounds the product to bf16 and then adds the
bias in bf16 (two roundings: XLA rounds the product before the add);
the casts are differentiable, so the f32 parameters get f32 gradients.
The layers here do the same at ``dtype=torch.bfloat16`` and are their
``nn`` parents unchanged at f32 (so f32 arithmetic is the plain
layer's, bit for bit). The rounding points are written out, layer by
layer, rather than left to ``torch.autocast``, whose op lists (not the
module) decide where values round and differ by device and version.

Flax's norms take no ``dtype`` in these models, so a bf16 input meets
the f32 scale and the norm computes and returns f32: the models call
their norms on ``widen(h)``. At f32 nothing is cast, so a model moved to
float64 (the references' recomputations) stays float64.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["Conv3d", "ConvTranspose3d", "policy_dtype", "product",
           "linear", "widen"]

_LOW = (torch.bfloat16, torch.float16)


def policy_dtype(use_bf16: bool) -> torch.dtype:
    return torch.bfloat16 if use_bf16 else torch.float32


def widen(t: torch.Tensor) -> torch.Tensor:
    """``t`` as f32 where its type is below f32, else as it is."""
    return t.float() if t.dtype in _LOW else t


def product(fn, x, weight, bias, dtype):
    """``fn(x, weight, bias)`` in ``dtype``: at f32 as is, below it on
    cast operands with the bias added after the product rounds."""
    if dtype == torch.float32:
        return fn(x, weight, bias)
    y = fn(x.to(dtype), weight.to(dtype), None)
    if bias is None:
        return y
    return y + bias.to(dtype).reshape((-1,) + (1,) * (y.ndim - 2))


def linear(x, weight, bias, dtype):
    """``nn.Dense(dtype=...)`` on ``[..., in]`` with a torch-layout
    weight ``[out, in]``."""
    if dtype == torch.float32:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` computing in ``dtype`` (flax ``nn.Conv(dtype=...)``)."""

    def __init__(self, *args, dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return product(self._conv_forward, x, self.weight, self.bias,
                       self.dtype)


class ConvTranspose3d(nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` computing in ``dtype`` (flax
    ``nn.ConvTranspose(dtype=...)``)."""

    def __init__(self, *args, dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        return product(
            lambda x, w, b: F.conv_transpose3d(
                x, w, b, self.stride, self.padding, self.output_padding,
                self.groups, self.dilation),
            x, self.weight, self.bias, self.dtype)
