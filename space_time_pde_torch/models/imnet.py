"""ImNet implicit decoder (PyTorch).

Counterpart of ``space_time_pde_tpu/models/imnet.py``: input
``[coord (dim) ⊕ latent (in_features)]``, hidden widths
``nf * (16, 8, 4, 2, 1)`` with the raw input re-concatenated into every
hidden layer after the first, and a linear head to ``out_features``.
Layers keep the flax names ``fc0..fc5`` so the weight bridge maps them
one to one.

``dtype`` is flax's compute policy (``models/policy.py``): at bf16 the
input is cast to bf16, every layer multiplies bf16 operands and rounds
before its bf16 bias add, the activations run on bf16, and the output
is cast to f32; the parameters stay f32. ``forward(x, dtype=...)``
overrides it for one call, as the JAX trainer's ``imnet.clone(dtype=)``
runs the jet's ImNet at f32 under a bf16 policy.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from space_time_pde_torch.models.nonlinearities import get_activation
from space_time_pde_torch.models.policy import linear, widen

__all__ = ["ImNet"]

MULTS = (16, 8, 4, 2, 1)


class ImNet(nn.Module):
    def __init__(self, dim: int = 3, in_features: int = 32,
                 out_features: int = 4, nf: int = 32,
                 activation: str = "leaky_relu",
                 negative_slope: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dim, self.in_features = dim, in_features
        self.out_features, self.nf = out_features, nf
        self.activation, self.negative_slope = activation, negative_slope
        self.act = get_activation(activation, negative_slope)
        din = dim + in_features
        prev = None
        for i, mult in enumerate(MULTS):
            width = nf * mult
            self.add_module(f"fc{i}", nn.Linear(
                din if prev is None else prev + din, width))
            prev = width
        self.fc5 = nn.Linear(prev, out_features)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """x: [..., dim + in_features] -> [..., out_features] f32;
        ``dtype``: the compute type of this call (default ``self.dtype``;
        at f32 the input's own type, so a float64 model stays float64)."""
        if x.shape[-1] != self.dim + self.in_features:
            raise ValueError(
                f"ImNet expects last dim {self.dim + self.in_features}, "
                f"got {x.shape[-1]}")
        dtype = dtype or self.dtype
        if dtype != torch.float32:
            x = x.to(dtype)

        def dense(name, inp):
            fc = getattr(self, name)
            return linear(inp, fc.weight, fc.bias, dtype)

        h = x
        for i in range(len(MULTS)):
            inp = h if i == 0 else torch.cat([h, x], dim=-1)
            h = self.act(dense(f"fc{i}", inp))
        return widen(dense("fc5", h))
