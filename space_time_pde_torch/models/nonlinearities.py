"""Selectable nonlinearity registry (PyTorch).

Counterpart of ``space_time_pde_tpu/models/nonlinearities.py``. Every
entry is written to match jax's definition, not torch's habit:
``jax.nn.gelu`` defaults to the tanh approximation (written out here in
jax's operation order) and ``jax.nn.elu`` has alpha 1;
``jax.nn.softplus`` is ``logaddexp(x, 0)`` (torch's ``F.softplus``
switches to the identity above 20, where the two differ by less than
one f32 ulp).

On a bf16 (or any sub-f32) tensor every entry computes as jax does on
one: op by op, each result rounded to the input's type and each python
constant rounded to it first (jax's weak-typed scalars), so leaky_relu's
slope, gelu's constants and the steps of sigmoid, silu and softplus
round where XLA's do; torch's own bf16 kernels compute those in f32 and
round once, which differs in 4-37% of the outputs by a bf16 step. relu,
elu, tanh and sin agree either way. An f32 tensor takes the f32 path
unchanged.

``ACTIVATION_CODES`` numbers the registry for the CUDA decode kernel,
which selects its activation by an int (``csrc/fused_query.cu``,
``act()``): the two tables must stay in the same order.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from space_time_pde_torch.utils.constants import device_constant

__all__ = ["NONLINEARITIES", "PIECEWISE_LINEAR", "ACTIVATION_CODES",
           "get_activation"]


def _gelu_tanh(x):
    """``jax.nn.gelu``'s tanh approximation, written as jax writes it
    (``F.gelu(approximate="tanh")`` rounds differently in the tails)."""
    c = math.sqrt(2.0 / math.pi)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


def _low(x: torch.Tensor) -> bool:
    """A type below f32, where jax rounds op by op."""
    return x.dtype in (torch.bfloat16, torch.float16)


def _const(v: float, x: torch.Tensor) -> torch.Tensor:
    """The python constant ``v`` rounded to ``x``'s type, as jax's
    weak-typed scalars are."""
    return device_constant(v, x.dtype, x.device)


def _leaky_relu(x, ns):
    if not _low(x):
        return F.leaky_relu(x, ns)
    return torch.where(x >= 0, x, _const(ns, x) * x)


def _gelu(x):
    if not _low(x):
        return _gelu_tanh(x)
    inner = x + _const(0.044715, x) * (x * x * x)
    t = torch.tanh(_const(math.sqrt(2.0 / math.pi), x) * inner)
    return x * (_const(0.5, x) * (1.0 + t))


def _sigmoid(x):
    """``lax.logistic``: on a low type 1 / (1 + exp(-x)), each step
    rounded."""
    if not _low(x):
        return torch.sigmoid(x)
    return torch.reciprocal(1.0 + torch.exp(-x))


def _silu(x):
    return x * _sigmoid(x) if _low(x) else F.silu(x)


def _softplus(x):
    """``jnp.logaddexp(x, 0)``."""
    if not _low(x):
        return torch.logaddexp(x, torch.zeros_like(x))
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


# name -> fn(x, negative_slope). Most ignore the slope; one uniform
# signature lets callers close over the config once.
NONLINEARITIES = {
    "relu": lambda x, ns: F.relu(x),
    "leaky_relu": _leaky_relu,
    "elu": lambda x, ns: F.elu(x, alpha=1.0),
    "gelu": lambda x, ns: _gelu(x),
    "silu": lambda x, ns: _silu(x),
    "swish": lambda x, ns: _silu(x),
    "softplus": lambda x, ns: _softplus(x),
    "tanh": lambda x, ns: torch.tanh(x),
    "sigmoid": lambda x, ns: _sigmoid(x),
    "sin": lambda x, ns: torch.sin(x),
}

# Second coordinate derivative is exactly zero (gates the analytic jet).
PIECEWISE_LINEAR = frozenset({"relu", "leaky_relu"})

ACTIVATION_CODES = {name: i for i, name in enumerate(NONLINEARITIES)}


def get_activation(name: str,
                   negative_slope: float = 0.01) -> Callable:
    """Resolve an activation name to a unary ``fn(x)``; ``ValueError``
    listing the available names on a bad one."""
    try:
        fn = NONLINEARITIES[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; available: "
            f"{sorted(NONLINEARITIES)}") from None
    return lambda x: fn(x, negative_slope)
