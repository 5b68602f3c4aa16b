"""Selectable nonlinearity registry (PyTorch).

Counterpart of ``space_time_pde_tpu/models/nonlinearities.py``. Every
entry is written to match jax's definition, not torch's habit:
``jax.nn.gelu`` defaults to the tanh approximation (written out here in
jax's operation order) and ``jax.nn.elu`` has alpha 1;
``jax.nn.softplus`` is ``logaddexp(x, 0)`` (torch's ``F.softplus``
switches to the identity above 20, where the two differ by less than
one f32 ulp).

``ACTIVATION_CODES`` numbers the registry for the CUDA decode kernel,
which selects its activation by an int (``csrc/fused_query.cu``,
``act()``): the two tables must stay in the same order.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["NONLINEARITIES", "PIECEWISE_LINEAR", "ACTIVATION_CODES",
           "get_activation"]


def _gelu_tanh(x):
    """``jax.nn.gelu``'s tanh approximation, written as jax writes it
    (``F.gelu(approximate="tanh")`` rounds differently in the tails)."""
    c = math.sqrt(2.0 / math.pi)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


# name -> fn(x, negative_slope). Most ignore the slope; one uniform
# signature lets callers close over the config once.
NONLINEARITIES = {
    "relu": lambda x, ns: F.relu(x),
    "leaky_relu": lambda x, ns: F.leaky_relu(x, ns),
    "elu": lambda x, ns: F.elu(x, alpha=1.0),
    "gelu": lambda x, ns: _gelu_tanh(x),
    "silu": lambda x, ns: F.silu(x),
    "swish": lambda x, ns: F.silu(x),
    "softplus": lambda x, ns: torch.logaddexp(x, torch.zeros_like(x)),
    "tanh": lambda x, ns: torch.tanh(x),
    "sigmoid": lambda x, ns: torch.sigmoid(x),
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
