"""The training optimizer, written out as optax composes it.

Counterpart of ``make_optimizer`` in ``space_time_pde_tpu/train/
trainer.py``: ``apply_if_finite(chain(clip_by_global_norm(clip),
adam(schedule)), max_consecutive_errors=100)``, with optax 0.2.6's
semantics step for step (not ``torch.optim``, whose clip adds 1e-6 to
the norm and whose Adam differs in where eps and the bias correction
sit):

- ``clip_by_global_norm``: the global norm g of all gradients; leave
  them if ``g < clip``, else scale by ``clip / g``;
- Adam, b1 0.9, b2 0.999, eps 1e-8, eps_root 0: ``mu = (1 - b1) g +
  b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, ``count += 1``, update
  ``-lr * mu_hat / (sqrt(nu_hat) + eps)`` with ``mu_hat = mu / (1 -
  b1^count)``;
- the learning rate is ``lr`` (constant) or
  ``cosine_decay_schedule(lr, decay_steps)`` read at the count BEFORE
  the step (the first step uses the full rate);
- ``apply_if_finite``: a step whose gradients hold a NaN or Inf changes
  neither the parameters nor the inner state (moments, count) and
  counts a consecutive error; once more than MAX_CONSECUTIVE_ERRORS
  bad steps in a row have been seen, the update is applied anyway
  (optax's "give up"), and any finite step resets the streak.

The state is a dict of tensors on the parameters' device, as optax holds
it: the moments, and the counters ``count``, ``notfinite_count`` and
``total_notfinite`` (0-d int32) and ``last_finite`` (0-d bool). A step
decides on the device, in optax's op order: the clip is ``where(norm <
clip, g, (g / norm) * clip)`` (``clip_by_global_norm``), the update is
computed whatever the gradients hold, and ``where(apply, new, old)``
keeps the parameters, the moments and the count on a skipped step
(``apply_if_finite``'s ``lax.cond``); the learning rate and the bias
corrections come from the device count. So a step makes no host sync
and reads no number that changes from step to step on the host, and a
CUDA graph of it stays right under replay (``train/trainer.py``).
Parameters and state are updated in place; a checkpoint reads the
counters as Python numbers (:func:`counter_values`) and restores them in
place (:func:`set_counters`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["COUNTERS", "Optimizer", "counter_values", "global_norm",
           "make_optimizer", "set_counters"]

B1, B2, EPS = 0.9, 0.999, 1e-8
MAX_CONSECUTIVE_ERRORS = 100
COUNTERS = ("count", "notfinite_count", "last_finite", "total_notfinite")
# The decays as f32 values (optax's weak-typed f32 constants), read as
# Python floats for the float64 power below.
_B1_F32, _B2_F32 = float(np.float32(B1)), float(np.float32(B2))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def _decay_power(decay_f32: float, count: torch.Tensor) -> torch.Tensor:
    """``decay ** count`` in f32 for the 0-d int ``count``: the power of
    the f32 decay in float64, rounded to f32 once. That is XLA's f32
    ``pow`` on the CPU at every count up to 399 (where the optax
    reference's bias corrections run in the tests); torch's f32 ``pow``
    of a tensor exponent misses it at some counts."""
    return torch.pow(decay_f32, count.to(torch.float64)).to(torch.float32)


def counter_values(state: Dict) -> Dict[str, object]:
    """The counters that ``state`` holds, as Python numbers (one host
    read each; for checkpoints and exports, never inside a step)."""
    return {k: (bool if k == "last_finite" else int)(state[k])
            for k in COUNTERS if k in state}


@torch.no_grad()
def set_counters(state: Dict, values) -> None:
    """Write ``values`` (Python numbers or 0-d tensors, by counter name)
    into ``state``'s counter tensors in place, so that a CUDA graph that
    reads them sees the new values."""
    for k in COUNTERS:
        state[k].fill_(values[k])


@dataclass
class Optimizer:
    lr: float
    decay_steps: Optional[int] = None   # cosine schedule when set
    clip: float = 0.0                   # global-norm clip; 0 = off

    def __post_init__(self):
        if self.decay_steps is not None and not self.decay_steps > 0:
            raise ValueError(f"cosine schedule needs positive decay_steps, "
                             f"got {self.decay_steps}")

    def learning_rate(self, count) -> torch.Tensor:
        """The schedule at ``count`` (f32, as optax computes it): an int,
        or the state's 0-d count tensor, whose device the result takes
        (no host copy)."""
        if not isinstance(count, torch.Tensor):
            count = torch.tensor(count, dtype=torch.int32)
        init = torch.full((), self.lr, dtype=torch.float32,
                          device=count.device)
        if self.decay_steps is None:
            return init
        c = torch.clamp(count, max=self.decay_steps).to(torch.float32)
        cosine = 0.5 * (1 + torch.cos(math.pi * c / float(self.decay_steps)))
        return init * cosine

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        device = next(iter(params.values())).device
        zero = lambda: torch.zeros((), dtype=torch.int32, device=device)
        return {
            "count": zero(),
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
            "notfinite_count": zero(),
            "last_finite": torch.ones((), dtype=torch.bool, device=device),
            "total_notfinite": zero(),
        }

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: Dict) -> torch.Tensor:
        """Update ``params`` and ``state`` in place from ``grads``;
        returns the gradients' global norm (a 0-d tensor). Every decision
        is a device-side select: no host sync."""
        norm = global_norm(grads.values())
        finite = torch.stack([torch.isfinite(g).all()
                              for g in grads.values()]).all()
        bad = state["notfinite_count"]
        bad.copy_(torch.where(finite, torch.zeros_like(bad), bad + 1))
        state["total_notfinite"].add_((~finite).to(torch.int32))
        state["last_finite"].copy_(finite)
        apply = finite | (bad > MAX_CONSECUTIVE_ERRORS)
        count = state["count"]
        lr = self.learning_rate(count)
        new_count = count + 1
        bc1 = 1 - _decay_power(_B1_F32, new_count)
        bc2 = 1 - _decay_power(_B2_F32, new_count)
        trigger = norm < self.clip if self.clip > 0 else None
        for k, p in params.items():
            g = grads[k]
            if trigger is not None:
                g = torch.where(trigger, g, (g / norm) * self.clip)
            mu, nu = state["mu"][k], state["nu"][k]
            mu_new = (1 - B1) * g + B1 * mu
            nu_new = (1 - B2) * (g * g) + B2 * nu
            upd = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + EPS)
            p.copy_(torch.where(apply, p + upd * -lr, p))
            mu.copy_(torch.where(apply, mu_new, mu))
            nu.copy_(torch.where(apply, nu_new, nu))
        count.copy_(torch.where(apply, new_count, count))
        return norm


def make_optimizer(cfg, steps_per_epoch: int = 1000,
                   lr_scale: float = 1.0) -> Optimizer:
    """The config's optimizer: ``lr_scale`` rescales the schedule (cliff
    recovery) without changing the state's layout."""
    decay = (cfg.train.epochs * steps_per_epoch
             if cfg.train.lr_schedule == "cosine" else None)
    return Optimizer(lr=cfg.train.lr * lr_scale, decay_steps=decay,
                     clip=cfg.train.clip_grad or 0.0)
