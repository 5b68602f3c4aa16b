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

The state is plain tensors in a dict, so a checkpoint restores it
exactly. Parameters are updated in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch

__all__ = ["Optimizer", "global_norm", "make_optimizer"]

B1, B2, EPS = 0.9, 0.999, 1e-8
MAX_CONSECUTIVE_ERRORS = 100


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


@dataclass
class Optimizer:
    lr: float
    decay_steps: Optional[int] = None   # cosine schedule when set
    clip: float = 0.0                   # global-norm clip; 0 = off

    def __post_init__(self):
        if self.decay_steps is not None and not self.decay_steps > 0:
            raise ValueError(f"cosine schedule needs positive decay_steps, "
                             f"got {self.decay_steps}")

    def learning_rate(self, count: int) -> torch.Tensor:
        """The schedule at ``count`` (f32, as optax computes it)."""
        init = torch.tensor(self.lr, dtype=torch.float32)
        if self.decay_steps is None:
            return init
        c = torch.tensor(float(min(count, self.decay_steps)),
                         dtype=torch.float32)
        cosine = 0.5 * (1 + torch.cos(math.pi * c / float(self.decay_steps)))
        return init * cosine

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
            "notfinite_count": 0,
            "last_finite": True,
            "total_notfinite": 0,
        }

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: Dict) -> torch.Tensor:
        """Update ``params`` and ``state`` in place from ``grads``;
        returns the gradients' global norm (a 0-d tensor). One host sync
        per step: the finiteness test decides whether to apply."""
        norm = global_norm(grads.values())
        finite = bool(torch.stack([torch.isfinite(g).all()
                                   for g in grads.values()]).all())
        state["notfinite_count"] = (0 if finite
                                    else state["notfinite_count"] + 1)
        state["last_finite"] = finite
        if not finite:
            state["total_notfinite"] += 1
        if not finite and \
                state["notfinite_count"] <= MAX_CONSECUTIVE_ERRORS:
            return norm
        clipping = self.clip > 0 and not bool(norm < self.clip)
        lr = self.learning_rate(state["count"]).to(norm.device)
        count = state["count"] + 1
        bc1 = 1 - torch.tensor(B1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(B2, dtype=torch.float32) ** count
        bc1, bc2 = bc1.to(norm.device), bc2.to(norm.device)
        for k, p in params.items():
            g = grads[k]
            if clipping:
                g = (g / norm) * self.clip
            mu, nu = state["mu"][k], state["nu"][k]
            mu.copy_((1 - B1) * g + B1 * mu)
            nu.copy_((1 - B2) * (g * g) + B2 * nu)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            p.add_(upd * -lr)
        state["count"] = count
        return norm


def make_optimizer(cfg, steps_per_epoch: int = 1000,
                   lr_scale: float = 1.0) -> Optimizer:
    """The config's optimizer: ``lr_scale`` rescales the schedule (cliff
    recovery) without changing the state's layout."""
    decay = (cfg.train.epochs * steps_per_epoch
             if cfg.train.lr_schedule == "cosine" else None)
    return Optimizer(lr=cfg.train.lr * lr_scale, decay_steps=decay,
                     clip=cfg.train.clip_grad or 0.0)
