"""Training-cliff detection for auto-recovery.

The 2nd-order PDE loss on a piecewise-linear decoder has a measured
failure mode (BASELINE.md, round-2 spike dissection): a step landing
near a LeakyReLU/multilinear kink blows the Hessian-bearing residual
up by many orders of magnitude. Two observable signatures:

1. **finite explosion** — the epoch's pde/total loss jumps to
   1e10–1e12 while the healthy running scale is O(1e-3..1). Gradients
   are finite, so ``optax.apply_if_finite`` applies them and the clip
   bound is the only defence; several such steps walk the params onto
   the cliff.
2. **frozen on the cliff** — every step's grads come back non-finite,
   ``apply_if_finite`` skips all of them, and the run spins making no
   progress (params frozen AT the cliff edge, so re-sampled batches
   keep exploding).

``CliffDetector`` consumes one host-side metrics dict per epoch and
returns a reason string when the driver should restore the last
healthy checkpoint and continue with a reduced learning rate (the
recovery the reference leaves to a human babysitting the run;
reference: SURVEY §5 failure-detection row).

A copy of ``space_time_pde_tpu/train/recovery.py`` (JAX-free itself,
but the JAX package's ``train/__init__`` imports jax).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

__all__ = ["CliffDetector"]


class CliffDetector:
    """Stateful per-epoch cliff classifier.

    Args:
      factor: finite explosion = loss > factor * running EMA (and above
        ``floor``, so noisy early epochs with a tiny EMA can't trip it).
      floor: absolute minimum loss value to call an explosion. The
        measured cliff signature is 1e10–1e12; 1e6 leaves three orders
        of headroom over any observed healthy value.
      nonfinite_streak: consecutive epochs with non-finite metrics that
        count as "frozen on the cliff". One non-finite epoch is the
        known benign transient (update skipped, run self-recovers);
        two in a row has only been observed stuck.
    """

    def __init__(self, factor: float = 1e4, floor: float = 1e6,
                 nonfinite_streak: int = 2):
        self.factor = factor
        self.floor = floor
        self.nonfinite_streak = nonfinite_streak
        self._ema: Optional[float] = None
        self._streak = 0

    def update(self, metrics: Dict[str, float]) -> Optional[str]:
        """Feed one epoch's metrics; returns a recovery reason or None."""
        watched = [metrics[k] for k in ("loss", "pde_loss")
                   if k in metrics]
        if not watched:
            return None
        if not all(math.isfinite(v) for v in metrics.values()):
            self._streak += 1
            if self._streak >= self.nonfinite_streak:
                return (f"{self._streak} consecutive epochs of "
                        "non-finite step metrics (apply_if_finite is "
                        "skipping every update)")
            return None
        self._streak = 0
        x = max(watched)
        # No running scale yet (first healthy epoch, e.g. right after a
        # resume): the absolute floor alone decides — a healthy first
        # epoch on normalized data is O(1), never 1e6.
        threshold = (self.floor if self._ema is None
                     else max(self.floor, self.factor * self._ema))
        if x > threshold:
            return (f"loss explosion: {x:.3e} vs running scale "
                    f"{self._ema if self._ema is not None else float('nan'):.3e}"
                    f" (threshold {threshold:.3e})")
        # EMA over healthy epochs only, so the explosion itself never
        # drags the baseline up.
        self._ema = x if self._ema is None else 0.9 * self._ema + 0.1 * x
        return None

    def reset(self) -> None:
        """Call after a recovery: clears the streak, keeps the healthy
        running scale (post-restore losses return to it)."""
        self._streak = 0
