"""Independent 32-bit seeds for each stream of a run, from ``--seed`` (any
whole number: ``np.random.SeedSequence`` takes it whole)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

STREAMS = ("weights", "fields", "batches", "windows", "sample")


@dataclass
class Seeds:
    weights: int
    fields: int
    batches: int
    windows: int
    sample: int

    @classmethod
    def of(cls, seed: int) -> "Seeds":
        words = np.random.SeedSequence(abs(int(seed))).generate_state(
            len(STREAMS))
        return cls(*(int(w) for w in words))
