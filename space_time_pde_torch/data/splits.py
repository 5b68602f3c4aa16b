"""Eval window protocol: val/test window starts and canonical files.

The part of ``space_time_pde_tpu/data/splits.py`` the eval CLI reads
(window starts and canonical file names), copied so the port imports
nothing of the JAX package; the training-side leakage check comes with
slice 2. ``tests/test_torch_data.py`` holds the two equal.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np

__all__ = ["SplitSpec", "window_starts", "val_windows", "test_windows",
           "CANONICAL_SEEDS"]

CANONICAL_SEEDS = {"train": 42, "val": 7, "test": 123}


def window_starts(n_frames: int, nt: int, n_windows: int,
                  parity: int = 0) -> np.ndarray:
    """Even (parity 0, val) or odd (parity 1, test) points of a
    ``2 * n_windows + 1``-point grid over ``[0, n_frames - nt]``; test
    starts that round onto a val start are dropped."""
    if n_frames < nt:
        raise ValueError(f"n_frames {n_frames} < window nt {nt}")
    grid = np.linspace(0, n_frames - nt, 2 * n_windows + 1)
    val = np.unique(grid[0::2][:n_windows].astype(int))
    if not parity:
        return val
    test = np.setdiff1d(np.unique(grid[1::2].astype(int)), val)
    if len(test) == 0:
        raise ValueError(
            f"dataset too short for disjoint val/test windows: "
            f"n_frames={n_frames}, nt={nt}, n_windows={n_windows}")
    if len(test) < n_windows:
        warnings.warn(
            f"only {len(test)}/{n_windows} test windows are disjoint "
            f"from val windows (n_frames={n_frames}, nt={nt})")
    return test


def val_windows(n_frames: int, nt: int, n_windows: int = 4) -> np.ndarray:
    return window_starts(n_frames, nt, n_windows, parity=0)


def test_windows(n_frames: int, nt: int, n_windows: int = 4) -> np.ndarray:
    return window_starts(n_frames, nt, n_windows, parity=1)


@dataclass
class SplitSpec:
    train_data: str
    val_data: str
    test_data: str

    @classmethod
    def canonical(cls, prefix: str = "rb2d_ra1e6") -> "SplitSpec":
        return cls(
            train_data=f"{prefix}_s{CANONICAL_SEEDS['train']}.npz",
            val_data=f"{prefix}_s{CANONICAL_SEEDS['val']}.npz",
            test_data=f"{prefix}_s{CANONICAL_SEEDS['test']}.npz",
        )
