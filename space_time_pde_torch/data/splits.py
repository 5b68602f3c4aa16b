"""Eval window protocol: val/test window starts and canonical files.

A copy of ``space_time_pde_tpu/data/splits.py``: window starts,
canonical file names and the training-side leakage check
(``check_train_files``), so the port imports nothing of the JAX
package. ``tests/test_torch_data.py`` holds the two equal.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np

__all__ = ["SplitSpec", "window_starts", "val_windows", "test_windows",
           "check_train_files", "CANONICAL_SEEDS"]

CANONICAL_SEEDS = {"train": 42, "val": 7, "test": 123}


def check_train_files(train_data: str, eval_data: str = "",
                      allow_leak: bool | None = None) -> None:
    """Abort if a held-out file is in the training list.

    The multi-simulation ``--train_data a.npz,b.npz,...`` convention
    makes it easy to sweep a seed range that accidentally contains a
    held-out canonical seed (e.g. 123 lies inside 100..199), which
    silently voids the split protocol — so leakage is a hard error
    (``SystemExit``), not a warning a long run can scroll past. Two
    checks:

    1. canonical ``_s{val}/_s{test}.npz`` suffixes (covers both the
       rb2d and turb3d file conventions);
    2. any ``eval_data``/``val_data`` basename appearing verbatim in
       the train list (catches renamed copies and non-canonical
       held-out files the suffix convention misses) — a WARNING only,
       because the reference quickstart legitimately trains and evals
       on the same simulation (SURVEY §4 "integration testing =
       running the demo").

    Intentional train-on-a-canonical-held-out-seed runs opt out with
    ``allow_leak=True`` — wired to the drivers' ``--allow_split_leak``
    flag — or ``STPDE_ALLOW_SPLIT_LEAK=1``.
    """
    import os

    if allow_leak is None:
        allow_leak = os.environ.get("STPDE_ALLOW_SPLIT_LEAK", "") == "1"

    def fail(msg):
        msg += (" — held-out numbers reported from this run are void;"
                " pass --allow_split_leak (or STPDE_ALLOW_SPLIT_LEAK=1)"
                " for an intentional train-on-everything run")
        if allow_leak:
            warnings.warn(msg)
        else:
            raise SystemExit("split protocol violation: " + msg)

    names = [s.strip() for s in train_data.split(",") if s.strip()]
    held_out = {f"_s{CANONICAL_SEEDS[k]}.npz": k for k in ("val", "test")}
    for name in names:
        for suffix, split in held_out.items():
            if name.endswith(suffix):
                fail(f"--train_data contains {name}, the canonical "
                     f"{split} simulation (seed {CANONICAL_SEEDS[split]})")
    eval_names = {os.path.basename(s.strip())
                  for s in (eval_data or "").split(",") if s.strip()}
    for name in names:
        if os.path.basename(name) in eval_names:
            warnings.warn(
                f"--train_data contains {name}, which is also an "
                "eval/val file of this run — eval numbers measure "
                "training-simulation fit, not held-out generalization "
                "(the reference-quickstart protocol)")


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
