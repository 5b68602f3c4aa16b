"""The numbers that decide ``correct``: the program's results against the
reference's, each a gap relative to the reference.

Training: the first steps, run eagerly in set-up, and one dispatch of
the replayed graph after the window, each through the run's own step
and batches; the reference follows the first from the seed's weights
and the second from the program's state before it.

- ``loss1_gap``: the first step's ``|loss - ref| / |ref|``, and
  ``loss_gap`` the worst checked step's;
- ``grad_gap``: the first gradient as the optimizer took it, leaf by
  leaf: ``|g - g_ref|`` over the larger of ``|g_ref|`` and the median
  leaf's ``|g_ref|``, the worst leaf; ``grad_median_gap`` the median
  leaf's;
- ``change_gap`` and ``change_median_gap``: the same of the parameters'
  change over the first steps;
- ``replay_loss_gap``: the replayed dispatch's last step's loss;
  ``replay_change_gap`` and ``replay_change_median_gap``: the
  parameters' change over the replayed dispatch, as above.

A cell's limits name the numbers it compares; the rest are readings.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the leaf gaps: their gradient is nought to
rounding (a convolution's bias in front of a GroupNorm), and Adam moves
them by rounding alone.

Decode (a window's dense output): ``rel_l2``, the relative L2 distance
over the window, and ``max_gap``, the largest point gap over the largest
``|ref|``.
"""

from __future__ import annotations

from typing import Dict, List

import torch

LEAF_FLOOR = 1e-3


def _norm(v: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(v.double().cpu()))


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: List[str]) -> Dict[str, float]:
    """``|prog - ref|`` over the larger of ``|ref|`` and the median kept
    leaf's ``|ref|``, by leaf."""
    ref_n = {k: _norm(ref[k]) for k in keep}
    median = sorted(ref_n.values())[len(keep) // 2]
    return {k: _norm(prog[k].double().cpu() - ref[k].double().cpu())
            / max(ref_n[k], median) for k in keep}


def kept_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    norms = {k: _norm(v) for k, v in ref_grad.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return [k for k, v in norms.items() if v >= LEAF_FLOOR * median]


def _worst_and_median(gaps: Dict[str, float]):
    vals = sorted(gaps.values())
    return vals[-1], vals[len(vals) // 2]


def _change(after, before, keep):
    return {k: after[k].double().cpu() - before[k].double().cpu()
            for k in keep}


def train_numbers(prog: dict, ref: dict, params0) -> Dict[str, float]:
    """``prog`` / ``ref``: ``{"loss": [...], "grad": {leaf: tensor},
    "params": {leaf: tensor}, "replay": {"start": {"params": ...},
    "loss": float, "params": {leaf: tensor}}}``, the first steps from
    ``params0`` and the replayed dispatch from its ``start``."""
    keep = kept_leaves(ref["grad"])
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    grad = _worst_and_median(leaf_gaps(prog["grad"], ref["grad"], keep))
    moved = _worst_and_median(leaf_gaps(
        _change(prog["params"], params0, keep),
        _change(ref["params"], params0, keep), keep))
    out = {
        "loss1_gap": losses[0], "loss_gap": max(losses),
        "grad_gap": grad[0], "grad_median_gap": grad[1],
        "change_gap": moved[0], "change_median_gap": moved[1],
    }
    p, r = prog["replay"], ref["replay"]
    start = p["start"]["params"]
    moved = _worst_and_median(leaf_gaps(_change(p["params"], start, keep),
                                        _change(r["params"], start, keep),
                                        keep))
    out.update(replay_loss_gap=abs(p["loss"] - r["loss"]) / abs(r["loss"]),
               replay_change_gap=moved[0], replay_change_median_gap=moved[1])
    return out


def decode_numbers(prog: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    diff = prog.double().cpu() - ref.double().cpu()
    ref = ref.double().cpu()
    return {
        "rel_l2": float(torch.linalg.vector_norm(diff)
                        / torch.linalg.vector_norm(ref)),
        "max_gap": float(diff.abs().max() / ref.abs().max()),
    }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is finite and within its limit."""
    return all(numbers[k] == numbers[k] and numbers[k] <= limits[k]
               for k in limits)
