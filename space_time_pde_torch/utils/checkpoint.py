"""Checkpoint / resume over ``torch.save``.

Counterpart of ``space_time_pde_tpu/utils/checkpoint.py`` (orbax there):
one file per saved step, ``<directory>/ckpt_<step>.pt``, holding the
whole training state -- both models' parameters, the optimizer state,
the step and the generator's state -- plus the caller's extras (config,
epoch, channel stats, coordinate extents, best eval), with the newest
``keep`` files kept. A restore puts every tensor back in place, so a
resumed run continues step-exact. Files load with ``weights_only=True``:
plain tensors, numbers, strings, lists and dicts only.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from space_time_pde_torch.train.trainer import TrainState

__all__ = ["CheckpointManager"]

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _plain(v):
    """numpy arrays and scalars -> lists and Python numbers."""
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def steps(self):
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             extra: Optional[Dict[str, Any]] = None) -> None:
        opt = state.opt_state
        payload = {
            "step": int(state.step),
            "params": {k: p.detach().cpu()
                       for k, p in state.params().items()},
            "opt_state": dict(opt, mu={k: v.cpu() for k, v in
                                       opt["mu"].items()},
                              nu={k: v.cpu() for k, v in
                                  opt["nu"].items()}),
            "generator": state.generator.get_state(),
            "extra": _plain(extra or {}),
        }
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.keep] if self.keep > 0 else ():
            os.remove(self._path(old))

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> Tuple[TrainState, Dict[str, Any]]:
        """Load ``step`` (default: the latest) into ``state``'s models
        and optimizer state, in place; returns (state, extras)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        payload = torch.load(self._path(step), map_location="cpu",
                             weights_only=True)
        params = state.params()
        if set(params) != set(payload["params"]):
            raise ValueError(
                "checkpoint parameters do not match the model: "
                f"{sorted(set(params) ^ set(payload['params']))}")
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(payload["params"][k])
        saved = payload["opt_state"]
        opt = state.opt_state
        for moment in ("mu", "nu"):
            for k, v in opt[moment].items():
                v.copy_(saved[moment][k])
        for k in ("count", "notfinite_count", "last_finite",
                  "total_notfinite"):
            opt[k] = saved[k]
        state.step = int(payload["step"])
        state.generator.set_state(payload["generator"])
        return state, payload["extra"]
