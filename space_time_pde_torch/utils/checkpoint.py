"""Checkpoint / resume over ``torch.save``.

Counterpart of ``space_time_pde_tpu/utils/checkpoint.py`` (orbax there):
one file per saved step, ``<directory>/ckpt_<step>.pt``, holding the
whole training state -- both models' parameters and buffers (BatchNorm's
running statistics), the optimizer state, the step and the generator's
state -- plus the caller's extras (config,
epoch, channel stats, coordinate extents, best eval), with the newest
``keep`` files kept. A restore puts every tensor back in place, so a
resumed run continues step-exact. Files load with ``weights_only=True``:
plain tensors, numbers, strings, lists and dicts only.

The eval CLIs read a run's directory with :func:`latest_checkpoint` and
:func:`load_models` instead: the newest step's models alone, no
optimizer, and nothing is created on the way (the JAX eval CLIs also
read the newest step only).

:func:`restore_exported` resumes from a JAX run instead: an ``.npz`` of
``scripts/export_torch_params.py`` with the optimizer state
(``bridge.py``). Parameters, BatchNorm statistics, Adam's moments and
count and the ``apply_if_finite`` counters carry over exactly; the JAX
PRNG key does not (the port draws its batches with its own generators).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from space_time_pde_torch.bridge import (
    load_exported, load_flax_params, optimizer_state_from_flax)
from space_time_pde_torch.train.optim import counter_values, set_counters
from space_time_pde_torch.train.trainer import (
    TrainState, model_buffers, model_params)

__all__ = ["CheckpointManager", "EvalWeights", "eval_weights",
           "latest_checkpoint", "load_models", "restore_exported", "resume"]

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _steps(directory: str):
    found = (_NAME.match(n) for n in os.listdir(directory))
    return sorted(int(m.group(1)) for m in found if m)


def _check_names(what: str, want, got) -> None:
    if set(want) != set(got):
        raise ValueError(f"checkpoint {what} do not match the model: "
                         f"{sorted(set(want) ^ set(got))}")


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
        return _steps(self.directory)

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
            "buffers": {k: b.cpu() for k, b in state.buffers().items()},
            "opt_state": dict(opt, **counter_values(opt),
                              mu={k: v.cpu() for k, v in opt["mu"].items()},
                              nu={k: v.cpu() for k, v in opt["nu"].items()}),
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
        _check_names("parameters", params, payload["params"])
        buffers = state.buffers()
        saved_buffers = payload.get("buffers", {})
        if saved_buffers:
            _check_names("buffers", buffers, saved_buffers)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(payload["params"][k])
            for k, b in saved_buffers.items():
                buffers[k].copy_(b)
        saved = payload["opt_state"]
        opt = state.opt_state
        for moment in ("mu", "nu"):
            for k, v in opt[moment].items():
                v.copy_(saved[moment][k])
        set_counters(opt, saved)
        state.step = int(payload["step"])
        state.generator.set_state(payload["generator"])
        return state, payload["extra"]


def latest_checkpoint(directory: str) -> Dict[str, Any]:
    """The newest ``ckpt_<step>.pt`` of ``directory`` as saved (tensors
    on the CPU). Reads only: a missing directory, or one that holds no
    checkpoint, raises ``FileNotFoundError`` naming it and is left as it
    was."""
    path = os.path.abspath(directory)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory {path}")
    steps = _steps(path)
    if not steps:
        raise FileNotFoundError(f"no checkpoint found in {path}")
    return torch.load(os.path.join(path, f"ckpt_{steps[-1]}.pt"),
                      map_location="cpu", weights_only=True)


def load_models(payload: Dict[str, Any], unet: torch.nn.Module,
                imnet: torch.nn.Module) -> Tuple[int, Dict[str, Any]]:
    """Copy the parameters and buffers (BatchNorm's running statistics
    and counters) of a checkpoint that :func:`latest_checkpoint` read
    into ``unet`` and ``imnet``, wherever they live. Names and shapes
    must match the models' exactly (``ValueError`` naming the keys
    otherwise). Returns (step, extras)."""
    params, buffers = model_params(unet, imnet), model_buffers(unet, imnet)
    saved = {**payload["params"], **payload.get("buffers", {})}
    _check_names("parameters", params, payload["params"])
    _check_names("buffers", buffers, payload.get("buffers", {}))
    bad = sorted(k for k, t in {**params, **buffers}.items()
                 if tuple(t.shape) != tuple(saved[k].shape))
    if bad:
        raise ValueError(f"checkpoint shapes do not match the model: {bad}")
    with torch.no_grad():
        for k, t in {**params, **buffers}.items():
            t.copy_(saved[k])
    return int(payload["step"]), payload["extra"]


@dataclass
class EvalWeights:
    """An eval CLI's model: its ``step``, its ``source`` (``ckpt=<abs
    dir>`` or ``params=<path>``), the run's ``extra`` (``config``, the
    channel statistics where saved, ``turb3d_args`` of a turb3d run) and
    ``load(unet, imnet)``, which copies the weights in."""
    step: int
    source: str
    extra: Dict[str, Any]
    load: Callable[[torch.nn.Module, torch.nn.Module], Any]


def eval_weights(ckpt: Optional[str] = None,
                 params: Optional[str] = None) -> EvalWeights:
    """The eval CLIs' ``--ckpt`` (a port run's checkpoint directory, its
    newest step) or ``--params`` (a JAX run's ``.npz`` of
    ``scripts/export_torch_params.py`` / ``export_torch_turb3d.py``)."""
    if ckpt is not None:
        payload = latest_checkpoint(ckpt)
        return EvalWeights(
            int(payload["step"]), f"ckpt={os.path.abspath(ckpt)}",
            payload["extra"], lambda u, i: load_models(payload, u, i))
    exported = load_exported(params)

    def load(unet, imnet):
        load_flax_params(unet, exported["params"]["unet"],
                         exported["batch_stats"])
        load_flax_params(imnet, exported["params"]["imnet"])

    extra = {k: exported[k] for k in ("config", "channel_mean",
                                      "channel_std")}
    if "turb3d_args" in exported["meta"]:
        extra["turb3d_args"] = exported["meta"]["turb3d_args"]
    return EvalWeights(exported["step"], f"params={params}", extra, load)


def restore_exported(state: TrainState, path: str
                     ) -> Tuple[TrainState, Dict[str, Any]]:
    """Load the exported JAX checkpoint ``path`` into ``state`` in place:
    both models' parameters (and BatchNorm statistics), the optimizer
    state and the step; returns (state, extras: ``epoch`` -- the JAX
    run's last finished epoch, or -1 where the export does not say --
    ``config``, ``channel_mean``, ``channel_std``). The generator keeps
    its seed: the JAX run's batches are not reproduced."""
    exported = load_exported(path)
    if exported["opt_state"] is None:
        raise ValueError(
            f"{path} holds no optimizer state, so a run cannot resume from "
            "it exactly; re-export it with scripts/export_torch_params.py "
            "--with_opt_state")
    device = next(state.unet.parameters()).device
    params = exported["params"]
    load_flax_params(state.unet, params["unet"], exported["batch_stats"])
    load_flax_params(state.imnet, params["imnet"])
    opt = optimizer_state_from_flax(
        exported["opt_state"], {"unet": state.unet, "imnet": state.imnet},
        device)
    for moment in ("mu", "nu"):
        for k, v in state.opt_state[moment].items():
            v.copy_(opt[moment][k])
    set_counters(state.opt_state, opt)
    state.step = exported["step"]
    return state, {"epoch": int(exported["meta"].get("epoch", -1)),
                   "config": exported["config"],
                   "channel_mean": exported["channel_mean"],
                   "channel_std": exported["channel_std"]}


def resume(state: TrainState, path: str, mngr: CheckpointManager,
           steps_per_epoch: int) -> Tuple[TrainState, int, str]:
    """The train CLIs' ``--resume``: ``path`` is an exported JAX
    checkpoint (``.npz``, :func:`restore_exported`) or a directory of
    port checkpoints (``mngr`` when it is the run's own). Returns (state,
    the epoch to continue at, the line to print)."""
    if path.endswith(".npz"):
        state, extra = restore_exported(state, path)
        epoch = (extra["epoch"] + 1 if extra["epoch"] >= 0
                 else state.step // steps_per_epoch)
        return state, epoch, (
            f"resumed from step {state.step} (epoch {epoch}) of the "
            f"exported JAX run {path}: parameters, BatchNorm statistics "
            f"and optimizer state exact (Adam count "
            f"{int(state.opt_state['count'])}); the batches are not (the JAX "
            "PRNG key does not carry over; the port draws its own)")
    rmngr = (mngr if os.path.abspath(path) == mngr.directory
             else CheckpointManager(path))
    state, extra = rmngr.restore(state)
    epoch = int(extra.get("epoch", 0)) + 1
    return state, epoch, f"resumed from step {state.step} (epoch {epoch})"
