"""Weight bridge: flax param trees (as numpy) -> port ``state_dict``s.

The inverse of ``space_time_pde_tpu/utils/torch_import.py``. The port's
modules carry the flax module names, so each torch submodule finds its
flax subtree by its own dotted name, and its type says which layout
rule applies:

  Dense           kernel [I, O]       -> Linear weight [O, I]
  Conv            kernel [*k, I, O]   -> ConvNd weight [O, I, *k]
                  (Conv3d, and Conv1d: UNet4d's temporal conv [k, I, O]
                  -> [O, I, k])
  ConvTranspose   kernel [*k, I, O]   -> ConvTransposeNd weight
                  [I, O, *k], flipped in space (flax convolves, torch
                  cross-correlates)
  GroupNorm / BatchNorm  scale, bias  -> weight, bias
  BatchNorm batch_stats  mean, var    -> running_mean, running_var

Checkpoints cross from JAX to the port as one ``.npz`` written by
``scripts/export_torch_params.py``: leaves under ``params/...`` and
``batch_stats/...`` (``/``-joined flax paths), ``channel_mean``,
``channel_std``, ``step``, the training ``config`` as JSON and, for a
driver with settings outside the config (turb3d's crop and widths, the
epoch a run stopped at), a ``meta`` JSON object. An export that a run
resumes from also holds the optimizer state: Adam's moments under
``opt/mu/...`` and ``opt/nu/...`` (flax paths, the params' layout),
``opt/count`` and the ``apply_if_finite`` counters ``opt/notfinite_count``,
``opt/last_finite`` and ``opt/total_notfinite``. Such a file may leave the
parameters to another export: ``params_file`` then names it, relative to
its own directory. This module reads and writes that file with numpy
alone; :func:`optimizer_state_from_flax` turns the optimizer state into
``train/optim.py``'s, keyed by the port's parameter names.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

__all__ = ["flatten_tree", "unflatten_tree", "state_dict_from_flax",
           "load_flax_params", "save_exported", "load_exported",
           "optimizer_state_from_flax", "seeded_flax_params"]

OPT_COUNTERS = ("count", "notfinite_count", "last_finite", "total_notfinite")


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mapping -> {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_tree(flat: Mapping[str, Any]) -> Dict:
    """{"a/b/c": array} -> nested dicts."""
    tree: Dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _subtree(tree: Optional[Mapping], path: str):
    node = tree
    for part in path.split(".") if path else ():
        if node is None or part not in node:
            return None
        node = node[part]
    return node


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def state_dict_from_flax(module: nn.Module, params: Mapping,
                         batch_stats: Optional[Mapping] = None,
                         buffers: bool = True) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``module`` filled from a flax param tree
    (without BatchNorm's buffers when ``buffers`` is false: a tree in
    the params' layout, such as a gradient or an Adam moment).

    Raises ``KeyError`` when a torch layer has no flax counterpart and
    ``ValueError`` when flax leaves are left over, so a naming drift
    between the two packages cannot load silently.
    """
    sd: Dict[str, torch.Tensor] = {}
    used = set()
    for name, mod in module.named_modules():
        if not isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv3d,
                                nn.ConvTranspose3d, nn.GroupNorm,
                                nn.BatchNorm3d)):
            continue
        p = _subtree(params, name)
        if p is None:
            raise KeyError(f"flax params have no {name.replace('.', '/')}")
        used.update(f"{name}.{leaf}".lstrip(".") for leaf in p)
        if isinstance(mod, nn.Linear):
            w = np.asarray(p["kernel"]).T
        elif isinstance(mod, nn.ConvTranspose3d):
            k = np.asarray(p["kernel"])
            w = np.flip(k, axis=tuple(range(k.ndim - 2)))
            w = np.moveaxis(w, (-2, -1), (0, 1))
        elif isinstance(mod, (nn.Conv1d, nn.Conv3d)):
            w = np.moveaxis(np.asarray(p["kernel"]), (-1, -2), (0, 1))
        else:
            w = p["scale"]
        pre = f"{name}." if name else ""
        sd[pre + "weight"] = _t(w)
        if "bias" in p:
            sd[pre + "bias"] = _t(p["bias"])
        if isinstance(mod, nn.BatchNorm3d) and buffers:
            s = _subtree(batch_stats, name)
            if s is None:
                raise KeyError(f"batch_stats have no "
                               f"{name.replace('.', '/')}")
            sd[pre + "running_mean"] = _t(s["mean"])
            sd[pre + "running_var"] = _t(s["var"])
            sd[pre + "num_batches_tracked"] = torch.zeros((),
                                                          dtype=torch.long)
    extra = {k.replace("/", ".") for k in flatten_tree(params)} - used
    if extra:
        raise ValueError(f"flax leaves with no torch layer: {sorted(extra)}")
    return sd


def load_flax_params(module: nn.Module, params: Mapping,
                     batch_stats: Optional[Mapping] = None) -> nn.Module:
    """Copy a flax param tree into ``module`` (strict) and return it."""
    module.load_state_dict(state_dict_from_flax(module, params,
                                                batch_stats), strict=True)
    return module


def save_exported(path: str, params: Optional[Mapping],
                  batch_stats: Optional[Mapping], config: Mapping,
                  channel_mean, channel_std, step: int,
                  meta: Optional[Mapping] = None,
                  opt_state: Optional[Mapping] = None,
                  params_file: Optional[str] = None) -> None:
    """Write the exported-checkpoint ``.npz`` (see module docstring).
    ``opt_state``: ``{"mu": tree, "nu": tree, "count", "notfinite_count",
    "last_finite", "total_notfinite"}``; with ``params_file`` in place of
    ``params`` the file holds no parameters and names the export that
    does."""
    if (params is None) == (params_file is None):
        raise ValueError("give the params or the params_file, not both")
    arrays = ({f"params/{k}": v for k, v in flatten_tree(params).items()}
              if params is not None
              else {"params_file": np.asarray(params_file)})
    if batch_stats and params is not None:
        arrays.update({f"batch_stats/{k}": v
                       for k, v in flatten_tree(batch_stats).items()})
    if opt_state is not None:
        for moment in ("mu", "nu"):
            arrays.update({f"opt/{moment}/{k}": np.asarray(v, np.float32)
                           for k, v in flatten_tree(
                               opt_state[moment]).items()})
        arrays.update({f"opt/{k}": np.asarray(opt_state[k])
                       for k in OPT_COUNTERS})
    np.savez_compressed(
        path, **arrays,
        channel_mean=np.asarray(channel_mean, np.float32),
        channel_std=np.asarray(channel_std, np.float32),
        step=np.asarray(step, np.int64),
        config=np.asarray(json.dumps(config, sort_keys=True)),
        meta=np.asarray(json.dumps(dict(meta or {}), sort_keys=True)))


def load_exported(path: str) -> Dict[str, Any]:
    """Read an exported ``.npz`` -> {"params", "batch_stats" (or None),
    "config" (dict), "channel_mean", "channel_std", "step", "meta"
    (dict; empty in files written before it existed), "opt_state" (as
    :func:`save_exported` takes it, or None)}. The parameters of a file
    that names a ``params_file`` come from that file, whose step must
    be the same."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    trees = {"params": {}, "batch_stats": {}, "opt": {}}
    for k, v in flat.items():
        head, _, rest = k.partition("/")
        if head in trees and rest:
            trees[head][rest] = v
    out = {
        "params": unflatten_tree(trees["params"]),
        "batch_stats": unflatten_tree(trees["batch_stats"]) or None,
        "config": json.loads(str(flat["config"])),
        "channel_mean": flat["channel_mean"],
        "channel_std": flat["channel_std"],
        "step": int(flat["step"]),
        "meta": json.loads(str(flat["meta"])) if "meta" in flat else {},
        "opt_state": None,
    }
    if trees["opt"]:
        opt = unflatten_tree(trees["opt"])
        out["opt_state"] = dict(
            mu=opt["mu"], nu=opt["nu"],
            **{k: opt[k].item() for k in OPT_COUNTERS})
    if "params_file" in flat:
        src = os.path.join(os.path.dirname(os.path.abspath(path)),
                           str(flat["params_file"]))
        held = load_exported(src)
        if held["step"] != out["step"]:
            raise ValueError(f"{path} is step {out['step']} but its "
                             f"params_file {src} is step {held['step']}")
        out["params"], out["batch_stats"] = (held["params"],
                                             held["batch_stats"])
    return out


def optimizer_state_from_flax(opt: Mapping, modules: Mapping[str, nn.Module],
                              device=None) -> Dict[str, Any]:
    """``train/optim.py``'s state from an exported optimizer state (see
    :func:`load_exported`): Adam's moments keyed by the port's parameter
    names (``"unet.<name>"``, ``"imnet.<name>"`` for ``modules = {"unet":
    ..., "imnet": ...}``) with the params' transposes and flips, the
    counters as Python numbers."""
    out = {k: (bool if k == "last_finite" else int)(opt[k])
           for k in OPT_COUNTERS}
    for moment in ("mu", "nu"):
        out[moment] = {}
        for name, module in modules.items():
            sd = state_dict_from_flax(module, opt[moment][name],
                                      buffers=False)
            for k, _ in module.named_parameters():
                out[moment][f"{name}.{k}"] = sd[k].to(device)
    return out


def seeded_flax_params(shapes: Mapping[str, Sequence[int]],
                       seed: int) -> Dict:
    """A flax-layout param tree (``{"a/b/kernel": shape}`` -> nested
    numpy f32) drawn from a numpy seed in sorted path order, so that
    both packages build the same weights without shipping them. Kernels
    are unit normals clipped to [-2, 2] and scaled to variance ~1 /
    fan_in (flax's lecun-normal shape; fan_in = all but the last axis),
    GroupNorm scales 1 + 0.01 N, biases 0.01 N (non-zero, so that the
    bias paths carry gradients)."""
    rng = np.random.RandomState(seed)
    flat = {}
    for path in sorted(shapes):
        shape = tuple(int(s) for s in shapes[path])
        x = rng.standard_normal(shape)
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            x = np.clip(x, -2.0, 2.0) * (math.sqrt(1.0 / fan_in)
                                         / 0.87962566103423978)
        elif leaf == "scale":
            x = 1.0 + 0.01 * x
        else:
            x = 0.01 * x
        flat[path] = x.astype(np.float32)
    return unflatten_tree(flat)
