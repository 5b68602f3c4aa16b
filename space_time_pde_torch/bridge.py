"""Weight bridge: flax param trees (as numpy) -> port ``state_dict``s.

The inverse of ``space_time_pde_tpu/utils/torch_import.py``. The port's
modules carry the flax module names, so each torch submodule finds its
flax subtree by its own dotted name, and its type says which layout
rule applies:

  Dense           kernel [I, O]       -> Linear weight [O, I]
  Conv            kernel [*k, I, O]   -> ConvNd weight [O, I, *k]
  ConvTranspose   kernel [*k, I, O]   -> ConvTransposeNd weight
                  [I, O, *k], flipped in space (flax convolves, torch
                  cross-correlates)
  GroupNorm / BatchNorm  scale, bias  -> weight, bias
  BatchNorm batch_stats  mean, var    -> running_mean, running_var

Checkpoints cross from JAX to the port as one ``.npz`` written by
``scripts/export_torch_params.py``: leaves under ``params/...`` and
``batch_stats/...`` (``/``-joined flax paths), ``channel_mean``,
``channel_std``, ``step`` and the training ``config`` as JSON. This
module reads and writes that file with numpy alone.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

__all__ = ["flatten_tree", "unflatten_tree", "state_dict_from_flax",
           "load_flax_params", "save_exported", "load_exported"]


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
                         batch_stats: Optional[Mapping] = None
                         ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``module`` filled from a flax param tree.

    Raises ``KeyError`` when a torch layer has no flax counterpart and
    ``ValueError`` when flax leaves are left over, so a naming drift
    between the two packages cannot load silently.
    """
    sd: Dict[str, torch.Tensor] = {}
    used = set()
    for name, mod in module.named_modules():
        if not isinstance(mod, (nn.Linear, nn.Conv3d, nn.ConvTranspose3d,
                                nn.GroupNorm, nn.BatchNorm3d)):
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
        elif isinstance(mod, nn.Conv3d):
            w = np.moveaxis(np.asarray(p["kernel"]), (-1, -2), (0, 1))
        else:
            w = p["scale"]
        pre = f"{name}." if name else ""
        sd[pre + "weight"] = _t(w)
        if "bias" in p:
            sd[pre + "bias"] = _t(p["bias"])
        if isinstance(mod, nn.BatchNorm3d):
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


def save_exported(path: str, params: Mapping,
                  batch_stats: Optional[Mapping], config: Mapping,
                  channel_mean, channel_std, step: int) -> None:
    """Write the exported-checkpoint ``.npz`` (see module docstring)."""
    arrays = {f"params/{k}": v for k, v in flatten_tree(params).items()}
    if batch_stats:
        arrays.update({f"batch_stats/{k}": v
                       for k, v in flatten_tree(batch_stats).items()})
    np.savez_compressed(
        path, **arrays,
        channel_mean=np.asarray(channel_mean, np.float32),
        channel_std=np.asarray(channel_std, np.float32),
        step=np.asarray(step, np.int64),
        config=np.asarray(json.dumps(config, sort_keys=True)))


def load_exported(path: str) -> Dict[str, Any]:
    """Read an exported ``.npz`` -> {"params", "batch_stats" (or None),
    "config" (dict), "channel_mean", "channel_std", "step"}."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    trees = {"params": {}, "batch_stats": {}}
    for k, v in flat.items():
        head, _, rest = k.partition("/")
        if head in trees and rest:
            trees[head][rest] = v
    return {
        "params": unflatten_tree(trees["params"]),
        "batch_stats": unflatten_tree(trees["batch_stats"]) or None,
        "config": json.loads(str(flat["config"])),
        "channel_mean": flat["channel_mean"],
        "channel_std": flat["channel_std"],
        "step": int(flat["step"]),
    }
