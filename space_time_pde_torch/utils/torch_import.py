"""Reference-checkpoint import: a reference ``state_dict`` -> the port's
modules.

Counterpart of ``space_time_pde_tpu/utils/torch_import.py``, which maps
the reference's ``torch.save``'d ``state_dict``s
(``src/implicit_net.py::ImNet``, ``src/unet3d.py::UNet3d``) into flax
params. The port's modules are PyTorch modules, so no layout changes:

  Linear          weight [O, I]        -> weight [O, I]
  ConvNd          weight [O, I, *k]    -> weight [O, I, *k]
  ConvTransposeNd weight [I, O, *k]    -> weight [I, O, *k] (both
                  cross-correlate; no flip)
  BatchNorm       weight, bias, running_mean, running_var (and
                  num_batches_tracked where the checkpoint has it)

What carries over is the naming, with the JAX module's rules and error
messages: the ImNet's six linear layers through ``layer_key`` (default
``fcs.{i}``, a ``nn.ModuleList`` named ``fcs``, the oracle's layout), and
the UNet3d through an explicit ``name_map`` ``{flax path: torch
prefix}`` -- the map the JAX module takes. Its flax paths are the port's
module paths with ``/`` for ``.``, and a torch prefix tagged with a
trailing ``!T`` names a transposed conv (there the tag only selects the
JAX side's flip). Inputs may be torch tensors or numpy arrays.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

__all__ = ["imnet_state_dict_from_torch", "unet3d_state_dict_from_torch",
           "load_reference_imnet", "load_reference_unet3d"]

_BN = ("weight", "bias", "running_mean", "running_var")


def _tensor(t) -> torch.Tensor:
    """A CPU copy of a torch tensor or an array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().clone()
    return torch.from_numpy(np.array(t))


def imnet_state_dict_from_torch(
    state_dict: Mapping[str, object],
    layer_key: Callable[[int], str] = lambda i: f"fcs.{i}",
) -> Dict[str, torch.Tensor]:
    """Reference ImNet ``state_dict`` -> the port's ``models.ImNet``
    ``state_dict`` (``fc0`` .. ``fc5``).

    The reference decoder is exactly 6 linear layers (5 hidden + output
    head; ``src/implicit_net.py``). ``layer_key(i)`` maps the layer index
    to the state-dict prefix; pass e.g. ``lambda i: f"fc{i}"`` for
    individually-named attributes.
    """
    out = {}
    for i in range(6):
        k = layer_key(i)
        wk, bk = f"{k}.weight", f"{k}.bias"
        if wk not in state_dict:
            raise KeyError(
                f"ImNet layer {i}: {wk!r} not in state_dict (keys: "
                f"{sorted(state_dict)[:8]}...); adapt layer_key to the "
                "checkpoint's naming")
        out[f"fc{i}.weight"] = _tensor(state_dict[wk])
        if bk in state_dict:
            out[f"fc{i}.bias"] = _tensor(state_dict[bk])
    return out


def unet3d_state_dict_from_torch(
    state_dict: Mapping[str, object],
    name_map: Optional[Mapping[str, str]] = None,
) -> Dict[str, torch.Tensor]:
    """Reference UNet3d ``state_dict`` -> the port's ``models.UNet3d``
    ``state_dict`` (``norm="batch"``: the reference UNet uses
    BatchNorm).

    The reference's exact module naming could not be verified (empty
    reference mount -- SURVEY.md §0), so this needs an explicit
    ``name_map`` {flax path: torch prefix} built once against the real
    checkpoint, e.g. ``{"down_res0/conv1": "encoder.0.conv1",
    "down_res0/norm1": "encoder.0.bn1", ...}``: a prefix with
    ``running_mean`` is a BatchNorm, any other a conv (``!T``: a
    transposed one).
    """
    if name_map is None:
        raise NotImplementedError(
            "unet3d_state_dict_from_torch needs a name_map built against a "
            "real reference checkpoint (the reference mount was empty; "
            "see SURVEY.md §0). The naming rules themselves are "
            "implemented and tested — supply {flax_path: torch_prefix} "
            "and this assembles the state_dict.")
    out: Dict[str, torch.Tensor] = {}
    for flax_path, torch_prefix in name_map.items():
        prefix = (torch_prefix[:-2] if torch_prefix.endswith("!T")
                  else torch_prefix)
        ours = flax_path.replace("/", ".")
        if f"{prefix}.running_mean" in state_dict:
            leaves = _BN + (("num_batches_tracked",)
                            if f"{prefix}.num_batches_tracked" in state_dict
                            else ())
        else:
            leaves = ("weight",) + (("bias",) if state_dict.get(
                f"{prefix}.bias") is not None else ())
        for leaf in leaves:
            out[f"{ours}.{leaf}"] = _tensor(state_dict[f"{prefix}.{leaf}"])
    return out


def _load(module: nn.Module, sd: Dict[str, torch.Tensor]) -> nn.Module:
    """Copy ``sd`` into ``module`` strictly: every parameter and running
    statistic named (BatchNorm's batch counters may keep their own)."""
    own = module.state_dict()
    optional = {k for k in own if k.endswith("num_batches_tracked")}
    missing = sorted(set(own) - set(sd) - optional)
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise ValueError(f"state_dict does not match the module: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    module.load_state_dict({**{k: own[k] for k in optional}, **sd},
                           strict=True)
    return module


def load_reference_imnet(imnet: nn.Module, state_dict: Mapping[str, object],
                         layer_key: Callable[[int], str] = lambda i:
                         f"fcs.{i}") -> nn.Module:
    """Load a reference ImNet ``state_dict`` into the port's ``imnet``."""
    return _load(imnet, imnet_state_dict_from_torch(state_dict, layer_key))


def load_reference_unet3d(unet: nn.Module, state_dict: Mapping[str, object],
                          name_map: Optional[Mapping[str, str]] = None
                          ) -> nn.Module:
    """Load a reference UNet3d ``state_dict`` into the port's BatchNorm
    ``unet`` through ``name_map``."""
    return _load(unet, unet3d_state_dict_from_torch(state_dict, name_map))
