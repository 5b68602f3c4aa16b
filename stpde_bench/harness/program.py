"""The system under test, composed as its CLIs compose it
(``experiments/{rb2d,turb3d}/train_torch.py``, ``evaluation_torch.py``),
from a configuration file and a traffic mix. Only this module and the
two loops import the program."""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from space_time_pde_torch.models.policy import policy_dtype
from space_time_pde_torch.physics.systems import get_pde_layer
from space_time_pde_torch.train import build_models
from space_time_pde_torch.utils.config import Config

AXES = {"rb2d": ("t", "z", "x"), "ns3d": ("t", "z", "y", "x")}


def config(cfg: dict, traffic: dict) -> Config:
    """The program's ``Config`` for the configuration under the mix."""
    c = Config()
    m, t, d, p = c.model, c.train, c.data, c.physics
    mod = cfg["model"]
    m.lat_dims, m.unet_nf, m.unet_mf = (mod["lat_dims"], mod["unet_nf"],
                                        mod["unet_mf"])
    m.imnet_nf, m.in_channels = mod["imnet_nf"], mod["in_channels"]
    m.out_channels, m.activation = mod["out_channels"], mod["activation"]
    m.negative_slope, m.norm = mod["negative_slope"], mod["norm"]
    m.use_bf16 = bool(traffic.get("use_bf16", False))
    m.fused_query = True
    tr = cfg.get("train", {})
    if tr:
        t.alpha_pde, t.reg_loss_type = tr["alpha_pde"], tr["reg_loss"]
        t.clip_grad, t.lr, t.lr_schedule = (tr["clip_grad"], tr["lr"],
                                            tr["lr_schedule"])
        t.epochs, t.pde_loss_type = tr["epochs"], tr["pde_loss"]
        t.batch_size_per_gpu = tr["batch"]
        t.pseudo_epoch_size = tr["steps_per_epoch"] * tr["batch"]
        t.pde_derivs = "jet"
        t.pde_bf16 = bool(traffic.get("pde_bf16", False))
        t.cliff_recovery = False
    d.n_samp_pts_per_crop = cfg["data"]["points_per_crop"]
    p.pde_system = cfg["physics"]["system"]
    for k in ("rayleigh", "prandtl", "viscosity"):
        if k in cfg["physics"]:
            setattr(p, k, cfg["physics"][k])
    return c


def models(cfg: dict, pcfg: Config, grid, weights: Dict[str, torch.Tensor],
           device):
    """The program's encoder and ImNet for a low-res ``grid``, holding
    ``weights`` (checked name for name)."""
    unet, imnet = build_models(pcfg, tuple(grid), device)
    with torch.no_grad():
        for prefix, mod in (("unet.", unet), ("imnet.", imnet)):
            mod.load_state_dict({k[len(prefix):]: v for k, v in
                                 weights.items() if k.startswith(prefix)},
                                strict=True)
    return unet, imnet


def pde_layer(cfg: dict, mean, std):
    data, phys = cfg["data"], cfg["physics"]
    extents = [(c - 1) * s for c, s in zip(data["crop"], data["spacing"])]
    kw = {f"{a}_crop": e for a, e in zip(AXES[phys["system"]], extents)}
    kw.update({k: v for k, v in phys.items() if k != "system"})
    return get_pde_layer(phys["system"], mean=mean, std=std, **kw)


def sampler_source(cfg: dict, field: np.ndarray, valid_t0, mean, std):
    """What ``DeviceSampler`` reads of a dataset, over the benchmark's
    field (the datasets' file loading is bypassed: the fields are made
    from the seed)."""
    data = cfg["data"]
    grid = field.shape[1:-1]
    origins = (len(valid_t0),) + tuple(g - c + 1 for g, c in
                                       zip(grid, data["crop"][1:]))
    return SimpleNamespace(
        lres_filter="none", lres_interp="linear", velonly=False,
        data=field, channel_mean=mean, channel_std=std,
        crop=tuple(data["crop"]), lres=tuple(data["lres"]),
        valid_t0=np.asarray(valid_t0), _origins=origins,
        n_samp_pts_per_crop=data["points_per_crop"])


def compute_dtype(traffic: dict) -> torch.dtype:
    return policy_dtype(bool(traffic.get("use_bf16", False)))
