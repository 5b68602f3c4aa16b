"""Config dataclasses + argparse bridge (a copy of the JAX package's).

Identical to ``space_time_pde_tpu/utils/config.py``, which is JAX-free
itself, but importing it runs ``space_time_pde_tpu/utils/__init__.py``,
which imports jax; the port must not, so it carries this copy.
``tests/test_torch_imports.py`` holds the two to the same fields.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["Config", "ModelConfig", "DataConfig", "TrainConfig",
           "PhysicsConfig", "add_args", "config_from_args"]


@dataclass
class ModelConfig:
    lat_dims: int = 32          # latent grid channels (--lat_dims)
    unet_nf: int = 16           # UNet base filters (--unet_nf)
    unet_mf: int = 512          # UNet max filters
    imnet_nf: int = 32          # ImNet width multiplier (--imnet_nf)
    in_channels: int = 4        # p, b, u, w
    out_channels: int = 4
    activation: str = "leaky_relu"  # models/nonlinearities.py registry
    norm: str = "group"         # group (default) | batch (reference UNet3d)
    negative_slope: float = 0.01
    use_bf16: bool = False      # bf16 compute policy (params stay f32)
    fused_query: bool = True    # Pallas fused query kernel when on TPU


@dataclass
class DataConfig:
    data_folder: str = "./data"
    train_data: str = "rb2d_ra1e6_s42.npz"
    eval_data: str = "rb2d_ra1e6_s42.npz"
    nt: int = 16
    nz: int = 128
    nx: int = 128
    downsamp_t: int = 4
    downsamp_xz: int = 8
    n_samp_pts_per_crop: int = 512
    lres_filter: str = "none"
    lres_interp: str = "linear"
    normalize_channels: bool = True
    velonly: bool = False       # predict (u, w) only (reference flag)


@dataclass
class PhysicsConfig:
    pde_system: str = "rb2d"    # rb2d | ns2d | advection_diffusion | ...
    rayleigh: float = 1e6
    prandtl: float = 1.0
    viscosity: float = 1e-3     # ns2d / advection_diffusion systems
    use_continuity: bool = True  # reference trains with all 4 equations


@dataclass
class TrainConfig:
    epochs: int = 100
    batch_size_per_gpu: int = 8     # per-DEVICE batch (reference name kept)
    lr: float = 1e-2
    alpha_pde: float = 1.0          # weight of the PDE residual loss
    reg_loss_type: str = "l1"       # l1 | l2 | huber
    clip_grad: float = 1.0
    pseudo_epoch_size: int = 2048   # samples per "epoch"
    log_dir: str = "./log"
    resume: Optional[str] = None
    seed: int = 42
    num_devices: int = 0            # 0 = all local devices (data parallel)
    lr_schedule: str = "constant"   # constant | cosine
    ckpt_every_epochs: int = 1
    keep_checkpoints: int = 3
    pde_derivs: str = "jet"         # jet (fused Pallas on TPU) | jet_jnp | tower
    pde_bf16: bool = False          # let the PDE jet follow use_bf16 (default:
                                    # jet stays f32 — bf16 2nd-order diverges,
                                    # see BASELINE.md round-2)
    pde_loss_type: str = "l2"       # l2 (reference) | huber (bounded-influence
                                    # residuals; tames 2nd-order loss cliffs)
    cliff_recovery: bool = True     # on a pde-loss explosion / frozen
                                    # non-finite streak: restore the last
                                    # checkpoint and continue at reduced lr
    recovery_lr_factor: float = 0.5  # lr multiplier applied per recovery


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    physics: PhysicsConfig = field(default_factory=PhysicsConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return cls(
            model=ModelConfig(**d.get("model", {})),
            data=DataConfig(**d.get("data", {})),
            physics=PhysicsConfig(**d.get("physics", {})),
            train=TrainConfig(**d.get("train", {})),
        )


# Reference flag name -> (section, field). Flags the reference exposes
# in experiments/rb2d/train.py keep their exact spelling.
_FLAG_MAP = {
    "epochs": ("train", "epochs"),
    "batch_size_per_gpu": ("train", "batch_size_per_gpu"),
    "lr": ("train", "lr"),
    "alpha_pde": ("train", "alpha_pde"),
    "reg_loss_type": ("train", "reg_loss_type"),
    "clip_grad": ("train", "clip_grad"),
    "pseudo_epoch_size": ("train", "pseudo_epoch_size"),
    "log_dir": ("train", "log_dir"),
    "resume": ("train", "resume"),
    "seed": ("train", "seed"),
    "num_devices": ("train", "num_devices"),
    "lr_schedule": ("train", "lr_schedule"),
    "pde_derivs": ("train", "pde_derivs"),
    "pde_bf16": ("train", "pde_bf16"),
    "pde_loss_type": ("train", "pde_loss_type"),
    "cliff_recovery": ("train", "cliff_recovery"),
    "recovery_lr_factor": ("train", "recovery_lr_factor"),
    "data_folder": ("data", "data_folder"),
    "train_data": ("data", "train_data"),
    "eval_data": ("data", "eval_data"),
    "nt": ("data", "nt"),
    "nz": ("data", "nz"),
    "nx": ("data", "nx"),
    "downsamp_t": ("data", "downsamp_t"),
    "downsamp_xz": ("data", "downsamp_xz"),
    "n_samp_pts_per_crop": ("data", "n_samp_pts_per_crop"),
    "lres_filter": ("data", "lres_filter"),
    "lres_interp": ("data", "lres_interp"),
    "normalize_channels": ("data", "normalize_channels"),
    "velonly": ("data", "velonly"),
    "lat_dims": ("model", "lat_dims"),
    "unet_nf": ("model", "unet_nf"),
    "unet_mf": ("model", "unet_mf"),
    "imnet_nf": ("model", "imnet_nf"),
    "activation": ("model", "activation"),
    "norm": ("model", "norm"),
    "use_bf16": ("model", "use_bf16"),
    "fused_query": ("model", "fused_query"),
    "pde_system": ("physics", "pde_system"),
    "rayleigh": ("physics", "rayleigh"),
    "prandtl": ("physics", "prandtl"),
    "viscosity": ("physics", "viscosity"),
}


def add_args(parser: argparse.ArgumentParser,
             defaults: Optional[Config] = None) -> None:
    """Register every config field as a flag with reference names."""
    cfg = defaults or Config()
    for flag, (section, fname) in _FLAG_MAP.items():
        default = getattr(getattr(cfg, section), fname)
        f = next(f for f in dataclasses.fields(getattr(cfg, section))
                 if f.name == fname)
        ftype = f.type if isinstance(f.type, type) else None
        if ftype is bool or isinstance(default, bool):
            parser.add_argument(
                f"--{flag}", type=lambda s: s.lower() in ("1", "true", "yes"),
                default=default, metavar="BOOL")
        elif isinstance(default, int):
            parser.add_argument(f"--{flag}", type=int, default=default)
        elif isinstance(default, float):
            parser.add_argument(f"--{flag}", type=float, default=default)
        else:
            parser.add_argument(f"--{flag}", type=str, default=default)


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = Config()
    for flag, (section, fname) in _FLAG_MAP.items():
        if hasattr(args, flag):
            setattr(getattr(cfg, section), fname, getattr(args, flag))
    return cfg
