"""What the metric readers share: the cell's sizes and the operations of
its work, from the configuration."""

from __future__ import annotations

import math

from stpde_bench.counts import encoder, kernels


def dim(cell) -> int:
    return len(cell.config["data"]["lres"])


def imnet_shape(cell) -> dict:
    m = cell.config["model"]
    return dict(c=m["lat_dims"], dim=dim(cell), nf=m["imnet_nf"],
                out=m["out_channels"])


def step_points(cell) -> int:
    tr, data = cell.config["train"], cell.config["data"]
    return tr["batch"] * data["points_per_crop"]


def train_step_flop(cell) -> float:
    """The model's operations a training step: the encoder's forward and
    backward on the batch, and the jet's forward and backward at the
    step's points (no recomputation; the PDE layer, the loss and the
    optimizer, under 1%, left out)."""
    cfg = cell.config
    n = step_points(cell)
    return (cfg["train"]["batch"]
            * encoder.train_flop(cfg["model"], cfg["data"]["lres"])
            + kernels.jet_fwd(n, **imnet_shape(cell))[0]
            + kernels.jet_bwd(n, **imnet_shape(cell))[0])


def decode_cells(cell) -> int:
    return math.prod(g - 1 for g in cell.config["decode"]["lres"])


def window_flop(cell) -> float:
    """A decode window's operations: the encoder's forward and the
    decode of every lattice point."""
    cfg = cell.config
    dec = cfg["decode"]
    n = math.prod(dec["out_shape"])
    return (encoder.forward_flop(cfg["model"], dec["lres"])
            + kernels.decode_blend_gather(
                n, n_cells=decode_cells(cell), **imnet_shape(cell))[0])
