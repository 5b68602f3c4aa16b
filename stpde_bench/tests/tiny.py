"""Tiny versions of the benchmark's cells for the CPU tests: every width
and size cut down, the structure kept (the same encoders, corners, PDE
systems and loops)."""

from __future__ import annotations

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from stpde_bench.harness import spec  # noqa: E402

TRAIN = ("rb2d-train-f32", "turb3d-train-f32")
DECODE = ("rb2d-decode-f32", "turb3d-decode-f32")
SEED = 2 ** 31 + 11


def tiny_config(cfg: dict) -> dict:
    c = copy.deepcopy(cfg)
    c["model"].update(unet_nf=4, unet_mf=8, imnet_nf=2, lat_dims=8)
    d = c["data"]
    if c["model"]["encoder"] == "unet3d":
        d["fields"].update(sims=2, frames=12, grid=[16, 32])
        d.update(crop=[8, 16, 16], lres=[4, 8, 8], points_per_crop=32)
        c["decode"].update(out_shape=[8, 16, 32], lres=[4, 4, 8], chunk=512)
    else:
        d["fields"].update(sims=3, frames=10, grid=[8, 8, 8])
        d.update(crop=[4, 8, 8, 8], lres=[2, 4, 4, 4], points_per_crop=32)
        c["decode"].update(out_shape=[4, 8, 8, 8], lres=[2, 4, 4, 4],
                           chunk=512)
    c["train"].update(batch=2, inner_steps=4)
    return c


def tiny_cell(workload: str, root=None):
    cell = spec.resolve(workload, root or spec.ROOT)
    cell.config = tiny_config(cell.config)
    cell.traffic = dict(cell.traffic, traced_dispatches=1, traced_windows=1)
    return cell


def run_cpu(cell, seed=SEED, traced=False, seconds=0.2, root=None):
    """One run of ``cell`` on the CPU, past the look for a card."""
    import time

    from stpde_bench.run import measure

    return measure(cell, seed, seconds, traced, torch.device("cpu"),
                   time.time(), root=root)
