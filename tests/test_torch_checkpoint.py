"""The committed flagship export vs its orbax checkpoint, and the port's
flagship encode + decode vs JAX at the training igres.

The asset ``space_time_pde_torch/assets/r5_rb2d_4x_e900_230400.npz`` is
``scripts/export_torch_params.py``'s output for
``log/r5_rb2d_4x_e900/checkpoints/230400``; it must equal the checkpoint
bit for bit. The parity check runs the flagship widths (UNet nf 32,
lat 64, ImNet nf 64) at igres (4, 16, 16) on the CPU with rtol 1e-4 and
an absolute tolerance of 1e-5 of the largest reference magnitude: this
encoder's intermediate activations reach ~1e6 even on small inputs, so
f32 rounding (both sides f32, summed in other orders) leaves absolute
errors of ~3e-6 of the output scale in small entries (measured).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from space_time_pde_torch.bridge import (
    flatten_tree, load_exported, load_flax_params)
from space_time_pde_torch.models import ImNet as TImNet
from space_time_pde_torch.models import UNet3d as TUNet3d
from space_time_pde_torch.ops.fused_query import \
    fused_query_local_implicit_grid
from space_time_pde_tpu.models import query_local_implicit_grid
from space_time_pde_tpu.train import build_models
from space_time_pde_tpu.utils.checkpoint import CheckpointManager
from space_time_pde_tpu.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "log", "r5_rb2d_4x_e900", "checkpoints")
ASSET = os.path.join(ROOT, "space_time_pde_torch", "assets",
                     "r5_rb2d_4x_e900_230400.npz")


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def exported():
    return load_exported(ASSET)


def test_asset_equals_orbax_checkpoint(exported, tmp_path):
    shutil.copytree(os.path.join(CKPT, "230400"), tmp_path / "230400")
    mngr = CheckpointManager(str(tmp_path))
    try:
        state, extra = mngr.restore(step=230400)
    finally:
        mngr.close()
    want = flatten_tree(jax.tree.map(np.asarray, state.params))
    got = flatten_tree(exported["params"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert state.batch_stats is None and exported["batch_stats"] is None
    assert exported["step"] == int(state.step) == 230400
    assert exported["config"] == extra["config"]
    np.testing.assert_array_equal(
        exported["channel_mean"],
        np.asarray(extra["channel_mean"], np.float32))
    np.testing.assert_array_equal(
        exported["channel_std"], np.asarray(extra["channel_std"], np.float32))
    assert sum(v.size for v in got.values()) == 1416836


def test_flagship_encode_and_decode_match_jax(exported):
    cfg = Config.from_dict(exported["config"])
    igres = (4, 16, 16)
    unet, imnet = build_models(cfg, igres)
    params = exported["params"]
    m = cfg.model
    tunet = load_flax_params(
        TUNet3d(m.in_channels, m.lat_dims, igres, nf=m.unet_nf,
                mf=m.unet_mf, negative_slope=m.negative_slope,
                activation=m.activation, norm=m.norm),
        params["unet"]).eval()
    timnet = load_flax_params(
        TImNet(3, m.lat_dims, m.out_channels, m.imnet_nf, m.activation,
               m.negative_slope), params["imnet"])

    rng = np.random.RandomState(0)
    # 0.1 x N(0, 1): unit-variance noise drives this encoder's latents to
    # ~1e6; this keeps them at data-like magnitudes (~1e3).
    lres = 0.1 * rng.randn(1, *igres, 4).astype(np.float32)
    want_lat = jax.jit(unet.apply)({"params": params["unet"]},
                                   jnp.asarray(lres))
    with torch.no_grad():
        lat = tunet(torch.from_numpy(lres))
    _assert_close(lat.numpy(), np.asarray(want_lat))

    pts = rng.rand(1, 2048, 3).astype(np.float32)
    pts[0, :8] = [[0, 0, 0], [1, 1, 1], [0, 0.5, 1], [1, 0, 0.25],
                  [1 / 3, 2 / 15, 7 / 15], [0.5, 1, 0], [0, 1, 1], [1, 1, 0]]
    want = jax.jit(lambda lt, p: query_local_implicit_grid(
        lambda v: imnet.apply({"params": params["imnet"]}, v), lt, p))(
            want_lat, jnp.asarray(pts))
    with torch.no_grad():
        got = fused_query_local_implicit_grid(
            timnet, torch.from_numpy(np.asarray(want_lat)),
            torch.from_numpy(pts))
    _assert_close(got.numpy(), np.asarray(want))
