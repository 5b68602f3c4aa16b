"""Port parity: dense-lattice inference and the eval CLI vs the JAX
package, on the CPU at small widths.

The port's decoder runs the fused decode's plain twin here; the JAX
side runs ``make_dense_decoder(fused=False)`` (the jnp query). Both get
the same flax weights (through the bridge) and the same low-res input.
Tolerance rtol = atol = 1e-4: a UNet encode feeds an ImNet decode, both
f32, summed in other orders.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from space_time_pde_torch import inference as tinf
from space_time_pde_torch.bridge import load_flax_params, save_exported
from space_time_pde_torch.models import ImNet as TImNet
from space_time_pde_torch.models import UNet3d as TUNet3d
from space_time_pde_torch.ops import fused_query as tfq
from space_time_pde_tpu import inference as jinf
from space_time_pde_tpu.data import RB2DataLoader, save_npz, \
    taylor_green_fields
from space_time_pde_tpu.models import ImNet, UNet3d
from space_time_pde_tpu.utils.config import Config

TOL = dict(rtol=1e-4, atol=1e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _models(igres, lat=8, unet_nf=4, imnet_nf=4, seed=0):
    unet = UNet3d(in_features=4, out_features=lat, igres=igres, nf=unet_nf,
                  mf=16)
    imnet = ImNet(dim=3, in_features=lat, out_features=4, nf=imnet_nf)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = {
        "unet": unet.init(k1, jnp.zeros((1, *igres, 4)))["params"],
        "imnet": imnet.init(k2, jnp.zeros((1, 3 + lat)))["params"],
    }
    tunet = load_flax_params(
        TUNet3d(4, lat, igres, nf=unet_nf, mf=16), params["unet"]).eval()
    timnet = load_flax_params(TImNet(3, lat, 4, imnet_nf), params["imnet"])
    return unet, imnet, params, tunet, timnet


def test_make_dense_decoder_matches_jax():
    igres, out_shape = (4, 8, 8), (4, 16, 16)
    unet, imnet, params, tunet, timnet = _models(igres)
    lres = np.random.RandomState(1).randn(*igres, 4).astype(np.float32)
    want = jinf.make_dense_decoder(unet, imnet, out_shape, chunk=300,
                                   fused=False)(params, jnp.asarray(lres))
    tfq.reset_launches()
    dec = tinf.make_dense_decoder(tunet, timnet, out_shape, chunk=300)
    got = dec(lres)
    assert got.shape == want.shape == (*out_shape, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sum(tfq.LAUNCHES.values()) == 0
    assert dec.provenance["tf32_matmul"] is False
    assert dec.provenance["tf32_cudnn"] is False
    assert dec.provenance["block_pts"] is None      # no kernel blocks on CPU


def test_lattice_matches_jax_construction():
    """The numpy f32 lattice, not torch.linspace (which rounds nodes
    differently and moves points across cell faces)."""
    out_shape = (16, 128, 512)
    pts = tinf.lattice_points(out_shape)
    axes = [np.linspace(0, 1, n, dtype=np.float32) for n in out_shape]
    want = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    np.testing.assert_array_equal(pts, want)


@pytest.mark.parametrize("t_total,nt,stride", [
    (32, 16, 8), (33, 16, 8), (16, 16, 1), (40, 8, 3), (20, 4, 0)])
def test_stitch_plan_and_weights_match_jax(t_total, nt, stride):
    assert tinf.stitch_plan(t_total, nt, stride) == \
        jinf.stitch_plan(t_total, nt, stride)
    np.testing.assert_array_equal(tinf.stitch_weights(nt),
                                  jinf.stitch_weights(nt))


@pytest.mark.parametrize("eval_igres,train_igres", [
    ((4, 16, 64), (4, 16, 16)), ((4, 16, 16), (4, 16, 16)),
    ((4, 32, 16), (4, 16, 16))])
def test_igres_mismatch_note_matches_jax(eval_igres, train_igres):
    assert tinf.igres_mismatch_note(eval_igres, train_igres, (2,)) == \
        jinf.igres_mismatch_note(eval_igres, train_igres, (2,))


def test_stitched_decode_matches_jax():
    igres, out_shape = (4, 4, 8), (4, 8, 16)
    unet, imnet, params, tunet, timnet = _models(igres, seed=2)
    lres = np.random.RandomState(3).randn(7, *igres[1:], 4).astype(
        np.float32)
    window = lambda t0: lres[t0:t0 + 4]
    jdec = jinf.make_dense_decoder(unet, imnet, out_shape, chunk=256,
                                   fused=False)
    want, wstarts = jinf.stitched_decode(
        jdec, params, window, 7, 4, 2, out_shape[1:], channel_mean=0.5,
        channel_std=2.0)
    got, starts = tinf.stitched_decode(
        tinf.make_dense_decoder(tunet, timnet, out_shape, chunk=256),
        window, 7, 4, 2, out_shape[1:], channel_mean=0.5, channel_std=2.0)
    assert starts == wstarts
    np.testing.assert_allclose(got, want, **TOL)


def test_eval_cli_matches_jax(tmp_path):
    """evaluation_torch.main on a tiny exported model and Taylor–Green
    data: same windows, same low-res input, decode equal to JAX's."""
    cfg = Config()
    cfg.model.lat_dims, cfg.model.unet_nf, cfg.model.imnet_nf = 8, 4, 4
    cfg.data.nt, cfg.data.nz, cfg.data.nx = 8, 16, 16
    cfg.data.downsamp_t, cfg.data.downsamp_xz = 2, 4
    cfg.data.data_folder, cfg.data.eval_data = str(tmp_path), "tg.npz"
    save_npz(str(tmp_path / "tg.npz"),
             taylor_green_fields(nt=12, nz=16, nx=32))
    igres = (4, 4, 8)                           # eval grid: x doubles
    unet, imnet, params, _, _ = _models(igres, seed=4)
    mean = np.asarray([0.1, 0.0, -0.1, 0.2], np.float32)
    std = np.asarray([0.5, 1.0, 0.7, 0.9], np.float32)
    save_exported(str(tmp_path / "w.npz"), params, None, cfg.to_dict(),
                  mean, std, 7)

    spec = importlib.util.spec_from_file_location(
        "evaluation_torch",
        os.path.join(ROOT, "experiments", "rb2d", "evaluation_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    res = cli.main(["--params", str(tmp_path / "w.npz"), "--device", "cpu",
                    "--eval_windows", "2", "--query_chunk", "1000",
                    "--save_path", str(tmp_path / "pred.npz")])
    assert res["t0s"] == [0, 4]

    ds = RB2DataLoader(str(tmp_path), "tg.npz", nt=8, nz=16, nx=16,
                       downsamp_t=2, downsamp_xz=4)
    ds.channel_mean, ds.channel_std = mean, std
    lres = ds.full_lres_sequence(0, 8)
    np.testing.assert_allclose(res["lres0"], lres, rtol=1e-6, atol=1e-6)
    want = jinf.make_dense_decoder(unet, imnet, (8, 16, 32), chunk=1000,
                                   fused=False)(params, jnp.asarray(lres))
    np.testing.assert_allclose(res["window0"].numpy(), np.asarray(want),
                               **TOL)
    gt = ds.data[0:8]
    pred = np.asarray(want) * std + mean
    rel = np.linalg.norm(pred - gt) / (np.linalg.norm(gt) + 1e-12)
    np.testing.assert_allclose(res["rel_l2"][0], rel, rtol=1e-4)
    with np.load(tmp_path / "pred.npz") as z:
        assert z["u"].shape == (8, 16, 32)

    # --full_sequence: windows [0, 8) and [4, 12) stitched over 12 frames.
    res = cli.main(["--params", str(tmp_path / "w.npz"), "--device", "cpu",
                    "--full_sequence", "--query_chunk", "1000",
                    "--save_path", str(tmp_path / "full.npz")])
    want, starts = jinf.stitched_decode(
        jinf.make_dense_decoder(unet, imnet, (8, 16, 32), chunk=1000,
                                fused=False), params,
        lambda t0: ds.full_lres_sequence(t0, 8), 12, 8, 4, (16, 32),
        channel_mean=mean, channel_std=std)
    assert starts == [0, 4]
    with np.load(tmp_path / "full.npz") as z:
        got = np.stack([z[c] for c in "pbuw"], -1)
    np.testing.assert_allclose(got, want, **TOL)
