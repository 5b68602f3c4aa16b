"""The eval CLIs' ``--ckpt``: a port training run's checkpoint directory,
evaluated on the CPU at tiny widths (lat 8, unet_nf 4, imnet_nf 4).

- (a) the same seeded weights saved as a JAX orbax checkpoint and as a
  port checkpoint, each evaluated by its package's CLI with ``--ckpt``:
  the same windows, predictions at ``test_torch_inference.py``'s
  tolerance and rel-L2 at rtol 1e-4, for rb2d and turb3d;
- (b) a tiny port training run, then ``--ckpt`` on its directory: the
  first window equals, bit for bit, the decode of models built at the
  eval grid from the trainer's returned state (rb2d with GroupNorm, with
  BatchNorm, under the bf16 policy; turb3d);
- (c) the refusals: neither flag or both, a missing or empty directory
  (nothing created), a config that no longer fits the weights;
- (d) the sharded encoders keep the plain modules' names, so a rank-0
  checkpoint of a ``--sharded_encoder`` run loads into the eval's models.
"""

import importlib.util
import os
import re
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from conftest import load_driver
from space_time_pde_torch import inference as tinf
from space_time_pde_torch.bridge import load_flax_params
from space_time_pde_torch.data import save_npz, taylor_green_fields
from space_time_pde_torch.data.generator import beltrami_fields
from space_time_pde_torch.models import UNet3d as TUNet3d
from space_time_pde_torch.models import UNet4d as TUNet4d
from space_time_pde_torch.parallel.sharded_unet import ShardedUNet3d
from space_time_pde_torch.parallel.sharded_unet4d import ShardedUNet4d
from space_time_pde_torch.train import trainer as ttrainer
from space_time_pde_torch.train.optim import make_optimizer as tmake_opt
from space_time_pde_torch.utils.checkpoint import (
    CheckpointManager as TManager, latest_checkpoint, load_models)
from space_time_pde_torch.utils.config import Config as TConfig
from space_time_pde_tpu.train import build_models as jbuild, init_state
from space_time_pde_tpu.train.trainer import make_optimizer
from space_time_pde_tpu.utils.checkpoint import CheckpointManager
from space_time_pde_tpu.utils.config import Config

TOL = dict(rtol=1e-4, atol=1e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN = np.asarray([0.1, 0.0, -0.1, 0.2], np.float32)
STD = np.asarray([0.5, 1.0, 0.7, 0.9], np.float32)
TARGS = dict(nt=8, nz=12, ny=12, nx=12, downsamp_t=4, downsamp_xyz=3,
             lat_dims=4, unet_nf=2, unet_mf=4, imnet_nf=2, viscosity=1e-2)


def _cli(family, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "experiments", family, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_checkpoint(directory, cfg, lres_shape, jparams, step, extra):
    """A port checkpoint of the flax weights ``jparams`` (models built by
    the trainer at ``lres_shape``), as a training run saves one."""
    tcfg = TConfig.from_dict(cfg.to_dict())
    unet, imnet = ttrainer.build_models(tcfg, lres_shape, "cpu")
    state = ttrainer.init_state(0, unet, imnet, tmake_opt(tcfg))
    load_flax_params(state.unet, jparams["unet"])
    load_flax_params(state.imnet, jparams["imnet"])
    state.step = step
    TManager(directory).save(step, state, extra)


def _jax_windows(out):
    return [int(t) for t in re.findall(r"window t0=(\d+): rel_l2", out)], \
        [float(r) for r in re.findall(r": rel_l2 = ([0-9.]+)", out)]


def test_rb2d_ckpt_matches_jax(tmp_path, monkeypatch, capsys):
    cfg = Config()
    cfg.model.lat_dims, cfg.model.unet_nf, cfg.model.imnet_nf = 8, 4, 4
    cfg.data.nt, cfg.data.nz, cfg.data.nx = 8, 16, 16
    cfg.data.downsamp_t, cfg.data.downsamp_xz = 2, 4
    cfg.data.data_folder, cfg.data.eval_data = str(tmp_path), "tg.npz"
    save_npz(str(tmp_path / "tg.npz"),
             taylor_green_fields(nt=12, nz=16, nx=32))
    train_igres = (4, 4, 4)                     # the eval's x doubles
    unet, imnet = jbuild(cfg, train_igres)
    state = init_state(jax.random.PRNGKey(4), cfg, unet, imnet,
                       make_optimizer(cfg))
    state = state.replace(step=state.step + 7)
    extra = {"config": cfg.to_dict(), "channel_mean": MEAN,
             "channel_std": STD}
    CheckpointManager(str(tmp_path / "jax")).save(7, state, extra)
    _port_checkpoint(str(tmp_path / "port"), cfg, train_igres,
                     jax.tree.map(np.asarray, state.params), 7, extra)

    flags = ["--eval_windows", "2", "--query_chunk", "1000"]
    monkeypatch.setattr(sys, "argv", [
        "evaluation.py", "--ckpt", str(tmp_path / "jax"), *flags,
        "--save_path", str(tmp_path / "jax_pred.npz")])
    load_driver("rb2d", "evaluation").main()
    jax_t0s, jax_rel = _jax_windows(capsys.readouterr().out)
    res = _cli("rb2d", "evaluation_torch").main([
        "--ckpt", str(tmp_path / "port"), "--device", "cpu", *flags,
        "--save_path", str(tmp_path / "pred.npz")])
    out = capsys.readouterr().out
    source = f"ckpt={tmp_path / 'port'}"
    assert f"restored step 7 from {source}" in out
    assert f"{source} step=7" in out
    assert res["step"] == 7 and res["source"] == source
    assert res["t0s"] == jax_t0s == [0, 4]
    np.testing.assert_allclose(res["rel_l2"], jax_rel, rtol=0, atol=1e-5)
    with np.load(tmp_path / "pred.npz") as got, \
            np.load(tmp_path / "jax_pred.npz") as want:
        for c in "pbuw":
            assert got[c].shape == (8, 16, 32)
            np.testing.assert_allclose(got[c], want[c], **TOL, err_msg=c)
        np.testing.assert_allclose(got["rel_l2"], want["rel_l2"], rtol=1e-4)


def test_turb3d_ckpt_matches_jax(tmp_path, monkeypatch, capsys):
    save_npz(str(tmp_path / "beltrami_s42.npz"),
             beltrami_fields(42, nt=12, n=12))
    cfg = Config()
    cfg.model.lat_dims, cfg.model.unet_nf = 4, 2
    cfg.model.unet_mf, cfg.model.imnet_nf = 4, 2
    cfg.data.data_folder, cfg.data.eval_data = str(tmp_path), \
        "beltrami_s42.npz"
    jtrain = load_driver("turb3d", "train")
    a = SimpleNamespace(use_bf16=False, **TARGS)
    lres_shape = (2, 4, 4, 4)
    unet, imnet = jtrain.build_turb3d_models(a, lres_shape)
    state = jtrain.init_state4d(jax.random.PRNGKey(5), a, unet, imnet,
                                make_optimizer(cfg), lres_shape)
    state = state.replace(step=state.step + 11)
    extra = {"config": cfg.to_dict(), "turb3d_args": TARGS,
             "channel_mean": MEAN, "channel_std": STD}
    CheckpointManager(str(tmp_path / "jax")).save(11, state, extra)
    _port_checkpoint(str(tmp_path / "port"), cfg, lres_shape,
                     jax.tree.map(np.asarray, state.params), 11, extra)

    flags = ["--eval_windows", "2", "--query_chunk", "2000"]
    monkeypatch.setattr(sys, "argv", [
        "evaluation.py", "--ckpt", str(tmp_path / "jax"), *flags,
        "--save_path", str(tmp_path / "jax_pred.npz")])
    load_driver("turb3d", "evaluation").main()
    jax_t0s, jax_rel = _jax_windows(capsys.readouterr().out)
    res = _cli("turb3d", "evaluation_torch").main([
        "--ckpt", str(tmp_path / "port"), "--device", "cpu", *flags,
        "--save_path", str(tmp_path / "pred.npz")])
    assert f"restored step 11 from ckpt={tmp_path / 'port'}" in \
        capsys.readouterr().out
    assert res["t0s"] == jax_t0s == [0, 4]
    np.testing.assert_allclose(res["rel_l2"], jax_rel, rtol=0, atol=1e-5)
    with np.load(tmp_path / "pred.npz") as got, \
            np.load(tmp_path / "jax_pred.npz") as want:
        for c in "puvw":
            assert got[c].shape == (8, 12, 12, 12)
            np.testing.assert_allclose(got[c], want[c], **TOL, err_msg=c)
        np.testing.assert_allclose(got["rel_l2"], want["rel_l2"], rtol=1e-4)


def _yardstick(state, ckpt_dir, res):
    """The CLI's first window decoded by models that the trainer builds
    at the eval grid (the saved config's), given the returned state's
    weights and buffers."""
    cfg = TConfig.from_dict(latest_checkpoint(ckpt_dir)["extra"]["config"])
    lres0 = torch.as_tensor(res["lres0"])
    unet, imnet = ttrainer.build_models(cfg, tuple(lres0.shape[:-1]), "cpu")
    unet.load_state_dict(state.unet.state_dict())
    imnet.load_state_dict(state.imnet.state_dict())
    dec = tinf.make_dense_decoder(
        unet.eval(), imnet.eval(), tuple(res["window0"].shape[:-1]),
        chunk=res["provenance"]["chunk"],
        compute_dtype=tinf.decode_dtype("auto", cfg.model.use_bf16))
    return dec(lres0)


def _rb2d_train_flags(tmp_path, *extra):
    return ["--device", "cpu", "--data_folder", str(tmp_path),
            "--train_data", "tg.npz", "--eval_data", "tg.npz", "--nt", "8",
            "--nz", "16", "--nx", "16", "--downsamp_t", "2",
            "--downsamp_xz", "4", "--n_samp_pts_per_crop", "32",
            "--lat_dims", "8", "--unet_nf", "4", "--imnet_nf", "4",
            "--pseudo_epoch_size", "8", "--batch_size_per_gpu", "2",
            "--inner_steps", "2", "--alpha_pde", "0.05", "--rayleigh", "100",
            "--lr", "2e-3", "--epochs", "1",
            "--log_dir", str(tmp_path / "log"), *extra]


@pytest.mark.parametrize("extra", [(), ("--norm", "batch"),
                                   ("--use_bf16", "true")],
                         ids=["group", "batch", "bf16"])
def test_rb2d_train_then_eval_ckpt(tmp_path, capsys, extra):
    save_npz(str(tmp_path / "tg.npz"),
             taylor_green_fields(nt=10, nz=16, nx=32))
    run = _cli("rb2d", "train_torch").main(_rb2d_train_flags(tmp_path,
                                                             *extra))
    state = run["state"]
    capsys.readouterr()
    res = _cli("rb2d", "evaluation_torch").main([
        "--ckpt", str(tmp_path / "log" / "checkpoints"), "--device", "cpu",
        "--eval_windows", "2", "--save_path", str(tmp_path / "pred.npz")])
    out = capsys.readouterr().out
    assert res["step"] == state.step == 4 and res["t0s"] == [0, 2]
    assert tuple(res["window0"].shape) == (8, 16, 32, 4)   # x extended
    assert torch.equal(res["window0"], _yardstick(
        state, str(tmp_path / "log" / "checkpoints"), res))
    if "batch" in extra:
        stats = {k: b for k, b in state.buffers().items()
                 if "running" in k}
        assert stats
        assert all(not torch.equal(b, torch.zeros_like(b)) and
                   not torch.equal(b, torch.ones_like(b))
                   for b in stats.values())
        for k, b in res["models"][0].named_buffers():
            assert torch.equal(b, state.buffers()[f"unet.{k}"]), k
    dtype = "bfloat16" if "--use_bf16" in extra else "float32"
    assert res["provenance"]["compute_dtype"] == dtype
    assert f"dtype={dtype}" in out


def test_turb3d_train_then_eval_ckpt(tmp_path, capsys):
    # 8^3 fields: the eval grid is the crop's (UNet4d's depth follows
    # its smallest axis, so a 12^3 or 16^3 eval grid would not fit).
    for seed, nt in ((42, 12), (100, 10)):
        save_npz(str(tmp_path / f"beltrami_s{seed}.npz"),
                 beltrami_fields(seed, nt=nt, n=8))
    run = _cli("turb3d", "train_torch").main([
        "--device", "cpu", "--data_folder", str(tmp_path),
        "--train_data", "beltrami_s42.npz,beltrami_s100.npz",
        "--eval_data", "beltrami_s42.npz", "--nt", "8", "--nz", "8",
        "--ny", "8", "--nx", "8", "--downsamp_t", "2", "--downsamp_xyz", "4",
        "--lat_dims", "4", "--unet_nf", "2", "--unet_mf", "4",
        "--imnet_nf", "2", "--n_samp_pts_per_crop", "16",
        "--batch_size_per_gpu", "2", "--pseudo_epoch_size", "4",
        "--inner_steps", "2", "--alpha_pde", "0.1", "--epochs", "1",
        "--log_dir", str(tmp_path / "log")])
    state = run["state"]
    res = _cli("turb3d", "evaluation_torch").main([
        "--ckpt", str(tmp_path / "log" / "checkpoints"), "--device", "cpu",
        "--eval_windows", "2", "--save_path", str(tmp_path / "pred.npz")])
    assert f"restored step 2 from ckpt={tmp_path / 'log' / 'checkpoints'}" \
        in capsys.readouterr().out
    assert res["step"] == state.step == 2
    assert tuple(res["window0"].shape) == (8, 8, 8, 8, 4)
    assert torch.equal(res["window0"], _yardstick(
        state, str(tmp_path / "log" / "checkpoints"), res))


@pytest.mark.parametrize("family", ["rb2d", "turb3d"])
def test_eval_cli_refusals(tmp_path, capsys, family):
    cli = _cli(family, "evaluation_torch")
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["--ckpt", str(tmp_path), "--params", "w.npz",
                  "--device", "cpu"])
    assert "not allowed with argument" in capsys.readouterr().err
    missing = tmp_path / "no" / "checkpoints"
    with pytest.raises(FileNotFoundError, match=str(missing)):
        cli.main(["--ckpt", str(missing), "--device", "cpu"])
    assert not (tmp_path / "no").exists()
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        cli.main(["--ckpt", str(tmp_path / "empty"), "--device", "cpu"])
    assert os.listdir(tmp_path / "empty") == []


def test_edited_config_refused(tmp_path):
    """A saved config whose ``unet_nf`` no longer fits the weights: the
    eval's models take other shapes, and the loader names the keys."""
    save_npz(str(tmp_path / "tg.npz"),
             taylor_green_fields(nt=8, nz=16, nx=16))
    tcfg = TConfig()
    tcfg.model.lat_dims, tcfg.model.unet_nf, tcfg.model.imnet_nf = 8, 4, 4
    tcfg.data.nt, tcfg.data.nz, tcfg.data.nx = 8, 16, 16
    tcfg.data.downsamp_t, tcfg.data.downsamp_xz = 2, 4
    tcfg.data.data_folder, tcfg.data.eval_data = str(tmp_path), "tg.npz"
    unet, imnet = ttrainer.build_models(tcfg, (4, 4, 4), "cpu")
    state = ttrainer.init_state(0, unet, imnet, tmake_opt(tcfg))
    ckpt = tmp_path / "ckpt"
    TManager(str(ckpt)).save(3, state, {"config": tcfg.to_dict()})
    payload = torch.load(ckpt / "ckpt_3.pt", weights_only=True)
    payload["extra"]["config"]["model"]["unet_nf"] = 8
    torch.save(payload, ckpt / "ckpt_3.pt")
    cli = _cli("rb2d", "evaluation_torch")
    with pytest.raises(ValueError, match=r"shapes do not match the model: "
                                         r"\['unet\."):
        cli.main(["--ckpt", str(ckpt), "--device", "cpu"])
    # A parameter missing from the file is named as well.
    del payload["params"]["imnet.fc0.weight"]
    with pytest.raises(ValueError, match=r"parameters do not match the "
                                         r"model: \['imnet\.fc0\.weight"):
        load_models(payload, unet, imnet)


@pytest.mark.parametrize("kind", ["unet3d_group", "unet3d_batch", "unet4d"])
def test_sharded_encoder_names_load_into_eval(tmp_path, kind):
    """The sharded encoders (mesh None: one shard) have the plain modules'
    parameter and buffer names, so a checkpoint of either loads into the
    eval's plain models."""
    if kind == "unet4d":
        kw = dict(in_features=4, out_features=4, igres=(2, 4, 4, 4), nf=2,
                  mf=4)
        sharded, plain = ShardedUNet4d(**kw), TUNet4d(**kw)
        imnets = [ttrainer.ImNet(4, 4, 4, 2) for _ in range(2)]
    else:
        kw = dict(in_features=4, out_features=8, igres=(4, 4, 8), nf=4,
                  mf=16, norm=kind.split("_")[1])
        sharded, plain = ShardedUNet3d(**kw), TUNet3d(**kw)
        imnets = [ttrainer.ImNet(3, 8, 4, 4) for _ in range(2)]
    assert [k for k, _ in sharded.named_parameters()] == \
        [k for k, _ in plain.named_parameters()]
    assert [k for k, _ in sharded.named_buffers()] == \
        [k for k, _ in plain.named_buffers()]
    gen = torch.Generator().manual_seed(1)
    ttrainer.flax_init_(sharded, gen)
    with torch.no_grad():
        for b in sharded.buffers():
            b.add_(3)
    state = ttrainer.TrainState(step=5, unet=sharded, imnet=imnets[0],
                                opt_state={"mu": {}, "nu": {}},
                                generator=gen)
    TManager(str(tmp_path)).save(5, state)
    assert load_models(latest_checkpoint(str(tmp_path)), plain,
                       imnets[1])[0] == 5
    for (k, a), (_, b) in zip(sharded.state_dict().items(),
                              plain.state_dict().items()):
        assert torch.equal(a, b), k
