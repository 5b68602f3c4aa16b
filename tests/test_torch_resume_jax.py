"""A JAX run resumed in the port, at a small size.

A tiny JAX run (three steps, the last one skipped by
``optax.apply_if_finite``, so the counters are not at their defaults) is
saved with the JAX ``CheckpointManager`` in a temporary directory, in
both ``opt_state`` layouts: wrapped by ``apply_if_finite``, and the
legacy inner-only one. ``scripts/export_torch_params.py
--with_opt_state`` exports it; the port restores it
(``utils/checkpoint.py::restore_exported``) bit for bit, then takes one
step next to JAX's next step on the same batch (JAX restoring the same
checkpoint with its own manager). The port's optimizer, given JAX's
gradients, lands on JAX's parameters, Adam's ``mu`` and ``nu``, count
and counters at rtol 1e-5 (both f32; the global norm sums in another
order), with an atol of 1e-6 (the parameters, as
``tests/test_torch_trainer.py::test_optimizer_matches_optax``) or 1e-6
of the leaf's largest magnitude (the moments); the port's own step from
the restored state gives JAX's loss (rtol 1e-5), count and counters.
Then both train CLIs accept such an export as ``--resume``.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from space_time_pde_torch import physics as tphys
from space_time_pde_torch import train as ttrain
from space_time_pde_torch.bridge import (
    load_exported, optimizer_state_from_flax, state_dict_from_flax)
from space_time_pde_torch.data import generator as tgen
from space_time_pde_torch.data import save_npz, taylor_green_fields
from space_time_pde_torch.utils.checkpoint import restore_exported
from space_time_pde_torch.utils.config import Config as TConfig
from space_time_pde_tpu import physics as jphys
from space_time_pde_tpu.models import ImNet, UNet4d
from space_time_pde_tpu.train import TrainState
from space_time_pde_tpu.train import build_models as jbuild
from space_time_pde_tpu.train import init_state as jinit
from space_time_pde_tpu.train import make_loss_fn as jloss
from space_time_pde_tpu.train import make_train_step as jstep
from space_time_pde_tpu.train.trainer import make_optimizer as jopt
from space_time_pde_tpu.utils.checkpoint import CheckpointManager as JMngr
from space_time_pde_tpu.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IGRES = (4, 4, 4)
SPE = 4                       # steps per epoch of the runs below


def _load(*parts):
    spec = importlib.util.spec_from_file_location(
        parts[-1][:-3], os.path.join(ROOT, *parts))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg():
    """The rb2d train CLI's tiny flags of ``tests/test_torch_train_cli.py``
    (the l2 loss, so that an infinite target skips a step)."""
    cfg = Config()
    cfg.model.lat_dims, cfg.model.unet_nf, cfg.model.imnet_nf = 8, 4, 2
    d, t = cfg.data, cfg.train
    d.nt, d.nz, d.nx, d.downsamp_t, d.downsamp_xz = 8, 16, 16, 2, 4
    d.n_samp_pts_per_crop = 32
    t.alpha_pde, t.lr, t.lr_schedule, t.epochs = 0.05, 2e-3, "cosine", 3
    t.reg_loss_type, t.pde_loss_type = "l2", "huber"
    t.batch_size_per_gpu, t.pseudo_epoch_size = 2, 8
    cfg.physics.rayleigh = 100.0
    return cfg


def _batch(seed, b=2, n=32):
    rng = np.random.RandomState(seed)
    return {"lres": rng.randn(b, *IGRES, 4).astype(np.float32),
            "point_coord": rng.rand(b, n, 3).astype(np.float32),
            "point_value": rng.randn(b, n, 4).astype(np.float32)}


def _pde(pkg):
    return pkg.get_rb2_pde_layer(mean=np.zeros(4), std=np.ones(4),
                                 t_crop=0.5, z_crop=0.75, x_crop=0.75,
                                 rayleigh=100.0)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jax_run(ckpt_dir, legacy):
    """Three JAX steps (the third skipped) saved at step 3, epoch 0."""
    cfg = _cfg()
    unet, imnet = jbuild(cfg, IGRES)
    tx = jopt(cfg, SPE)
    run_tx = tx
    if legacy:
        # The optimizer before apply_if_finite wrapped it.
        sched = optax.cosine_decay_schedule(cfg.train.lr,
                                            cfg.train.epochs * SPE)
        run_tx = optax.chain(optax.clip_by_global_norm(cfg.train.clip_grad),
                             optax.adam(sched))
    state = jinit(jax.random.PRNGKey(0), cfg, unet, imnet, tx)
    state = state.replace(opt_state=run_tx.init(state.params))
    step = jstep(jloss(cfg, unet, imnet, _pde(jphys)), run_tx)
    for i in range(3):
        batch = _batch(10 + i)
        if i == 2 and not legacy:
            batch["point_value"][0, 0, 0] = np.inf
        state, _ = step(state, _jax(batch))
    mngr = JMngr(ckpt_dir)
    mngr.save(int(state.step), state, extra={
        "config": cfg.to_dict(), "epoch": 0,
        "channel_mean": np.zeros(4, np.float32),
        "channel_std": np.ones(4, np.float32)})
    mngr.close()
    return cfg, unet, imnet, tx


def _export(tmp_path, legacy):
    ckpt = str(tmp_path / "ckpt")
    cfg, unet, imnet, tx = _jax_run(ckpt, legacy)
    out = str(tmp_path / "run.npz")
    _load("scripts", "export_torch_params.py").main([
        "--ckpt", ckpt, "--step", "3", "--out", out, "--with_opt_state",
        "--ref_points", "0"])
    return cfg, unet, imnet, tx, ckpt, out


def _close(got, want, what, atol=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        got, want, rtol=1e-5,
        atol=1e-6 * float(np.abs(want).max()) if atol is None else atol,
        err_msg=what)


@pytest.mark.parametrize("legacy", [False, True])
def test_jax_run_resumes_in_port(tmp_path, legacy):
    cfg, unet, imnet, tx, ckpt, out = _export(tmp_path, legacy)
    # JAX's own resume: the manager with a template (a legacy opt_state
    # migrates, with fresh counters), then its next step.
    mngr = JMngr(ckpt)
    js, _ = mngr.restore(jinit(jax.random.PRNGKey(1), cfg, unet, imnet, tx))
    mngr.close()
    export_mod = _load("scripts", "export_torch_params.py")
    jopt_state, layout = export_mod.optimizer_state(js.opt_state)
    assert layout == "apply_if_finite"       # after the JAX migration
    exported = load_exported(out)
    assert exported["step"] == 3 and exported["meta"]["epoch"] == 0
    want_counters = ((0, True, 0) if legacy else (1, False, 1))
    assert (exported["opt_state"]["notfinite_count"],
            exported["opt_state"]["last_finite"],
            exported["opt_state"]["total_notfinite"]) == want_counters
    assert exported["opt_state"]["count"] == (3 if legacy else 2)

    tcfg = TConfig.from_dict(cfg.to_dict())
    tunet, timnet = ttrain.build_models(tcfg, IGRES, "cpu")
    opt = ttrain.make_optimizer(tcfg, SPE)
    ts = ttrain.init_state(5, tunet, timnet, opt)
    ts, extra = restore_exported(ts, out)
    assert ts.step == 3 and extra["epoch"] == 0
    modules = {"unet": tunet, "imnet": timnet}
    # Restored bit for bit: the parameters and both moments.
    jparams = jax.tree.map(np.asarray, js.params)
    want_mom = optimizer_state_from_flax(jopt_state, modules)
    for name, module in modules.items():
        sd = state_dict_from_flax(module, jparams[name])
        for k, p in module.named_parameters():
            key = f"{name}.{k}"
            assert torch.equal(p.detach(), sd[k]), key
            for m in ("mu", "nu"):
                assert torch.equal(ts.opt_state[m][key], want_mom[m][key]), \
                    (m, key)
    for k in ("count", "notfinite_count", "last_finite", "total_notfinite"):
        assert ts.opt_state[k] == want_mom[k], k

    # JAX's next step; the port's optimizer on the same gradients (the
    # gradients' own parity is tests/test_torch_trainer.py's: Adam would
    # blow the rounding noise of the biases before a norm, whose true
    # gradient is 0, up to steps of the learning rate's size).
    batch = _batch(20)
    loss_fn = jloss(cfg, unet, imnet, _pde(jphys))
    (_, jm), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        js.params, _jax(batch))
    updates, jopt2 = tx.update(grads, js.opt_state, js.params)
    js2 = js.replace(step=js.step + 1, opt_state=jopt2,
                     params=optax.apply_updates(js.params, updates))
    g_np = jax.tree.map(np.asarray, grads)
    port_grads = {f"{name}.{k}": v for name, module in modules.items()
                  for k, v in state_dict_from_flax(module, g_np[name],
                                                   buffers=False).items()}
    with torch.no_grad():
        opt.step(ts.params(), port_grads, ts.opt_state)
    want = optimizer_state_from_flax(
        export_mod.optimizer_state(js2.opt_state)[0], modules)
    jparams2 = jax.tree.map(np.asarray, js2.params)
    for name, module in modules.items():
        sd = state_dict_from_flax(module, jparams2[name])
        for k, p in module.named_parameters():
            key = f"{name}.{k}"
            _close(p.detach().numpy(), sd[k].numpy(), key, atol=1e-6)
            for m in ("mu", "nu"):
                _close(ts.opt_state[m][key].numpy(), want[m][key].numpy(),
                       f"{m} {key}")
    for k in ("count", "notfinite_count", "last_finite", "total_notfinite"):
        assert ts.opt_state[k] == want[k], k

    # The port's own step from the restored state: the same loss and the
    # same count and counters as JAX's next step.
    tunet2, timnet2 = ttrain.build_models(tcfg, IGRES, "cpu")
    ts2, _ = restore_exported(ttrain.init_state(6, tunet2, timnet2, opt), out)
    step = ttrain.make_train_step(
        ttrain.make_loss_fn(tcfg, tunet2, timnet2, _pde(tphys)), opt)
    ts2, metrics = step(ts2, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert ts2.step == int(js2.step) == 4
    for k in ("count", "notfinite_count", "last_finite", "total_notfinite"):
        assert ts2.opt_state[k] == want[k], k


def test_rb2d_cli_resumes_from_export(tmp_path, capsys):
    _, _, _, _, _, out = _export(tmp_path, legacy=False)
    save_npz(str(tmp_path / "tg.npz"),
             taylor_green_fields(nt=10, nz=16, nx=16))
    train_torch = _load("experiments", "rb2d", "train_torch.py")
    flags = ["--device", "cpu", "--data_folder", str(tmp_path),
             "--train_data", "tg.npz", "--eval_data", "tg.npz", "--nt", "8",
             "--nz", "16", "--nx", "16", "--downsamp_t", "2",
             "--downsamp_xz", "4", "--n_samp_pts_per_crop", "32",
             "--lat_dims", "8", "--unet_nf", "4", "--imnet_nf", "2",
             "--pseudo_epoch_size", "8", "--batch_size_per_gpu", "2",
             "--inner_steps", "2", "--alpha_pde", "0.05", "--rayleigh",
             "100", "--lr", "2e-3", "--lr_schedule", "cosine",
             "--reg_loss_type", "l2", "--pde_loss_type", "huber",
             "--log_dir", str(tmp_path / "log"), "--resume", out]
    res = train_torch.main(flags + ["--epochs", "6", "--run_epochs", "1"])
    printed = capsys.readouterr().out
    assert "resumed from step 3 (epoch 1) of the exported JAX run" in printed
    assert "the batches are not" in printed
    assert res["start_epoch"] == 1 and res["step"] == 7
    assert [e["epoch"] for e in res["epochs"]] == [1]
    assert all(np.isfinite(e["loss"]) for e in res["epochs"])
    # A params-only export cannot resume exactly.
    params_only = str(tmp_path / "params.npz")
    _load("scripts", "export_torch_params.py").main([
        "--ckpt", str(tmp_path / "ckpt"), "--step", "3", "--out",
        params_only, "--ref_points", "0"])
    with pytest.raises(ValueError, match="no optimizer state"):
        train_torch.main(flags[:-1] + [params_only, "--epochs", "2"])


def test_turb3d_cli_resumes_from_export(tmp_path, capsys):
    """A JAX turb3d state (UNet4d + ImNet(dim=4), the driver's
    optimizer) saved as its driver saves it, exported by
    ``scripts/export_torch_turb3d.py --with_opt_state``."""
    targs = dict(nt=8, nz=8, ny=8, nx=8, downsamp_t=2, downsamp_xyz=4,
                 lat_dims=4, unet_nf=2, unet_mf=4, imnet_nf=2,
                 viscosity=1e-2)
    igres = (4, 2, 2, 2)
    cfg = Config()
    cfg.train.lr, cfg.train.lr_schedule, cfg.train.epochs = 5e-3, "cosine", 4
    unet = UNet4d(in_features=4, out_features=4, igres=igres, nf=2, mf=4)
    imnet = ImNet(dim=4, in_features=4, out_features=4, nf=2)
    params = {"unet": unet.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, *igres, 4)))["params"],
              "imnet": imnet.init(jax.random.PRNGKey(1),
                                  jnp.zeros((1, 8)))["params"]}
    tx = jopt(cfg, 2)
    grads = jax.tree.map(lambda p: 0.01 * jnp.ones_like(p), params)
    opt_state = tx.init(params)
    for _ in range(2):
        upd, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)
    state = TrainState(step=jnp.asarray(2, jnp.int32), params=params,
                       opt_state=opt_state, key=jax.random.PRNGKey(2))
    ckpt = str(tmp_path / "ckpt")
    mngr = JMngr(ckpt)
    mngr.save(2, state, extra={
        "config": cfg.to_dict(), "epoch": 0, "turb3d_args": targs,
        "channel_mean": np.zeros(4, np.float32),
        "channel_std": np.ones(4, np.float32)})
    mngr.close()
    out = str(tmp_path / "turb3d.npz")
    _load("scripts", "export_torch_turb3d.py").main([
        "--ckpt", ckpt, "--step", "2", "--out", out, "--with_opt_state",
        "--ref_points", "0"])
    for seed in (42, 100):
        tgen.save_npz(str(tmp_path / f"beltrami_s{seed}.npz"),
                      tgen.beltrami_fields(seed, nt=10, n=8))
    train_torch = _load("experiments", "turb3d", "train_torch.py")
    res = train_torch.main([
        "--device", "cpu", "--data_folder", str(tmp_path),
        "--train_data", "beltrami_s42.npz", "--eval_data",
        "beltrami_s100.npz", "--nt", "8", "--nz", "8", "--ny", "8", "--nx",
        "8", "--downsamp_t", "2", "--downsamp_xyz", "4", "--lat_dims", "4",
        "--unet_nf", "2", "--unet_mf", "4", "--imnet_nf", "2",
        "--n_samp_pts_per_crop", "16", "--batch_size_per_gpu", "2",
        "--pseudo_epoch_size", "4", "--inner_steps", "2", "--alpha_pde",
        "0.1", "--lr", "5e-3", "--lr_schedule", "cosine", "--epochs", "2",
        "--log_dir", str(tmp_path / "log"), "--resume", out])
    printed = capsys.readouterr().out
    assert "resumed from step 2 (epoch 1) of the exported JAX run" in printed
    assert res["start_epoch"] == 1 and res["step"] == 4
    assert all(np.isfinite(e["loss"]) for e in res["epochs"])
