"""BatchNorm's train mode in the port (``models/unet3d.py::BatchNorm``,
``train/trainer.py``) against flax and the JAX trainer, at a small size.

- the layer against ``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)``
  in train mode (output and the new ``batch_stats``) and in eval mode,
  rtol 1e-5 / atol 1e-6 (f32 both; the sums run in other orders);
- a tiny ``norm="batch"`` UNet3d in train mode against flax with
  ``mutable=["batch_stats"]``: the latent grid and every new running
  statistic;
- one ``norm="batch"`` training step against the JAX step: loss, every
  gradient leaf (the jet tolerances of ``tests/test_fused_jet.py``, rtol
  3e-4 / atol 5e-3 relative to the leaf's largest magnitude, plus 1e-6
  of the largest gradient for the biases before a norm) and the new
  statistics; a step that ``apply_if_finite`` skips keeps the new
  statistics in both packages and leaves the parameters alone;
- port checkpoints carry the running statistics: a resumed run is
  step-exact.
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from space_time_pde_torch import physics as tphys
from space_time_pde_torch import train as ttrain
from space_time_pde_torch.bridge import (
    flatten_tree, load_flax_params, state_dict_from_flax)
from space_time_pde_torch.models.unet3d import BatchNorm, UNet3d
from space_time_pde_torch.utils.checkpoint import CheckpointManager
from space_time_pde_torch.utils.config import Config as TConfig
from space_time_pde_tpu import physics as jphys
from space_time_pde_tpu.models import UNet3d as JUNet3d
from space_time_pde_tpu.train import build_models as jbuild
from space_time_pde_tpu.train import init_state as jinit
from space_time_pde_tpu.train import make_loss_fn as jloss
from space_time_pde_tpu.train import make_train_step as jstep
from space_time_pde_tpu.train.trainer import make_optimizer as jopt
from space_time_pde_tpu.utils.config import Config

IGRES = (4, 8, 8)


def _stats_sd(module, batch_stats):
    """{"<layer>.running_mean" | ".running_var": array} of a flax
    ``batch_stats`` tree, in the port's names."""
    out = {}
    for k, v in flatten_tree(batch_stats).items():
        layer, leaf = k.rsplit("/", 1)
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
        out[f"{layer.replace('/', '.')}.{name}"] = np.asarray(v)
    return out


def _assert_stats(module, batch_stats, rtol=1e-5, atol=1e-6):
    want = _stats_sd(module, batch_stats)
    got = {k: b.detach().numpy() for k, b in module.named_buffers()
           if k.endswith(("running_mean", "running_var"))}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("shape", [(2, 4, 3, 5, 6), (3, 8, 4, 4, 2)])
def test_batchnorm_layer_matches_flax(shape):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 2.0 + 0.7).astype(np.float32)
    ch = shape[-1]
    scale = (1 + 0.1 * rng.randn(ch)).astype(np.float32)
    bias = (0.1 * rng.randn(ch)).astype(np.float32)
    stats = {"mean": (0.1 * rng.randn(ch)).astype(np.float32),
             "var": (1 + 0.1 * rng.rand(ch)).astype(np.float32)}
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": stats}
    flax_bn = lambda train: fnn.BatchNorm(use_running_average=not train,
                                          momentum=0.9, epsilon=1e-5)
    want, upd = flax_bn(True).apply(variables, jnp.asarray(x),
                                    mutable=["batch_stats"])
    want_eval = flax_bn(False).apply(variables, jnp.asarray(x))

    bn = BatchNorm(ch)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    bn.eval()
    np.testing.assert_allclose(np.moveaxis(bn(xt).detach().numpy(), 1, -1),
                               np.asarray(want_eval), rtol=1e-5, atol=1e-6)
    bn.train()
    got = np.moveaxis(bn(xt).detach().numpy(), 1, -1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    new = upd["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new["mean"]), rtol=1e-5, atol=1e-7)
    # The biased variance (torch's own update would use the unbiased).
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new["var"]), rtol=1e-5, atol=1e-7)


def test_batchnorm_unet3d_train_mode_matches_flax():
    rng = np.random.RandomState(1)
    x = rng.randn(3, *IGRES, 4).astype(np.float32)
    junet = JUNet3d(in_features=4, out_features=8, igres=IGRES, nf=4,
                    norm="batch")
    v = junet.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, upd = junet.apply(v, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    tunet = UNet3d(in_features=4, out_features=8, igres=IGRES, nf=4,
                   norm="batch")
    load_flax_params(tunet, jax.tree.map(np.asarray, v["params"]),
                     jax.tree.map(np.asarray, v["batch_stats"]))
    tunet.train()
    got = tunet(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    _assert_stats(tunet, upd["batch_stats"], rtol=1e-4, atol=1e-5)


def _cfg():
    cfg = Config()
    cfg.model.lat_dims, cfg.model.unet_nf, cfg.model.imnet_nf = 8, 4, 2
    cfg.model.norm = "batch"
    cfg.train.alpha_pde = 0.1
    cfg.train.reg_loss_type, cfg.train.pde_loss_type = "l1", "huber"
    return cfg


def _batch(seed=0, b=3, n=32):
    rng = np.random.RandomState(seed)
    return {"lres": rng.randn(b, *IGRES, 4).astype(np.float32),
            "point_coord": rng.rand(b, n, 3).astype(np.float32),
            "point_value": rng.randn(b, n, 4).astype(np.float32)}


def _pde(pkg):
    rng = np.random.RandomState(2)
    return pkg.get_rb2_pde_layer(mean=rng.randn(4), std=0.5 + rng.rand(4),
                                 t_crop=0.75, z_crop=0.5, x_crop=0.5,
                                 rayleigh=1e4)


def _both_states(cfg):
    """(JAX state, JAX step, port state, port step) from the same flax
    init, with the same optimizer."""
    junet, jimnet = jbuild(cfg, IGRES)
    tx = jopt(cfg, 10)
    js = jinit(jax.random.PRNGKey(0), cfg, junet, jimnet, tx)
    jstep_fn = jstep(jloss(cfg, junet, jimnet, _pde(jphys)), tx, jit=False)
    tcfg = TConfig.from_dict(cfg.to_dict())
    tunet, timnet = ttrain.build_models(tcfg, IGRES, "cpu")
    opt = ttrain.make_optimizer(tcfg, 10)
    ts = ttrain.init_state(0, tunet, timnet, opt)
    params = jax.tree.map(np.asarray, js.params)
    load_flax_params(tunet, params["unet"],
                     jax.tree.map(np.asarray, js.batch_stats))
    load_flax_params(timnet, params["imnet"])
    tstep = ttrain.make_train_step(
        ttrain.make_loss_fn(tcfg, tunet, timnet, _pde(tphys)), opt)
    return js, jstep_fn, ts, tstep


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_batchnorm_step_matches_jax():
    cfg = _cfg()
    js, jstep_fn, ts, tstep = _both_states(cfg)
    batch = _batch()
    (_, wm), grads = jax.value_and_grad(
        jloss(cfg, *jbuild(cfg, IGRES), _pde(jphys)), has_aux=True)(
            js.params, {k: jnp.asarray(v) for k, v in batch.items()},
            js.batch_stats)
    ts, gm = tstep(ts, _tensors(batch))
    for k in ("loss", "reg_loss", "pde_loss"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-4,
                                   err_msg=k)
    g_np = jax.tree.map(np.asarray, grads)
    # Biases right before a norm have a true gradient of 0 (rounding
    # noise on both sides): their atol also carries 1e-6 of the model's
    # largest gradient, as in tests/test_torch_trainer.py.
    top = max(float(np.abs(g).max()) for g in jax.tree.leaves(g_np))
    for name, module in (("unet", ts.unet), ("imnet", ts.imnet)):
        want_g = state_dict_from_flax(module, g_np[name], buffers=False)
        for k, p in module.named_parameters():
            w = want_g[k].numpy()
            np.testing.assert_allclose(
                p.grad.numpy(), w, rtol=3e-4,
                atol=5e-3 * float(np.abs(w).max()) + 1e-6 * top,
                err_msg=f"{name}.{k}")
    _assert_stats(ts.unet, wm["_batch_stats"], rtol=1e-4, atol=1e-6)
    # The step leaves the encoder in train mode; the eval function puts
    # it in eval mode (running statistics).
    assert ts.unet.training
    tcfg = TConfig.from_dict(cfg.to_dict())
    ttrain.make_eval_fn(tcfg, ts.unet, ts.imnet)(_tensors(_batch(seed=5)))
    assert not ts.unet.training


def test_skipped_step_keeps_new_stats():
    """An infinite target under the l2 loss makes the gradients
    non-finite: apply_if_finite skips the update in both packages, and
    both keep the step's new running statistics."""
    cfg = _cfg()
    cfg.train.reg_loss_type = "l2"
    js, jstep_fn, ts, tstep = _both_states(cfg)
    batch = _batch()
    batch["point_value"][0, 0, 0] = np.inf
    before = {k: p.detach().clone() for k, p in ts.params().items()}
    js2, _ = jstep_fn(js, {k: jnp.asarray(v) for k, v in batch.items()})
    ts, _ = tstep(ts, _tensors(batch))
    assert int(js2.opt_state.notfinite_count) == 1
    assert ts.opt_state["notfinite_count"] == 1
    assert ts.opt_state["count"] == 0
    for k, p in ts.params().items():
        assert torch.equal(p.detach(), before[k]), k
    assert not np.array_equal(
        np.asarray(js2.batch_stats["down_res0"]["norm1"]["mean"]),
        np.asarray(js.batch_stats["down_res0"]["norm1"]["mean"]))
    _assert_stats(ts.unet, js2.batch_stats, rtol=1e-4, atol=1e-6)


def test_checkpoint_round_trips_running_stats(tmp_path):
    cfg = _cfg()
    tcfg = TConfig.from_dict(cfg.to_dict())
    _, _, state, step = _both_states(cfg)
    batches = [_tensors(_batch(seed=10 + i)) for i in range(4)]
    for b in batches[:2]:
        state, _ = step(state, b)
    mngr = CheckpointManager(str(tmp_path / "ckpt"))
    mngr.save(state.step, state, extra={"epoch": 1})
    saved = {k: b.clone() for k, b in state.buffers().items()}
    assert any(k.endswith("running_var") for k in saved)
    twin = copy.deepcopy(state)
    for b in batches[2:]:
        state, _ = step(state, b)

    fresh_unet, fresh_imnet = ttrain.build_models(tcfg, IGRES, "cpu")
    opt = ttrain.make_optimizer(tcfg, 10)
    fresh = ttrain.init_state(3, fresh_unet, fresh_imnet, opt)
    fresh, _ = mngr.restore(fresh)
    for k, b in fresh.buffers().items():
        assert torch.equal(b, saved[k]), k
    for k, b in twin.buffers().items():
        assert torch.equal(b, saved[k]), k
    step2 = ttrain.make_train_step(
        ttrain.make_loss_fn(tcfg, fresh.unet, fresh.imnet, _pde(tphys)), opt)
    for b in batches[2:]:
        fresh, _ = step2(fresh, b)
    for k, p in state.params().items():
        assert torch.equal(p.detach(), fresh.params()[k].detach()), k
    for k, b in state.buffers().items():
        assert torch.equal(b, fresh.buffers()[k]), k
