"""The port's training engine (``train/``, ``utils/checkpoint.py``) vs
the JAX package, at a small size.

- loss and gradients against JAX ``make_loss_fn`` (its jnp jet on the
  CPU) on the same batch and bridged weights, for each of the port's
  derivative modes: loss rtol 1e-4, gradients rtol 3e-4 with atol 3e-4
  of the leaf's largest magnitude (f32; the port sums in other orders)
  plus 1e-6 of the model's largest gradient;
- the optimizer against optax over 5 steps: a clip trigger, a
  non-finite step, the cosine count, and the give-up after too many
  non-finite steps (rtol 1e-5 / atol 1e-6: the same f32 formulas; the
  global norm sums in another order, and Adam carries its last-ulp
  differences from step to step);
- initial weights against flax's initialisers (per-layer std within 5%);
- multi-step equals sequential steps; checkpoint round trip, step-exact.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from space_time_pde_torch import physics as tphys
from space_time_pde_torch import train as ttrain
from space_time_pde_torch.bridge import load_flax_params, \
    state_dict_from_flax
from space_time_pde_torch.utils.checkpoint import CheckpointManager
from space_time_pde_torch.utils.config import Config as TConfig
from space_time_pde_tpu import physics as jphys
from space_time_pde_tpu.train import build_models as jbuild
from space_time_pde_tpu.train import make_loss_fn as jloss
from space_time_pde_tpu.train.trainer import make_optimizer as jopt
from space_time_pde_tpu.utils.config import Config

IGRES = (4, 8, 8)


def _cfg(reg="l1", pde="huber"):
    cfg = Config()
    cfg.model.lat_dims, cfg.model.unet_nf, cfg.model.imnet_nf = 8, 4, 2
    cfg.train.alpha_pde = 0.1
    cfg.train.reg_loss_type, cfg.train.pde_loss_type = reg, pde
    return cfg


def _batch(seed=0, b=2, n=32):
    rng = np.random.RandomState(seed)
    return {"lres": rng.randn(b, *IGRES, 4).astype(np.float32),
            "point_coord": rng.rand(b, n, 3).astype(np.float32),
            "point_value": rng.randn(b, n, 4).astype(np.float32)}


def _pde(pkg, mean, std):
    return pkg.get_rb2_pde_layer(mean=mean, std=std, t_crop=0.75,
                                 z_crop=0.5, x_crop=0.5, rayleigh=1e4)


def _jax_params(cfg, seed=0):
    unet, imnet = jbuild(cfg, IGRES)
    return unet, imnet, {
        "unet": unet.init(jax.random.PRNGKey(seed),
                          jnp.zeros((1, *IGRES, 4)))["params"],
        "imnet": imnet.init(jax.random.PRNGKey(seed + 1),
                            jnp.zeros((1, 11)))["params"]}


@pytest.mark.parametrize("derivs,reg,pde", [
    ("jet", "l1", "huber"), ("jet", "l2", "l2"), ("jet_jnp", "huber", "l2"),
    ("tower", "l1", "huber")])
def test_loss_and_grads_match_jax(derivs, reg, pde):
    cfg = _cfg(reg, pde)
    rng = np.random.RandomState(1)
    mean, std = rng.randn(4), 0.5 + rng.rand(4)
    unet, imnet, params = _jax_params(cfg)
    batch = _batch()
    (want, wm), grads = jax.value_and_grad(
        jloss(cfg, unet, imnet, _pde(jphys, mean, std)), has_aux=True)(
            params, {k: jnp.asarray(v) for k, v in batch.items()})

    tcfg = TConfig.from_dict(cfg.to_dict())
    tcfg.train.pde_derivs = derivs
    tunet, timnet = ttrain.build_models(tcfg, IGRES, "cpu")
    load_flax_params(tunet, params["unet"])
    load_flax_params(timnet, params["imnet"])
    loss_fn = ttrain.make_loss_fn(tcfg, tunet, timnet,
                                  _pde(tphys, mean, std))
    got, gm = loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    for k in ("reg_loss", "pde_loss", "pde/continuity"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-4,
                                   err_msg=k)
    g_np = jax.tree.map(np.asarray, grads)
    # Biases right before a GroupNorm have a true gradient of 0 (rounding
    # noise on both sides): their atol also carries 1e-6 of the model's
    # largest gradient.
    top = max(float(np.abs(g).max()) for g in jax.tree.leaves(g_np))
    for name, module in (("unet", tunet), ("imnet", timnet)):
        want_g = state_dict_from_flax(module, g_np[name])
        for k, p in module.named_parameters():
            w = want_g[k].numpy()
            np.testing.assert_allclose(
                p.grad.numpy(), w, rtol=3e-4,
                atol=3e-4 * float(np.abs(w).max()) + 1e-6 * top,
                err_msg=f"{name}.{k}")


def _optax_tx(lr, decay, clip):
    sched = optax.cosine_decay_schedule(lr, decay) if decay else lr
    return optax.apply_if_finite(
        optax.chain(optax.clip_by_global_norm(clip), optax.adam(sched)),
        max_consecutive_errors=100)


@pytest.mark.parametrize("decay", [None, 4])
def test_optimizer_matches_optax(decay):
    """5 steps: small grads, a clip trigger, a NaN step (skipped: no
    parameter or schedule-count change), then more; with a cosine
    schedule shorter than the run (the count saturates)."""
    rng = np.random.RandomState(2)
    p0 = {"a": rng.randn(3, 4).astype(np.float32),
          "b": rng.randn(5).astype(np.float32)}
    scales = [0.1, 50.0, None, 0.3, 2.0]
    grads_seq = []
    for s in scales:
        g = {k: (rng.randn(*v.shape) * (s or 1)).astype(np.float32)
             for k, v in p0.items()}
        if s is None:
            g["b"][1] = np.nan
        grads_seq.append(g)

    tx = _optax_tx(3e-2, decay, 1.0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    opt = ttrain.Optimizer(lr=3e-2, decay_steps=decay, clip=1.0)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = opt.init(tp)
    for g in grads_seq:
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
        jp = optax.apply_updates(jp, upd)
        norm = opt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                        ts)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            {k: jnp.asarray(v) for k, v in g.items()})), rtol=1e-6)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        inner = js.inner_state[1][0]
        assert ts["count"] == int(inner.count)
        assert ts["notfinite_count"] == int(js.notfinite_count)
        assert ts["total_notfinite"] == int(js.total_notfinite)
    assert ts["count"] == 4 and ts["total_notfinite"] == 1


def test_optimizer_gives_up_after_max_consecutive_errors():
    """After more than 100 non-finite steps in a row, optax applies the
    update anyway (the run then diverges and the driver stops it); so
    does the port."""
    p0 = {"a": np.ones(3, np.float32)}
    bad = {"a": np.array([np.inf, 1.0, 1.0], np.float32)}
    tx = _optax_tx(1e-2, None, 1.0)
    jp = {"a": jnp.asarray(p0["a"])}
    js = tx.init(jp)
    opt = ttrain.Optimizer(lr=1e-2, clip=1.0)
    tp = {"a": torch.from_numpy(p0["a"].copy())}
    ts = opt.init(tp)
    for _ in range(101):
        upd, js = tx.update({"a": jnp.asarray(bad["a"])}, js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, {"a": torch.from_numpy(bad["a"])}, ts)
        np.testing.assert_array_equal(np.isnan(tp["a"].numpy()),
                                      np.isnan(np.asarray(jp["a"])))
    # The clip divides by an infinite norm: the inf entry turns NaN.
    assert np.isnan(tp["a"].numpy()).tolist() == [True, False, False]
    assert ts["count"] == 1 and ts["notfinite_count"] == 101


def test_make_optimizer_matches_jax_schedule():
    cfg = _cfg()
    cfg.train.lr_schedule, cfg.train.epochs, cfg.train.lr = "cosine", 3, 0.1
    opt = ttrain.make_optimizer(TConfig.from_dict(cfg.to_dict()),
                                steps_per_epoch=5, lr_scale=0.5)
    assert opt.decay_steps == 15 and opt.clip == cfg.train.clip_grad
    sched = optax.cosine_decay_schedule(0.05, 15)
    for c in (0, 1, 7, 15, 20):
        np.testing.assert_allclose(float(opt.learning_rate(c)),
                                   float(sched(c)), rtol=1e-6, atol=1e-9)
    assert jopt(cfg, 5) is not None


def test_init_statistics_match_flax():
    """Every kernel's std within 5% of flax's init (layers of >= 2,000
    weights, where the sample std is that precise), biases 0, GroupNorm
    scales 1 and offsets 0."""
    cfg = _cfg()
    cfg.model.lat_dims, cfg.model.unet_nf, cfg.model.imnet_nf = 32, 16, 16
    igres = (4, 16, 16)
    junet, jimnet = jbuild(cfg, igres)
    jp = {"unet": junet.init(jax.random.PRNGKey(0),
                             jnp.zeros((1, *igres, 4)))["params"],
          "imnet": jimnet.init(jax.random.PRNGKey(1),
                               jnp.zeros((1, 35)))["params"]}
    tcfg = TConfig.from_dict(cfg.to_dict())
    tunet, timnet = ttrain.build_models(tcfg, igres, "cpu")
    ttrain.init_state(0, tunet, timnet, ttrain.make_optimizer(tcfg))
    checked = 0
    for name, module in (("unet", tunet), ("imnet", timnet)):
        flax_sd = state_dict_from_flax(module, jax.tree.map(np.asarray,
                                                            jp[name]))
        for k, p in module.named_parameters():
            got, want = p.detach().numpy(), flax_sd[k].numpy()
            if "norm" in k:
                np.testing.assert_array_equal(got, want, err_msg=k)
            elif k.endswith("bias"):
                assert not got.any(), k
            elif got.size >= 2000:
                assert abs(got.std() / want.std() - 1) < 0.05, k
                assert abs(got.mean()) < 0.1 * got.std(), k
                checked += 1
    assert checked >= 10


def _tiny_state(seed=0):
    """(state, optimizer, loss over the state's own modules)."""
    tcfg = TConfig.from_dict(_cfg().to_dict())
    tunet, timnet = ttrain.build_models(tcfg, IGRES, "cpu")
    opt = ttrain.make_optimizer(tcfg)
    state = ttrain.init_state(seed, tunet, timnet, opt)
    return state, opt, _loss_over(state)


def _loss_over(state):
    tcfg = TConfig.from_dict(_cfg().to_dict())
    rng = np.random.RandomState(3)
    pde = _pde(tphys, rng.randn(4), 0.5 + rng.rand(4))
    return ttrain.make_loss_fn(tcfg, state.unet, state.imnet, pde)


def _batches(n):
    return [{k: torch.from_numpy(v) for k, v in _batch(seed=10 + i).items()}
            for i in range(n)]


def _params(state):
    return {k: p.detach().clone() for k, p in state.params().items()}


def test_multi_step_equals_sequential():
    state, opt, loss_fn = _tiny_state()
    twin = copy.deepcopy(state)
    batches = _batches(3)
    step = ttrain.make_train_step(loss_fn, opt)
    for b in batches:
        state, last = step(state, b)
    multi = ttrain.make_multi_step(_loss_over(twin), opt, 3)
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    twin, last2 = multi(twin, stacked)
    assert state.step == twin.step == 3
    for k, v in _params(state).items():
        np.testing.assert_array_equal(v.numpy(), _params(twin)[k].numpy(),
                                      err_msg=k)
    for k in last:
        np.testing.assert_array_equal(last[k].numpy(), last2[k].numpy())


def test_checkpoint_round_trip_is_step_exact(tmp_path):
    state, opt, loss_fn = _tiny_state()
    step = ttrain.make_train_step(loss_fn, opt)
    batches = _batches(4)
    for b in batches[:2]:
        state, _ = step(state, b)
    mngr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    extra = {"epoch": 1, "channel_mean": np.arange(4.0),
             "config": {"a": 1}, "best_eval": 0.5}
    mngr.save(state.step, state, extra=extra)
    gen_state = state.generator.get_state()
    for b in batches[2:]:
        state, _ = step(state, b)
    want = _params(state)

    fresh, opt2, loss_fn2 = _tiny_state(seed=7)
    assert not torch.equal(_params(fresh)["imnet.fc0.weight"],
                           want["imnet.fc0.weight"])
    fresh, got_extra = CheckpointManager(str(tmp_path / "ckpt")).restore(
        fresh)
    assert fresh.step == 2 and fresh.opt_state["count"] == 2
    assert torch.equal(fresh.generator.get_state(), gen_state)
    assert got_extra == {"epoch": 1, "channel_mean": [0.0, 1.0, 2.0, 3.0],
                         "config": {"a": 1}, "best_eval": 0.5}
    step2 = ttrain.make_train_step(loss_fn2, opt2)
    for b in batches[2:]:
        fresh, _ = step2(fresh, b)
    assert fresh.step == 4
    for k, v in want.items():
        np.testing.assert_array_equal(_params(fresh)[k].numpy(), v.numpy(),
                                      err_msg=k)
    for s in (4, 6, 8):
        mngr.save(s, state)
    assert mngr.steps() == [6, 8] and mngr.latest_step() == 8
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(fresh)


def test_unported_modes_raise():
    # use_bf16: bf16 modules with f32 parameters; the jet computes in bf16
    # only with pde_bf16 too (tests/test_torch_bf16_jet.py), as JAX's
    # jet_dtype.
    tcfg = TConfig.from_dict(_cfg().to_dict())
    tcfg.model.use_bf16 = True
    for d in (IGRES, (4, 4, 4, 4)):
        unet, imnet = ttrain.build_models(tcfg, d, "cpu")
        assert unet.dtype == imnet.dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for m in (unet, imnet)
                   for p in m.parameters())
        assert all(getattr(m, "dtype", torch.bfloat16) == torch.bfloat16
                   for m in unet.modules())
    ttrain.make_loss_fn(tcfg, unet, imnet, None)
    assert ttrain.jet_compute_dtype(tcfg) == torch.float32
    tcfg.train.pde_bf16 = True
    ttrain.make_loss_fn(tcfg, unet, imnet, None)
    assert ttrain.jet_compute_dtype(tcfg) == torch.bfloat16
    tcfg.model.use_bf16 = False
    assert ttrain.jet_compute_dtype(tcfg) == torch.float32
    tcfg = TConfig.from_dict(_cfg().to_dict())
    tcfg.model.norm = "batch"
    unet, imnet = ttrain.build_models(tcfg, IGRES, "cpu")
    # BatchNorm trains on UNet3d (tests/test_torch_batchnorm.py); UNet4d
    # stays GroupNorm only, as in the reference.
    ttrain.make_loss_fn(tcfg, unet, imnet, None)
    with pytest.raises(ValueError, match="GroupNorm only"):
        ttrain.build_models(tcfg, (4, 4, 4, 4), "cpu")
    tcfg.model.norm, tcfg.train.pde_derivs = "group", "fd"
    with pytest.raises(ValueError, match="pde_derivs"):
        ttrain.make_loss_fn(tcfg, unet, imnet, None)
    assert math.isclose(ttrain.global_norm([torch.ones(4)]).item(), 2.0)
