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


# ------------------------------------------- the optimizer's device state

def _dyadic(rng, shape, scale):
    """Gradients whose squares sum exactly in f32 (multiples of 1/8), so
    that both global norms agree whatever their summation order."""
    return (rng.randint(-16, 17, size=shape) / 8 * scale).astype(np.float32)


def _grad_sequence():
    """A NaN step, a norm exactly at the clip (1.0: scaled by 1), clip
    triggers, 103 consecutive non-finite steps (optax gives up after
    100), then finite steps again."""
    rng = np.random.RandomState(4)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    seq = [{k: _dyadic(rng, s, 4.0 if i % 3 == 0 else 1 / 16)
            for k, s in shapes.items()} for i in range(6)]
    at_clip = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    at_clip["c"][0] = 0.5                               # norm 1 exactly
    nan = {k: v.copy() for k, v in seq[1].items()}
    nan["b"][2] = np.nan
    inf = {k: v.copy() for k, v in seq[2].items()}
    inf["a"][1, 1] = np.inf
    p0 = {k: _dyadic(rng, s, 1.0) for k, s in shapes.items()}
    return p0, seq[:2] + [nan, at_clip] + seq[2:4] + [inf] * 103 + seq[4:]


@pytest.mark.parametrize("decay", [None, 40])
def test_device_optimizer_matches_optax_sequence(decay):
    """The device-state optimizer against optax over ``_grad_sequence``:
    parameters and moments at the existing optax test's tolerance; every
    counter equal at every step, held as 0-d device tensors (int32, and
    bool for ``last_finite``); a skipped step leaves the parameters and
    moments bit for bit."""
    p0, seq = _grad_sequence()
    tx = _optax_tx(3e-2, decay, 1.0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    update = jax.jit(tx.update)         # as the JAX trainer runs it
    opt = ttrain.Optimizer(lr=3e-2, decay_steps=decay, clip=1.0)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = opt.init(tp)
    assert {k: ts[k].dtype for k in ttrain.COUNTERS} == {
        "count": torch.int32, "notfinite_count": torch.int32,
        "last_finite": torch.bool, "total_notfinite": torch.int32}
    applied = []
    for g in seq:
        before = {k: v.clone() for k, v in tp.items()}
        mu = {k: v.clone() for k, v in ts["mu"].items()}
        upd, js = update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        inner = js.inner_state[1][0]
        assert ts["count"].ndim == 0 and ts["count"] == int(inner.count)
        assert ts["notfinite_count"] == int(js.notfinite_count)
        assert ts["total_notfinite"] == int(js.total_notfinite)
        assert bool(ts["last_finite"]) == bool(js.last_finite)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(ts["mu"][k].numpy(),
                                       np.asarray(inner.mu[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        finite = all(np.isfinite(v).all() for v in g.values())
        gave_up = int(js.notfinite_count) > 100
        applied.append(finite or gave_up)
        if not (finite or gave_up):
            assert all(torch.equal(tp[k], before[k]) for k in tp)
            assert all(torch.equal(ts["mu"][k], mu[k]) for k in mu)
    assert applied.count(False) == 101 and int(ts["total_notfinite"]) == 104
    # Once optax gives up, the inf gradient turns the parameter NaN.
    assert np.isnan(tp["a"].numpy()).any()


def test_bias_corrections_match_xla_pow():
    """``1 - b ** count`` as the jitted JAX step computes it (XLA's f32
    pow), bit for bit, at every count to 399."""
    from space_time_pde_torch.train.optim import (
        _B1_F32, _B2_F32, _decay_power)

    counts = np.arange(1, 400, dtype=np.int32)
    for b, b32 in ((0.9, _B1_F32), (0.999, _B2_F32)):
        want = np.asarray(jax.jit(lambda c: 1 - b ** c)(jnp.asarray(counts)))
        got = np.array([float(1 - _decay_power(b32, torch.tensor(c)))
                        for c in counts], np.float32)
        np.testing.assert_array_equal(got, want)


def _host_decided_step(opt, params, grads, state):
    """The optimizer with its decisions taken on the host, branch by
    branch (``bool()`` of the finiteness and of the clip, an early
    return on a skipped step): the device selects must equal it bit for
    bit."""
    from space_time_pde_torch.train.optim import (
        _B1_F32, _B2_F32, _decay_power)

    norm = ttrain.global_norm(grads.values())
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    bad = 0 if finite else int(state["notfinite_count"]) + 1
    state["notfinite_count"] = bad
    state["total_notfinite"] = int(state["total_notfinite"]) + (not finite)
    if not finite and bad <= 100:
        return
    lr = opt.learning_rate(int(state["count"]))
    count = torch.tensor(int(state["count"]) + 1)
    bc1 = 1 - _decay_power(_B1_F32, count)
    bc2 = 1 - _decay_power(_B2_F32, count)
    clipping = not bool(norm < opt.clip)
    for k, p in params.items():
        g = (grads[k] / norm) * opt.clip if clipping else grads[k]
        mu, nu = state["mu"][k], state["nu"][k]
        mu.copy_((1 - 0.9) * g + 0.9 * mu)
        nu.copy_((1 - 0.999) * (g * g) + 0.999 * nu)
        p.add_((mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8) * -lr)
    state["count"] = int(count)


@pytest.mark.parametrize("decay", [None, 40])
def test_device_selects_equal_host_decisions(decay):
    p0, seq = _grad_sequence()
    opt = ttrain.Optimizer(lr=3e-2, decay_steps=decay, clip=1.0)
    dev = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    host = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ds, hs = opt.init(dev), opt.init(host)
    for g in seq:
        g = {k: torch.from_numpy(v) for k, v in g.items()}
        opt.step(dev, g, ds)
        _host_decided_step(opt, host, g, hs)
        for k in p0:
            for a, b in ((dev[k], host[k]), (ds["mu"][k], hs["mu"][k]),
                         (ds["nu"][k], hs["nu"][k])):
                assert torch.equal(a, b) or (
                    torch.isnan(a).equal(torch.isnan(b))
                    and torch.equal(a.nan_to_num(), b.nan_to_num())), k
        for k in ("count", "notfinite_count", "total_notfinite"):
            assert int(ds[k]) == int(hs[k]), k


def test_optimizer_step_reads_nothing_on_the_host(monkeypatch):
    """No ``bool()``, ``item()``, ``float()``, ``int()`` of a tensor and
    no tensor made from host numbers inside ``Optimizer.step`` or the
    schedule read at the state's count: a CUDA graph holds it."""
    opt = ttrain.Optimizer(lr=1e-2, decay_steps=10, clip=1.0)
    params = {"a": torch.ones(4), "b": torch.zeros(2, 3)}
    state = opt.init(params)
    grads = {k: torch.full_like(v, 0.5) for k, v in params.items()}
    grads["b"][0, 0] = float("nan")

    def refuse(*a, **k):
        raise AssertionError("host read or host-built tensor in the step")

    for name in ("__bool__", "item", "__float__", "__int__", "tolist",
                 "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    for g in (grads, {k: torch.full_like(v, 0.5) for k, v in
                      params.items()}):
        opt.step(params, g, state)
        opt.learning_rate(state["count"])
    monkeypatch.undo()
    assert int(state["count"]) == 1 and int(state["total_notfinite"]) == 1


# ------------------------------------ the step built for capture, eagerly

def _family_state(family, seed=0):
    """(state, loss over its modules, optimizer, batches) for a tiny rb2d
    or turb3d model; batch 1 holds a NaN in its input (every gradient of
    its step is NaN: the step is skipped)."""
    cfg = _cfg()
    if family == "turb3d":
        cfg.model.lat_dims, cfg.model.unet_mf = 6, 8
        cfg.physics.pde_system = "ns3d"
    tcfg = TConfig.from_dict(cfg.to_dict())
    igres = IGRES if family == "rb2d" else (4, 4, 4, 4)
    unet, imnet = ttrain.build_models(tcfg, igres, "cpu")
    opt = ttrain.make_optimizer(tcfg)
    state = ttrain.init_state(seed, unet, imnet, opt)
    rng = np.random.RandomState(3)
    mean, std = rng.randn(4), 0.5 + rng.rand(4)
    if family == "rb2d":
        pde = _pde(tphys, mean, std)
    else:
        pde = tphys.get_pde_layer("ns3d", mean=mean, std=std, t_crop=0.7,
                                  z_crop=2.0, y_crop=2.5, x_crop=3.0,
                                  viscosity=1e-2)
    loss_fn = ttrain.make_loss_fn(tcfg, state.unet, state.imnet, pde)
    dim = len(igres)
    batches = []
    for i in range(6):
        r = np.random.RandomState(20 + i)
        b = {"lres": r.randn(2, *igres, 4).astype(np.float32),
             "point_coord": r.rand(2, 16, dim).astype(np.float32),
             "point_value": r.randn(2, 16, 4).astype(np.float32)}
        if i == 1:
            b["lres"][0, 0, 1, 1, 2] = np.nan
        batches.append(b)
    return state, opt, loss_fn, batches


def _group(batches, n_inner):
    if n_inner == 1:
        return batches
    return [{k: np.stack([b[k] for b in batches[i:i + n_inner]])
             for k in batches[0]}
            for i in range(0, len(batches), n_inner)]


class _HostDecided:
    """``opt`` with its decisions taken on the host
    (:func:`_host_decided_step`): the step as it ran before the
    optimizer's state moved to the device."""

    def __init__(self, opt):
        self.opt = opt

    @torch.no_grad()
    def step(self, params, grads, state):
        _host_decided_step(self.opt, params, grads, state)
        return ttrain.global_norm(grads.values())


@pytest.mark.parametrize("family,n_inner", [("rb2d", 1), ("rb2d", 3),
                                            ("turb3d", 1), ("turb3d", 3)])
def test_captured_form_run_eagerly_equals_eager_step(family, n_inner):
    """The steps that :class:`CapturedStep` captures on a card (the
    optimizer's decisions device-side selects), run eagerly on the CPU,
    against the same steps with those decisions taken on the host:
    parameters, Adam moments, counters and the last metrics, bit for
    bit, over 3 steps a side (n_inner 3: two dispatches), one of them
    skipped (a NaN in its batch). ``CapturedStep`` itself refuses the
    CPU, which has no graphs."""
    state, opt, loss_fn, batches = _family_state(family)
    twin, _, twin_loss, _ = _family_state(family)
    steps = 3 if n_inner == 1 else 6
    groups = [{k: torch.from_numpy(v) for k, v in g.items()}
              for g in _group(batches[:steps], n_inner)]
    host = _HostDecided(opt)
    step, host_step = (
        (ttrain.make_train_step(loss_fn, opt),
         ttrain.make_train_step(twin_loss, host)) if n_inner == 1 else
        (ttrain.make_multi_step(loss_fn, opt, n_inner),
         ttrain.make_multi_step(twin_loss, host, n_inner)))
    for g in groups:
        state, got = step(state, g)
        twin, want = host_step(twin, g)
    assert state.step == twin.step == steps
    assert int(state.opt_state["total_notfinite"]) == 1
    assert int(state.opt_state["count"]) == steps - 1
    for k, v in _params(state).items():
        assert torch.equal(v, _params(twin)[k]), k
    for m in ("mu", "nu"):
        for k, v in state.opt_state[m].items():
            assert torch.equal(v, twin.opt_state[m][k]), (m, k)
    for k in ("count", "notfinite_count", "total_notfinite"):
        assert int(state.opt_state[k]) == int(twin.opt_state[k]), k
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="CUDA"):
        ttrain.CapturedStep(loss_fn, opt, n_inner, "cpu")


def test_tensor_counters_round_trip(tmp_path):
    """Checkpoints and exports keep the counters as Python numbers and
    restore them into the state's own tensors, in place."""
    from space_time_pde_torch.bridge import load_exported, save_exported
    from space_time_pde_torch.train.optim import (
        counter_values, set_counters)

    state, opt, _ = _tiny_state()
    want = {"count": 5, "notfinite_count": 2, "last_finite": False,
            "total_notfinite": 3}
    set_counters(state.opt_state, want)
    mngr = CheckpointManager(str(tmp_path / "ckpt"), keep=1)
    mngr.save(5, state)
    saved = torch.load(mngr._path(5), weights_only=True)["opt_state"]
    assert {k: saved[k] for k in want} == want
    assert type(saved["count"]) is int and \
        type(saved["last_finite"]) is bool
    fresh, _, _ = _tiny_state(seed=1)
    tensors = {k: fresh.opt_state[k] for k in want}
    CheckpointManager(str(tmp_path / "ckpt")).restore(fresh)
    assert counter_values(fresh.opt_state) == want
    assert all(fresh.opt_state[k] is tensors[k] for k in want)

    cfg = _cfg()
    zeros = {"mu": {"a": np.zeros(2, np.float32)},
             "nu": {"a": np.zeros(2, np.float32)}}
    path = str(tmp_path / "w.npz")
    save_exported(path, {"unet": {"a": np.zeros(2, np.float32)}}, None,
                  cfg.to_dict(), np.zeros(4), np.ones(4), 5,
                  opt_state=dict(zeros, **{k: state.opt_state[k]
                                           for k in want}))
    back = load_exported(path)["opt_state"]
    assert {k: back[k] for k in want} == want
    set_counters(fresh.opt_state, dict(want, count=9))
    assert int(fresh.opt_state["count"]) == 9
