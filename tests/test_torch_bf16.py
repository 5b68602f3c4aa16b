"""Port parity under the bf16 compute policy (``use_bf16``): the port's
bf16 paths against the JAX package's on the same inputs and weights.

Inputs are numpy draws from fixed seeds, weights cross through the
bridge. Two frameworks that both accumulate in f32 still round a bf16
product differently now and then (a sum taken in another order lands on
the other side of a bf16 step), so every comparison applies two rules:

- direct: per point ``|port - jax_bf16| <= DIRECT * max|jax_bf16|``,
  DIRECT = 4 * 2^-8 (four bf16 steps of the largest value; no looser than
  JAX's own bf16 decode test, rtol 0.05 / atol 0.02);
- distance: the port's worst distance from the f32 (or float64)
  reference at most SLACK = 1.5 times JAX bf16's own worst distance from
  it.

Gradient leaves hold both rules leaf by leaf, in the form
``test_use_bf16_step_matches_jax`` states.

Under ``jit`` XLA may keep a bf16 result in f32 where an f32 op consumes
it (a conv's output before a norm), so a jitted JAX bf16 model rounds
at fewer places than its modules say; the port rounds where the modules
say, as flax does op by op, and the distance rule covers the rest.

Each test prints its two readings (``bf16 <what>: direct <share of the
limit>, distance <ratio>``; run with ``-s``).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from space_time_pde_torch import inference as tinf
from space_time_pde_torch.bridge import load_flax_params
from space_time_pde_torch.models import ImNet as TImNet
from space_time_pde_torch.models import UNet3d as TUNet3d
from space_time_pde_torch.models import UNet4d as TUNet4d
from space_time_pde_torch.models.nonlinearities import NONLINEARITIES as TACTS
from space_time_pde_torch.ops import fused_query as tfq
from space_time_pde_tpu.models import ImNet, UNet3d
from space_time_pde_tpu.models.nonlinearities import NONLINEARITIES as JACTS
from space_time_pde_tpu.models.unet4d import UNet4d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF = torch.bfloat16
DIRECT = 4 * 2.0 ** -8
SLACK = 1.5
ZERO_GRAD = 1e-5    # a gradient leaf this far below the model's top is 0
GRAD_DIRECT = 0.5   # a leaf's direct limit, in units of JAX bf16's max


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def hold(what, got, want_bf16, ref, yardstick="JAX bf16"):
    """Apply both rules; returns (direct share of its limit, distance
    ratio) and prints them."""
    got, want, ref = (np.asarray(_np(a), np.float64)
                      for a in (got, want_bf16, ref))
    assert got.shape == want.shape == ref.shape, (got.shape, want.shape)
    assert np.isfinite(got).all(), what
    scale = np.abs(want).max()
    direct = np.abs(got - want).max() / (DIRECT * scale)
    own = np.abs(want - ref).max()
    mine = np.abs(got - ref).max()
    ratio = mine / own if own > 0 else (0.0 if mine == 0 else np.inf)
    print(f"bf16 {what}: direct {direct:.3f} of the limit, distance "
          f"{mine:.3e} vs {yardstick} {own:.3e} ({ratio:.3f}x)")
    assert direct <= 1.0, (what, direct)
    assert mine <= SLACK * own or mine == 0, (what, mine, own)
    return direct, ratio


@pytest.mark.parametrize("name", sorted(JACTS))
def test_activations_bf16_match_jax(name):
    """Op by op as jax computes on bf16: bit for bit here."""
    x = np.random.RandomState(0).randn(20000).astype(np.float32) * 6
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(JACTS[name](xb, 0.02).astype(jnp.float32))
    got = TACTS[name](torch.from_numpy(_np(xb)).to(BF), 0.02)
    assert got.dtype == BF
    np.testing.assert_array_equal(_np(got), want)


def _imnet_pair(dim, seed, activation="leaky_relu"):
    kw = dict(dim=dim, in_features=6, out_features=4, nf=4,
              activation=activation)
    j32 = ImNet(**kw)
    params = j32.init(jax.random.PRNGKey(seed),
                      jnp.ones((1, dim + 6)))["params"]
    t = load_flax_params(TImNet(**kw, dtype=BF), params)
    return j32, ImNet(**kw, dtype=jnp.bfloat16), params, t


@pytest.mark.parametrize("activation", ["leaky_relu", "gelu"])
def test_imnet_bf16_matches_flax(activation):
    j32, j16, params, tm = _imnet_pair(3, 0, activation)
    x = np.random.RandomState(1).randn(5, 8, 9).astype(np.float32)
    xj = jnp.asarray(x)
    got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    hold(f"ImNet ({activation})", got,
         j16.apply({"params": params}, xj), j32.apply({"params": params},
                                                       xj))
    # The per-call override runs the same weights at f32.
    np.testing.assert_allclose(
        _np(tm(torch.from_numpy(x), dtype=torch.float32)),
        np.asarray(j32.apply({"params": params}, xj)), rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_unet3d_bf16_matches_flax(norm):
    kw = dict(in_features=4, out_features=8, igres=(4, 8, 8), nf=4, mf=16,
              norm=norm)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 8, 8, 4).astype(np.float32)
    variables = UNet3d(**kw).init(jax.random.PRNGKey(2), jnp.asarray(x))
    stats = variables.get("batch_stats")
    if stats is not None:
        stats = jax.tree.map(
            lambda a: np.asarray(a) + rng.rand(*a.shape).astype(np.float32),
            stats)
        variables = dict(variables, batch_stats=stats)
    tm = load_flax_params(TUNet3d(**kw, dtype=BF), variables["params"],
                          stats).eval()
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    want = UNet3d(**kw, dtype=jnp.bfloat16).apply(variables, jnp.asarray(x))
    assert want.dtype == jnp.float32
    hold(f"UNet3d ({norm})", got, want,
         UNet3d(**kw).apply(variables, jnp.asarray(x)))


def test_unet4d_bf16_matches_flax():
    kw = dict(in_features=4, out_features=6, igres=(2, 4, 4, 4), nf=4,
              mf=8)
    x = np.random.RandomState(3).randn(1, 2, 4, 4, 4, 4).astype(np.float32)
    variables = UNet4d(**kw).init(jax.random.PRNGKey(3), jnp.asarray(x))
    tm = load_flax_params(TUNet4d(**kw, dtype=BF), variables["params"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    hold("UNet4d", got,
         UNet4d(**kw, dtype=jnp.bfloat16).apply(variables, jnp.asarray(x)),
         UNet4d(**kw).apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("dim,spatial", [(3, (3, 4, 5)), (4, (2, 3, 3, 4))])
def test_decode_bf16_twin_matches_gather_kernel(dim, spatial):
    """The bf16 decode (the plain twin here, the bf16 kernel on a card)
    against the TPU gather kernel at compute_dtype bf16, in interpret
    mode, on a seeded latent grid; the reference is the f32 decode."""
    from space_time_pde_tpu.ops.fused_query import (
        fused_query_local_implicit_grid as jfused)

    j32, _, params, tm = _imnet_pair(dim, 4)
    rng = np.random.RandomState(5)
    grid = rng.randn(1, *spatial, 6).astype(np.float32)
    pts = rng.rand(1, 200, dim).astype(np.float32)
    want = jfused(j32, params, jnp.asarray(grid), jnp.asarray(pts),
                  compute_dtype=jnp.bfloat16, gather="kernel", pad_to=0,
                  interpret=True)
    tfq.reset_launches()
    got = tfq.fused_query_local_implicit_grid(
        tm, torch.from_numpy(grid), torch.from_numpy(pts),
        compute_dtype=BF)
    assert sum(tfq.LAUNCHES.values()) == 0      # the twin, on the CPU
    ref = tfq.fused_query_local_implicit_grid(
        tm, torch.from_numpy(grid), torch.from_numpy(pts))
    hold(f"decode D={dim}", got, want, ref)


def test_dense_decoder_bf16_matches_jax():
    """``make_dense_decoder(compute_dtype=bf16)`` with a bf16 UNet (a
    ``use_bf16`` checkpoint's eval) against JAX's dense decoder under the
    same policy (the gather kernel in interpret mode); the reference is
    the f32 pair's decode."""
    from space_time_pde_tpu import inference as jinf

    igres, out_shape, lat = (4, 8, 8), (4, 16, 16), 6
    kw = dict(in_features=4, out_features=lat, igres=igres, nf=4, mf=16)
    ikw = dict(dim=3, in_features=lat, out_features=4, nf=4)
    k1, k2 = jax.random.split(jax.random.PRNGKey(6))
    params = {"unet": UNet3d(**kw).init(k1, jnp.zeros((1, *igres, 4)))[
                  "params"],
              "imnet": ImNet(**ikw).init(k2, jnp.zeros((1, 3 + lat)))[
                  "params"]}
    lres = np.random.RandomState(7).randn(*igres, 4).astype(np.float32)
    want = jinf.make_dense_decoder(
        UNet3d(**kw, dtype=jnp.bfloat16), ImNet(**ikw, dtype=jnp.bfloat16),
        out_shape, chunk=512, fused=True, interpret=True, block_pts=256,
        compute_dtype=jnp.bfloat16)(params, jnp.asarray(lres))

    def port(dtype):
        tunet = load_flax_params(TUNet3d(**kw, dtype=dtype),
                                 params["unet"]).eval()
        timnet = load_flax_params(TImNet(**ikw, dtype=dtype),
                                  params["imnet"])
        return tinf.make_dense_decoder(tunet, timnet, out_shape, chunk=512,
                                       compute_dtype=dtype)

    dec = port(BF)
    assert dec.provenance["compute_dtype"] == "bfloat16"
    hold("dense decoder", dec(lres), want, port(torch.float32)(lres))


@pytest.mark.parametrize("dim", [3, 4])
def test_bf16_kernel_layout_emulated(dim):
    """The bf16 kernel's weight layout (``kernel_weights(dtype=bf16)``:
    transposed, zero-padded B operands, rel / cb at each layer's padded
    column offset) driven as ``csrc/fused_query.cu`` drives it, layer by
    layer with ``A = [h | padded latents]``, against the bf16 twin."""
    _, _, _, tm = _imnet_pair(dim, 8)
    rng = np.random.RandomState(9)
    nf, c, k = tm.nf, tm.in_features, 2 ** dim
    n_cells, n = 11, 40
    table = torch.from_numpy(rng.randn(n_cells, k * c).astype(
        np.float32)).to(BF)
    cells = torch.from_numpy(rng.randint(0, n_cells, n).astype(np.int32))
    frac = torch.from_numpy(rng.rand(n, dim).astype(np.float32))
    with torch.no_grad():
        packed = tfq.pack_imnet_params(tm)
        want = tfq.decode_blend_gather_plain(table, cells, frac, packed,
                                             nf=nf, compute_dtype=BF)
        kw = {name: v.float() for name, v in tfq.kernel_weights(
            packed, nf=nf, dtype=BF).items()}
    assert all(kw[name].dtype == torch.float32 for name in kw)
    widths = [-(-nf * m // 64) * 64 for m in (16, 8, 4, 2, 1)]
    offs = np.cumsum([0] + widths)
    cp = kw["wx0"].shape[1]
    feats = torch.nn.functional.pad(
        table[cells.long()].float().reshape(n * k, c), (0, cp - c))
    frb = frac.to(BF).float().repeat_interleave(k, 0)
    corner = torch.arange(n * k) % k
    h = None
    for layer in range(5):
        a = feats if layer == 0 else torch.cat([h, feats], 1)
        b = kw["wx0"] if layer == 0 else kw[f"wb{layer}"]
        sl = slice(int(offs[layer]), int(offs[layer + 1]))
        pre = a @ b.t() + kw["cb"][corner, sl] + frb @ kw["rel"][:, sl]
        hf = torch.nn.functional.leaky_relu(pre, 0.01)
        h = hf.to(BF).float() if layer < 4 else hf
    w = tfq._corner_weights(frac)
    hb = (h[:, :nf].reshape(n, k, nf) * w[..., None]).sum(1)
    got = hb.to(BF).float() @ kw["w5"] + kw["b5"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_sharded_twins_bf16_match_plain(tmp_path):
    """``ShardedUNet3d`` (GroupNorm and BatchNorm in train mode) and
    ``ShardedUNet4d`` built ``from_plain`` on bf16 modules, x split over
    2 gloo ranks, against the plain bf16 modules; the reference is the
    plain f32 modules' output."""
    from space_time_pde_torch.bridge import flatten_tree

    from torch_ranks import run_world

    igres3, igres4 = (4, 16, 32), (4, 4, 8, 16)
    rng = np.random.RandomState(10)
    key = jax.random.PRNGKey(11)
    cases = {"u3": (TUNet3d, igres3, "group"), "bn": (TUNet3d, igres3,
                                                     "batch"),
             "u4": (TUNet4d, igres4, None)}
    inputs, variables = {}, {}
    for tag, (_, igres, norm) in cases.items():
        x = rng.randn(2, *igres, 4).astype(np.float32)
        kw = dict(in_features=4, out_features=8, igres=igres, nf=8)
        jm = UNet4d(**kw) if norm is None else UNet3d(**kw, norm=norm)
        variables[tag] = jax.jit(jm.init)(key, jnp.asarray(x))
        inputs.update({f"{tag}/{k}": v for k, v in
                       flatten_tree(variables[tag]["params"]).items()})
        if "batch_stats" in variables[tag]:
            inputs.update({f"{tag}_stats/{k}": v for k, v in flatten_tree(
                variables[tag]["batch_stats"]).items()})
        inputs[f"{tag}_x"] = x
        inputs[f"{tag}_cot"] = rng.randn(*x.shape[:-1], 8).astype(
            np.float32)
    outs = run_world("sharded_unet", 2, str(tmp_path), inputs=inputs,
                     spec={"igres3": igres3, "igres4": igres4,
                           "dtype": "bfloat16"})
    for tag, (cls, igres, norm) in cases.items():
        ax = len(igres)
        got = np.concatenate([o[f"{tag}_y"] for o in outs], axis=ax)

        def plain(dtype):
            kw = dict(in_features=4, out_features=8, igres=igres, nf=8,
                      dtype=dtype)
            if norm:
                kw["norm"] = norm
            m = load_flax_params(cls(**kw), variables[tag]["params"],
                                 variables[tag].get("batch_stats"))
            m.train(norm == "batch")
            with torch.no_grad():
                return m(torch.from_numpy(inputs[f"{tag}_x"]))

        hold(f"sharded {tag} (2 ranks)", got, plain(BF),
             plain(torch.float32), yardstick="plain bf16")


def _step_setup(family, use_bf16):
    """JAX models, config, weights, batch and PDE layers of one small
    ``use_bf16`` (or f32) training step of ``family``."""
    from space_time_pde_tpu import physics as jphys
    from space_time_pde_tpu.physics.systems import get_ns3d_pde_layer
    from space_time_pde_tpu.train import build_models as jbuild
    from space_time_pde_tpu.utils.config import Config

    from space_time_pde_torch import physics as tphys

    cfg = Config()
    cfg.model.use_bf16 = use_bf16
    cfg.train.alpha_pde, cfg.train.pde_loss_type = 0.1, "huber"
    rng = np.random.RandomState(12)
    mean, std = rng.randn(4), 0.5 + rng.rand(4)
    if family == "rb2d":
        igres, dim = (4, 8, 8), 3
        cfg.model.lat_dims, cfg.model.unet_nf, cfg.model.imnet_nf = 8, 4, 2
        unet, imnet = jbuild(cfg, igres)
        kw = dict(mean=mean, std=std, t_crop=0.75, z_crop=0.5, x_crop=0.5,
                  rayleigh=1e4)
        jpde, tpde = jphys.get_rb2_pde_layer(**kw), \
            tphys.get_rb2_pde_layer(**kw)
    else:
        igres, dim = (2, 4, 4, 4), 4
        cfg.model.lat_dims, cfg.model.unet_nf, cfg.model.imnet_nf = 6, 4, 2
        cfg.model.unet_mf = 8
        cfg.physics.pde_system, cfg.physics.viscosity = "ns3d", 1e-2
        dt = jnp.bfloat16 if use_bf16 else jnp.float32
        unet = UNet4d(in_features=4, out_features=6, igres=igres, nf=4,
                      mf=8, dtype=dt)
        imnet = ImNet(dim=4, in_features=6, out_features=4, nf=2, dtype=dt)
        kw = dict(mean=mean, std=std, t_crop=0.7, z_crop=2.0, y_crop=2.5,
                  x_crop=3.0, viscosity=1e-2)
        jpde = get_ns3d_pde_layer(**kw)
        tpde = tphys.get_pde_layer("ns3d", **kw)
    k1, k2 = jax.random.split(jax.random.PRNGKey(13))
    params = {"unet": unet.init(k1, jnp.zeros((1, *igres, 4)))["params"],
              "imnet": imnet.init(k2, jnp.zeros((1, dim + imnet.in_features)))[
                  "params"]}
    batch = {"lres": rng.randn(2, *igres, 4).astype(np.float32),
             "point_coord": rng.rand(2, 24, dim).astype(np.float32),
             "point_value": rng.randn(2, 24, 4).astype(np.float32)}
    return cfg, unet, imnet, params, batch, jpde, tpde, igres


def _jax_step(family, use_bf16):
    from space_time_pde_tpu.train import make_loss_fn as jloss

    cfg, unet, imnet, params, batch, jpde, _, _ = _step_setup(family,
                                                              use_bf16)
    step = jax.value_and_grad(jloss(cfg, unet, imnet, jpde), has_aux=True)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    if use_bf16:
        # Op by op, every bf16 result is rounded where the modules say, as
        # in the port; under jit XLA keeps some of them in f32.
        with jax.disable_jit():
            (_, metrics), grads = step(params, batch)
    else:
        (_, metrics), grads = jax.jit(step)(params, batch)
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("family", ["rb2d", "turb3d"])
def test_use_bf16_step_matches_jax(family):
    """One ``use_bf16`` training step's loss terms and every gradient leaf
    (f32) against JAX's ``make_loss_fn`` under the same policy (its jet
    f32, as the port's), run op by op; the reference is JAX's f32 step.

    Each leaf holds both rules on its own:

    - distance: its distance from the f32 leaf, in units of that leaf's
      max |g|, within SLACK times JAX bf16's plus DIRECT (four bf16 steps
      of the leaf);
    - direct: within GRAD_DIRECT times the max |g| of JAX bf16's leaf.
      Not the per-point four steps: these small models' backward passes
      magnify a rounding difference by orders of magnitude, so a bf16
      rounding that lands on the other side of a step in one framework
      moves a leaf by up to a quarter of its scale, while the bf16 policy
      itself moves leaves by more than their scale. Half a leaf still
      fails a leaf that is zero (it reads 1), negated (2) or left at f32
      where bf16 moves it (its own distance from JAX bf16); the test
      checks that each leaf zeroed or negated alone fails.

    Leaves whose f32 gradient is ~0 (a conv bias right before a norm)
    read both rules in units of the model's largest gradient."""
    from space_time_pde_torch import train as ttrain
    from space_time_pde_torch.bridge import state_dict_from_flax
    from space_time_pde_torch.utils.config import Config as TConfig

    cfg, _, _, params, batch, _, tpde, igres = _step_setup(family, True)
    want_m, want_g = _jax_step(family, True)
    ref_m, ref_g = _jax_step(family, False)
    tunet, timnet = ttrain.build_models(TConfig.from_dict(cfg.to_dict()),
                                        igres, "cpu")
    assert tunet.dtype == timnet.dtype == BF
    load_flax_params(tunet, params["unet"])
    load_flax_params(timnet, params["imnet"])
    loss_fn = ttrain.make_loss_fn(TConfig.from_dict(cfg.to_dict()), tunet,
                                  timnet, tpde)
    loss, metrics = loss_fn({k: torch.from_numpy(v)
                             for k, v in batch.items()})
    loss.backward()
    assert loss.dtype == torch.float32
    for k in want_m:
        hold(f"{family} step {k}", metrics[k], np.float32(want_m[k]),
             np.float32(ref_m[k]))
    top = max(float(np.abs(g).max()) for g in jax.tree.leaves(ref_g))

    def readings(got, a, r):
        """(distance, own distance, direct) of one leaf."""
        zero = np.abs(r).max() < ZERO_GRAD * top
        scale = top if zero else np.abs(r).max()
        return (np.abs(got - r).max() / scale, np.abs(a - r).max() / scale,
                np.abs(got - a).max() / (top if zero else np.abs(a).max()))

    def fails(got, a, r):
        dist, yard, dirc = readings(got, a, r)
        return dist > SLACK * yard + DIRECT or dirc > GRAD_DIRECT

    mine, own, direct = {}, {}, {}
    for name, module in (("unet", tunet), ("imnet", timnet)):
        w16 = state_dict_from_flax(module, want_g[name])
        w32 = state_dict_from_flax(module, ref_g[name])
        for k, p in module.named_parameters():
            assert p.grad.dtype == torch.float32, k
            got, a, r = (np.asarray(t, np.float64) for t in (
                p.grad.numpy(), w16[k].numpy(), w32[k].numpy()))
            key = f"{name}.{k}"
            mine[key], own[key], direct[key] = readings(got, a, r)
            if np.abs(r).max() >= ZERO_GRAD * top:
                assert fails(0 * got, a, r) and fails(-got, a, r), key
    far = {k: mine[k] / (SLACK * own[k] + DIRECT) for k in mine}
    worst_far, worst_direct = max(far, key=far.get), max(direct,
                                                         key=direct.get)
    print(f"bf16 {family} step: {len(mine)} gradient leaves: distance "
          f"worst {far[worst_far]:.3f} of its limit ({worst_far}: "
          f"{mine[worst_far]:.3e} vs JAX bf16 {own[worst_far]:.3e} x "
          f"scale); direct worst {direct[worst_direct]:.3f} of JAX bf16's "
          f"max ({worst_direct}; limit {GRAD_DIRECT:g}); JAX bf16 up to "
          f"{max(own.values()):.3e} x scale from f32")
    assert far[worst_far] <= 1.0, (worst_far, mine[worst_far],
                                   own[worst_far])
    assert direct[worst_direct] <= GRAD_DIRECT, (worst_direct,
                                                 direct[worst_direct])


# ------------------------------------------------------------------ CLIs

from test_torch_turb3d import _tiny_export, folder  # noqa: E402,F401


def _cli(family, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "experiments", family, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rb2d_train_cli_use_bf16(tmp_path, capsys):
    from test_torch_train_cli import _flags

    from space_time_pde_torch.data import save_npz, taylor_green_fields

    save_npz(str(tmp_path / "tg.npz"),
             taylor_green_fields(nt=10, nz=16, nx=16))
    res = _cli("rb2d", "train_torch").main(
        _flags(tmp_path, "--epochs", "1", "--use_bf16", "true"))
    assert "policy=bf16 (jet f32)" in capsys.readouterr().out
    assert res["step"] == 4 and all(
        np.isfinite(e["loss"]) and np.isfinite(e["eval/rel_l2"])
        for e in res["epochs"])


def test_turb3d_train_cli_use_bf16(folder, tmp_path, capsys):  # noqa: F811
    from test_torch_turb3d import _train_flags

    res = _cli("turb3d", "train_torch").main(_train_flags(
        folder, str(tmp_path / "log"), "--epochs", "1", "--use_bf16",
        "true"))
    assert "policy=bf16 (jet f32)" in capsys.readouterr().out
    assert res["step"] == 2 and all(np.isfinite(e["loss"])
                                    for e in res["epochs"])


def test_rb2d_eval_cli_decode_dtype_matches_jax(tmp_path, capsys):
    """A ``use_bf16`` export: ``--decode_dtype auto`` decodes in bf16 with
    the bf16 UNet, against JAX's dense decoder under the same policy (the
    gather kernel in interpret mode); ``f32`` forces the f32 decode."""
    from space_time_pde_tpu import inference as jinf
    from space_time_pde_tpu.data import RB2DataLoader, save_npz, \
        taylor_green_fields
    from space_time_pde_tpu.utils.config import Config

    from space_time_pde_torch.bridge import save_exported

    cfg = Config()
    cfg.model.use_bf16 = True
    cfg.model.lat_dims, cfg.model.unet_nf, cfg.model.imnet_nf = 6, 4, 4
    cfg.data.nt, cfg.data.nz, cfg.data.nx = 8, 16, 32
    cfg.data.downsamp_t, cfg.data.downsamp_xz = 2, 4
    cfg.data.data_folder, cfg.data.eval_data = str(tmp_path), "tg.npz"
    save_npz(str(tmp_path / "tg.npz"),
             taylor_green_fields(nt=8, nz=16, nx=32))
    igres = (4, 4, 8)
    kw = dict(in_features=4, out_features=6, igres=igres, nf=4, mf=16)
    ikw = dict(dim=3, in_features=6, out_features=4, nf=4)
    k1, k2 = jax.random.split(jax.random.PRNGKey(14))
    params = {"unet": UNet3d(**kw).init(k1, jnp.zeros((1, *igres, 4)))[
                  "params"],
              "imnet": ImNet(**ikw).init(k2, jnp.zeros((1, 9)))["params"]}
    mean, std = np.zeros(4, np.float32), np.ones(4, np.float32)
    save_exported(str(tmp_path / "w.npz"), params, None, cfg.to_dict(),
                  mean, std, 3)
    cli = _cli("rb2d", "evaluation_torch")
    flags = ["--params", str(tmp_path / "w.npz"), "--device", "cpu",
             "--query_chunk", "1024", "--save_path",
             str(tmp_path / "pred.npz")]
    res = cli.main(flags)
    assert "dtype=bfloat16" in capsys.readouterr().out
    ds = RB2DataLoader(str(tmp_path), "tg.npz", nt=8, nz=16, nx=32,
                       downsamp_t=2, downsamp_xz=4)
    ds.channel_mean, ds.channel_std = mean, std
    lres = ds.full_lres_sequence(0, 8)
    np.testing.assert_allclose(res["lres0"], lres, rtol=1e-6, atol=1e-6)
    lres = jnp.asarray(lres)

    def jdec(dtype, fused):
        return jinf.make_dense_decoder(
            UNet3d(**kw, dtype=dtype), ImNet(**ikw, dtype=dtype),
            (8, 16, 32), chunk=1024, fused=fused, interpret=True,
            block_pts=256, compute_dtype=dtype)(params, lres)

    hold("rb2d eval CLI", res["window0"], jdec(jnp.bfloat16, True),
         jdec(jnp.float32, False))
    res32 = cli.main(flags + ["--decode_dtype", "f32"])
    assert "dtype=float32" in capsys.readouterr().out
    assert res32["provenance"]["compute_dtype"] == "float32"


def test_turb3d_eval_cli_decode_dtype_bf16(folder, tmp_path,  # noqa: F811
                                           capsys):
    """An f32 export decoded with ``--decode_dtype bf16`` (the UNet stays
    f32, as in the JAX CLI) against JAX's dense decoder at the same
    compute dtype (the gather kernel in interpret mode) on the CLI's
    first window; the reference is JAX's f32 decode."""
    from space_time_pde_tpu import inference as jinf

    from space_time_pde_torch.bridge import load_exported

    params = str(tmp_path / "w.npz")
    _tiny_export(params)
    cli = _cli("turb3d", "evaluation_torch")
    flags = ["--params", params, "--device", "cpu", "--data_folder", folder,
             "--query_chunk", "2000", "--save_path",
             str(tmp_path / "pred.npz")]
    got = cli.main(flags + ["--decode_dtype", "bf16"])
    assert "dtype=bfloat16" in capsys.readouterr().out
    assert got["provenance"]["compute_dtype"] == "bfloat16"
    assert cli.main(flags)["provenance"]["compute_dtype"] == "float32"
    igres = tuple(got["lres0"].shape[:4])
    unet = UNet4d(in_features=4, out_features=4, igres=igres, nf=2, mf=4)
    imnet = ImNet(dim=4, in_features=4, out_features=4, nf=2)
    jparams = jax.tree.map(jnp.asarray, load_exported(params)["params"])

    def jdec(dtype, fused):
        return jinf.make_dense_decoder(
            unet, imnet, tuple(got["window0"].shape[:4]), chunk=2000,
            fused=fused, interpret=True, block_pts=128,
            compute_dtype=dtype)(jparams, jnp.asarray(got["lres0"]))

    hold("turb3d eval CLI", got["window0"], jdec(jnp.bfloat16, True),
         jdec(jnp.float32, False))
