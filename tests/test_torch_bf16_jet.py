"""Port parity of the bf16 jets (``--use_bf16 --pde_bf16``) and the bf16
pre-gathered decode: the port's bf16 twins (the kernels' arithmetic on
the CPU) against the JAX package's Pallas kernels at ``compute_dtype``
bf16 in interpret mode, on the same seeded inputs and weights (through
the bridge).

The rules are ``test_torch_bf16.py``'s (PR 8): direct, per point within
four bf16 steps of max |JAX bf16|; distance, from the f32 reference at
most 1.5x JAX bf16's own; a training step's gradient leaves each on its
own (``hold_step``), where a zeroed or negated leaf fails.

The interpret-mode kernels are run under ``jit`` where that rounds as
eagerly (the jets here: their forward and backward agree bit for bit
with ``jax.disable_jit()``), and op by op where it does not (the
training step, as in ``test_torch_bf16.py``).
"""

import contextlib
import functools
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from space_time_pde_torch.bridge import load_flax_params
from space_time_pde_torch.models import ImNet as TImNet
from space_time_pde_torch.ops import fused_jet as tfj
from space_time_pde_torch.ops import fused_query as tfq
from space_time_pde_torch.ops.jet import query_local_implicit_grid_jet
from space_time_pde_tpu.models import ImNet
from space_time_pde_tpu.ops import fused_jet as jfj
from space_time_pde_tpu.ops.fused_query import (
    _padded_widths, fused_decode_blend, fused_query_local_implicit_grid,
    pack_imnet_params)
from space_time_pde_tpu.ops.jet import query_local_implicit_grid_jet as jjet

from test_torch_bf16 import BF, _cli, _step_setup, hold, hold_step
from test_torch_turb3d import _train_flags, folder  # noqa: F401

PAD = 16            # the Pallas kernels' lane padding here (as
                    # tests/test_fused_jet.py): exact zeros in the pads
WIDTHS = (16, 8, 4, 2, 1)
# The gradients both jets keep in f32 (corner_bias, b5: sums of f32
# values) may sit exactly where the f32 jet puts them (b5's sum of ybar is
# the same at either dtype); the port sums them in another order, so their
# distance rule allows f32 rounding of max |g| on top of 1.5x JAX bf16's.
F32_FLOOR = 2.0 ** -20


def _pair(dim, lat, nf, seed):
    kw = dict(dim=dim, in_features=lat, out_features=4, nf=nf)
    model = ImNet(**kw)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, dim + lat)))["params"]
    return model, params, load_flax_params(TImNet(**kw), params)


def _unpad(name, g, nf):
    """A packed-parameter gradient of the Pallas jet without its lane
    padding (``PAD``), in the port's layout."""
    g = np.asarray(jnp.asarray(g, jnp.float32), np.float64)
    widths = [nf * m for m in WIDTHS]
    off = np.cumsum([0] + _padded_widths(nf, PAD))
    if name in ("wx_feat", "wx_rel", "corner_bias"):
        return np.concatenate([g[:, off[i]:off[i] + widths[i]]
                               for i in range(5)], 1)
    if name.startswith("wh"):
        i = int(name[2:])
        return g[:widths[i - 1], :widths[i]]
    return g[:nf] if name == "w5" else g


def _blocks(value, jac, hess, dim):
    """JAX's (value, jac, hess) -> the port's ``[N, blocks, O]``."""
    out = [value] + [jac[..., a] for a in range(dim)]
    out += [hess[..., a, b] for a, b in tfj.tri_pairs(dim)]
    return np.stack([np.asarray(jnp.asarray(o, jnp.float32)) for o in out],
                    axis=1)


@pytest.mark.parametrize("dim,lat,n", [(3, 8, 37), (4, 4, 21)])
def test_bf16_jet_twins_match_pallas(dim, lat, n):
    """``jet_fwd_plain`` and ``jet_bwd_bf16_plain`` at bf16 (the bf16
    kernels' twins) against ``make_fused_jet(compute_dtype=bfloat16,
    interpret=True)``: the forward's blocks, and d feats2 and the 9
    packed gradients (rounded to the packed dtypes, as JAX's backward
    returns them) for a seeded cotangent. The reference is the f32
    Pallas jet on the unrounded inputs."""
    nf, k = 2, 2 ** dim
    model, params, tm = _pair(dim, lat, nf, dim)
    rng = np.random.RandomState(10 + dim)
    feats = rng.randn(n * k, lat).astype(np.float32)
    frac = rng.rand(n, dim).astype(np.float32)
    frac[:3] = np.array([0.0, 1.0, 0.5])[:, None]
    blocks = 1 + dim + len(tfj.tri_pairs(dim))
    ybar = rng.randn(n, blocks, 4).astype(np.float32)
    cot = (ybar[:, 0], np.stack([ybar[:, 1 + a] for a in range(dim)], -1),
           np.zeros((n, 4, dim, dim), np.float32))
    for i, (a, b) in enumerate(tfj.tri_pairs(dim)):
        cot[2][:, :, a, b] = ybar[:, 1 + dim + i]

    def pallas(dtype):
        jet = jfj.make_fused_jet(nf=nf, n_corners=k, dim=dim, out_dim=4,
                                 block_pts=8, compute_dtype=dtype,
                                 interpret=True, pad_to=PAD)
        packed = pack_imnet_params(params, dim, lat, nf, dtype=dtype,
                                   pad_to=PAD)
        x, fr = jnp.asarray(feats).astype(dtype), jnp.asarray(frac)
        grads = jax.jit(lambda x, p: jax.vjp(
            lambda a, b: jet(a, fr, b), x, p)[1](
                tuple(jnp.asarray(c) for c in cot)))(x, packed)
        return _blocks(*jax.jit(jet)(x, fr, packed), dim), grads

    want, (wdf, wdp) = pallas(jnp.bfloat16)
    ref, (rdf, rdp) = pallas(jnp.float32)
    with torch.no_grad():
        packed = tfq.pack_imnet_params(tm, dtype=BF)
    assert {packed[name].dtype for name in tfq._ROUNDED} == {BF}
    assert packed["corner_bias"].dtype == packed["b5"].dtype == \
        torch.float32
    f16, fr = torch.from_numpy(feats).to(BF), torch.from_numpy(frac)
    tfj.reset_launches()
    got, ws = tfj.jet_fwd(f16, fr, packed, nf=nf, compute_dtype=BF)
    assert ws is None
    hold(f"jet forward D={dim}", got, want, ref)
    dfeats, grads = tfj.jet_bwd(f16, fr, packed, None,
                                torch.from_numpy(ybar), nf=nf,
                                compute_dtype=BF)
    assert sum(tfj.LAUNCHES.values()) == 0      # the twins, on the CPU
    hold(f"jet backward D={dim} dfeats2", dfeats.to(BF), wdf, rdf)
    for name in tfq._WEIGHTS:
        assert grads[name].dtype == torch.float32, name
        hold(f"jet backward D={dim} {name}",
             grads[name].to(packed[name].dtype),
             _unpad(name, wdp[name], nf), _unpad(name, rdp[name], nf),
             floor=0.0 if name in tfq._ROUNDED else F32_FLOOR)


def test_jet_function_backward_is_the_bf16_twin():
    """At bf16 the autograd Function routes its cotangent to
    ``jet_bwd_bf16_plain`` on CPU tensors and returns its gradients
    rounded to the types of the tensors they belong to (bf16 rows and
    weights, f32 ``corner_bias`` and ``b5``), as the TPU's ``jet_bwd``
    casts them."""
    _, _, tm = _pair(3, 8, 4, 5)
    rng = np.random.RandomState(3)
    feats2 = torch.from_numpy(rng.randn(40 * 8, 8).astype(np.float32)).to(BF)
    frac = torch.from_numpy(rng.rand(40, 3).astype(np.float32))
    ybar = torch.from_numpy(rng.randn(40, 10, 4).astype(np.float32))
    with torch.no_grad():
        packed = tfq.pack_imnet_params(tm, dtype=BF)
    dfeats, grads = tfj.jet_bwd_bf16_plain(feats2, frac, packed, ybar, nf=4)
    leaves = {k: v.clone().requires_grad_(True) for k, v in packed.items()}
    f = feats2.clone().requires_grad_(True)
    out = tfj._Jet.apply(4, 0.01, BF, f, frac,
                         *[leaves[k] for k in tfq._WEIGHTS])
    (out * ybar).sum().backward()
    assert f.grad.dtype == BF
    assert torch.equal(f.grad, dfeats.to(BF))
    for k in tfq._WEIGHTS:
        assert leaves[k].grad.dtype == packed[k].dtype, k
        assert torch.equal(leaves[k].grad, grads[k].to(packed[k].dtype)), k


@pytest.mark.parametrize("dim,spatial", [(3, (3, 4, 5)), (4, (2, 3, 3, 4))])
def test_bf16_pregathered_decode_matches_pallas(dim, spatial):
    """The pre-gathered entry at bf16 (its twin on the CPU) against the TPU
    ``_kernel`` at bf16 in interpret mode: ``decode_blend`` on the same
    rows, and ``fused_query_local_implicit_grid(gather="pregather")``
    against JAX's on a seeded latent grid. The reference is the f32
    decode; the gather twin, which rounds elsewhere, is not it."""
    nf, lat, k = 4, 6, 2 ** dim
    model, params, tm = _pair(dim, lat, nf, 20 + dim)
    rng = np.random.RandomState(21)
    n = 150
    feats = rng.randn(n * k, lat).astype(np.float32)
    frac = rng.rand(n, dim).astype(np.float32)

    def pallas(dtype):
        packed = pack_imnet_params(params, dim, lat, nf, dtype=dtype)
        return fused_decode_blend(jnp.asarray(feats).astype(dtype),
                                  jnp.asarray(frac), packed, nf=nf,
                                  n_corners=k, block_pts=64,
                                  compute_dtype=dtype, interpret=True)

    with torch.no_grad():
        packed = tfq.pack_imnet_params(tm)
    tfq.reset_launches()
    f16, fr = torch.from_numpy(feats).to(BF), torch.from_numpy(frac)
    got = tfq.decode_blend(f16, fr, packed, nf=nf, n_corners=k,
                           compute_dtype=BF)
    hold(f"pre-gathered decode D={dim}", got, pallas(jnp.bfloat16),
         pallas(jnp.float32))
    gather_twin = tfq.decode_blend_gather_plain(
        f16.reshape(n, k * lat), torch.arange(n, dtype=torch.int32), fr,
        packed, nf=nf, compute_dtype=BF)
    assert not torch.equal(got, gather_twin)    # corner_bias, xs differ

    grid = rng.randn(1, *spatial, lat).astype(np.float32)
    pts = rng.rand(1, 200, dim).astype(np.float32)

    def query(dtype):
        return fused_query_local_implicit_grid(
            model, params, jnp.asarray(grid), jnp.asarray(pts),
            compute_dtype=dtype, gather="pregather", pad_to=0,
            interpret=True)

    got = tfq.fused_query_local_implicit_grid(
        tm, torch.from_numpy(grid), torch.from_numpy(pts),
        gather="pregather", compute_dtype=BF)
    assert sum(tfq.LAUNCHES.values()) == 0      # the twins, on the CPU
    hold(f"pre-gathered query D={dim}", got, query(jnp.bfloat16),
         query(jnp.float32))


@pytest.mark.parametrize("dim,spatial", [(3, (3, 4, 5)), (4, (2, 3, 3, 3))])
def test_jet_jnp_bf16_matches_jax(dim, spatial):
    """The plain jet under ``pde_bf16`` (``pde_derivs jet_jnp``): the
    ImNet in bf16 on the latent cast to bf16, as the JAX trainer's
    ``imnet.clone(dtype=bfloat16)`` on ``latent.astype(bfloat16)``,
    against JAX's ``query_local_implicit_grid_jet`` so; the reference is
    the f32 jet."""
    lat, nf = 6, 4
    model, params, tm = _pair(dim, lat, nf, 30 + dim)
    jm16 = model.clone(dtype=jnp.bfloat16)
    rng = np.random.RandomState(31)
    grid = rng.randn(2, *spatial, lat).astype(np.float32)
    pts = rng.rand(2, 40, dim).astype(np.float32)

    def jax_jet(m, dtype):
        dec = lambda v: m.apply({"params": params}, v)
        return jjet(dec, jnp.asarray(grid).astype(dtype), jnp.asarray(pts))

    with jax.disable_jit():
        want = jax_jet(jm16, jnp.bfloat16)
    ref = jax_jet(model, jnp.float32)
    got = query_local_implicit_grid_jet(
        lambda v: tm(v, dtype=BF), torch.from_numpy(grid).to(BF),
        torch.from_numpy(pts))
    for what, g, w, r in zip(("value", "jac", "hess"), got, want, ref):
        hold(f"jet_jnp D={dim} {what}", g, w, r)


@contextlib.contextmanager
def _pallas_jet_loss(cfg, unet, imnet, pde):
    """JAX's ``make_loss_fn`` built with its fused-jet branch (it picks
    the jnp jet on a CPU), called with the Pallas jet kernels in
    interpret mode."""
    from space_time_pde_tpu.train import make_loss_fn

    tpu = [types.SimpleNamespace(platform="tpu")]
    with mock.patch.object(jfj, "fused_query_jet", functools.partial(
            jfj.fused_query_jet, interpret=True)):
        with mock.patch.object(jax, "devices", lambda *a, **k: tpu):
            loss = make_loss_fn(cfg, unet, imnet, pde)
        yield loss


@pytest.mark.parametrize("family", ["rb2d", "turb3d"])
def test_pde_bf16_step_matches_jax(family):
    """One ``use_bf16`` + ``pde_bf16`` training step (the bf16 jet: the
    bf16 twins here, the bf16 kernels on a card) against JAX's loss whose
    jet is the Pallas kernel at bf16 in interpret mode, run op by op;
    the reference is JAX's f32 step (its f32 Pallas jet). Loss terms and
    every gradient leaf by ``hold_step``'s rules."""

    def jax_step(use_bf16):
        cfg, unet, imnet, params, batch, jpde, _, _ = _step_setup(
            family, use_bf16)
        cfg.train.pde_bf16 = use_bf16
        with _pallas_jet_loss(cfg, unet, imnet, jpde) as loss:
            step = jax.value_and_grad(loss, has_aux=True)
            batch = {k: jnp.asarray(v) for k, v in batch.items()}
            if use_bf16:
                with jax.disable_jit():
                    (_, metrics), grads = step(params, batch)
            else:
                (_, metrics), grads = jax.jit(step)(params, batch)
        return ({k: float(v) for k, v in metrics.items()},
                jax.tree.map(np.asarray, grads))

    cfg, _, _, params, batch, _, tpde, igres = _step_setup(family, True)
    cfg.train.pde_bf16 = True
    tfj.reset_launches()
    hold_step(f"{family} pde_bf16 step", cfg, params, batch, tpde, igres,
              jax_step(True), jax_step(False))
    assert sum(tfj.LAUNCHES.values()) == 0      # the twins, on the CPU


def test_train_clis_pde_bf16(folder, tmp_path, capsys):  # noqa: F811
    """Both tiny train CLIs with ``--use_bf16 true --pde_bf16 true``: the
    bf16 jet (its twins here) trains, finite losses, and the provenance
    names it."""
    from test_torch_train_cli import _flags

    from space_time_pde_torch.data import save_npz, taylor_green_fields

    save_npz(str(tmp_path / "tg.npz"),
             taylor_green_fields(nt=10, nz=16, nx=16))
    flags = ["--epochs", "1", "--use_bf16", "true", "--pde_bf16", "true"]
    res = _cli("rb2d", "train_torch").main(_flags(tmp_path, *flags))
    assert "policy=bf16 (jet bf16)" in capsys.readouterr().out
    assert res["step"] == 4 and all(
        np.isfinite(e["loss"]) and np.isfinite(e["pde_loss"])
        for e in res["epochs"])
    res = _cli("turb3d", "train_torch").main(_train_flags(
        folder, str(tmp_path / "log3"), *flags))
    assert "policy=bf16 (jet bf16)" in capsys.readouterr().out
    assert res["step"] == 2 and all(
        np.isfinite(e["loss"]) and np.isfinite(e["pde_loss"])
        for e in res["epochs"])
