"""Port parity: the fused jet (``ops/fused_jet.py``) on the CPU vs the
Pallas jet kernels (interpret mode) and the jnp jet of the JAX package.

On CPU tensors the wrappers run the plain twins (``jet_fwd_plain``;
the backward is autograd through it), so the launch counters stay 0.
Forward tolerances as ``tests/test_fused_jet.py`` (value rtol 2e-4 /
atol 2e-5, Jacobian 2e-4 / 2e-4, Hessian 2e-4 / 2e-3); gradients rtol
3e-4 with atol 3e-3 (latent grid) and 5e-3 (parameters), as there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from space_time_pde_torch.bridge import load_flax_params, \
    state_dict_from_flax
from space_time_pde_torch.models import ImNet as TImNet
from space_time_pde_torch.ops import fused_jet as tfj
from space_time_pde_torch.ops import fused_query as tfq
from space_time_pde_tpu.models import ImNet
from space_time_pde_tpu.ops.fused_jet import fused_query_jet
from space_time_pde_tpu.ops.jet import query_local_implicit_grid_jet

TOLS = [dict(rtol=2e-4, atol=2e-5), dict(rtol=2e-4, atol=2e-4),
        dict(rtol=2e-4, atol=2e-3)]


def _pair(dim=3, lat=8, nf=2, out=4, seed=0, activation="leaky_relu"):
    model = ImNet(dim=dim, in_features=lat, out_features=out, nf=nf,
                  activation=activation)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, dim + lat)))["params"]
    tm = load_flax_params(TImNet(dim, lat, out, nf, activation), params)
    return model, params, tm


def _pallas(model, params, latent, pts):
    return jax.jit(lambda p, l, q: fused_query_jet(
        model, p, l, q, block_pts=8, pad_to=16, compute_dtype=jnp.float32,
        interpret=True))(params, latent, pts)


def _jnp(model, params, latent, pts):
    return query_local_implicit_grid_jet(
        lambda v: model.apply({"params": params}, v), latent, pts)


def _edge_points(rng, b, n, dim):
    pts = rng.rand(b, n, dim).astype(np.float32)
    pts[0, :5, :3] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 0.5, 1.0],
                      [1.2, -0.1, 0.5], [0.999, 0.001, 0.5]]
    return pts


CASES = [
    # (dim, latent spatial, n points, activation, out)
    (3, (4, 5, 6), 23, "leaky_relu", 4),
    (3, (3, 4, 4), 16, "relu", 4),
    (4, (3, 3, 4, 4), 10, "leaky_relu", 2),
]


@pytest.mark.parametrize("dim,spatial,n,activation,out", CASES)
def test_fused_query_jet_matches_pallas_and_jnp(dim, spatial, n, activation,
                                               out):
    model, params, tm = _pair(dim=dim, lat=4 if dim == 4 else 8, out=out,
                              seed=dim, activation=activation)
    rng = np.random.RandomState(dim)
    latent = rng.randn(2 if dim == 3 else 1, *spatial,
                       4 if dim == 4 else 8).astype(np.float32)
    pts = _edge_points(rng, latent.shape[0], n, dim)
    tfj.reset_launches()
    got = tfj.fused_query_jet(tm, torch.from_numpy(latent),
                              torch.from_numpy(pts))
    assert tfj.LAUNCHES == {"jet_fwd": 0, "jet_bwd": 0}
    for want in (_pallas(model, params, jnp.asarray(latent),
                         jnp.asarray(pts)),
                 _jnp(model, params, jnp.asarray(latent), jnp.asarray(pts))):
        for g, w, tol in zip(got, want, TOLS):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       **tol)


def test_fused_query_jet_gradients_match_pallas():
    """d loss / d params and d loss / d latent for a loss mixing value,
    Jacobian and Hessian (as the PDE residual loss does): the autograd
    Function's backward (the plain twin on the CPU) vs the Pallas
    backward kernel."""
    model, params, tm = _pair()
    rng = np.random.RandomState(2)
    latent = rng.randn(1, 3, 4, 5, 8).astype(np.float32)
    pts = _edge_points(rng, 1, 24, 3)
    cot = [rng.randn(1, 24, 4, *([3] * i)).astype(np.float32)
           for i in range(3)]

    def jloss(p, lat):
        outs = _pallas(model, p, lat, jnp.asarray(pts))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cot))

    gp, gl = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params,
                                                       jnp.asarray(latent))
    lat_t = torch.from_numpy(latent).requires_grad_(True)
    outs = tfj.fused_query_jet(tm, lat_t, torch.from_numpy(pts))
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cot)).backward()
    np.testing.assert_allclose(lat_t.grad.numpy(), np.asarray(gl), rtol=3e-4,
                               atol=3e-3)
    want = state_dict_from_flax(tm, jax.tree.map(np.asarray, gp))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=3e-4, atol=5e-3, err_msg=name)


@pytest.mark.parametrize("slope", [0.01, 0.0])
def test_jet_bwd_plain_is_the_function_backward(slope):
    """On CPU tensors ``jet_bwd`` is autograd through ``jet_fwd_plain``,
    and the Function routes its cotangent there: the packed-parameter
    gradients from ``_Jet`` equal ``jet_bwd`` called directly."""
    _, _, tm = _pair(nf=4, seed=5)
    rng = np.random.RandomState(3)
    feats2 = torch.from_numpy(rng.randn(40 * 8, 8).astype(np.float32))
    frac = torch.from_numpy(rng.rand(40, 3).astype(np.float32))
    with torch.no_grad():
        packed = tfq.pack_imnet_params(tm)
    ybar = torch.from_numpy(rng.randn(40, 10, 4).astype(np.float32))
    dfeats, grads = tfj.jet_bwd(feats2, frac, packed, None, ybar, nf=4,
                                slope=slope)
    leaves = {k: v.clone().requires_grad_(True) for k, v in packed.items()}
    f = feats2.clone().requires_grad_(True)
    out = tfj._Jet.apply(4, slope, f, frac,
                         *[leaves[k] for k in tfq._WEIGHTS])
    (out * ybar).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), dfeats.numpy(), rtol=1e-6,
                               atol=1e-6)
    for k in tfq._WEIGHTS:
        np.testing.assert_allclose(leaves[k].grad.numpy(), grads[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_fused_jet_rejects():
    _, _, tm = _pair()
    lat, pts = torch.zeros(1, 3, 3, 3, 8), torch.zeros(1, 4, 3)
    with pytest.raises(NotImplementedError, match="f32"):
        tfj.fused_query_jet(tm, lat, pts, compute_dtype=torch.bfloat16)
    _, _, gelu = _pair(activation="gelu")
    with pytest.raises(ValueError, match="piecewise-linear"):
        tfj.fused_query_jet(gelu, lat, pts)
    with torch.no_grad():
        packed = tfq.pack_imnet_params(tm)
    feats2, frac = torch.zeros(32, 8), torch.zeros(4, 3)
    with pytest.raises(ValueError, match="ybar"):
        tfj.jet_bwd(feats2, frac, packed, None, torch.zeros(4, 9, 4), nf=2)
    with pytest.raises(ValueError, match="feats2"):
        tfj.jet_fwd(torch.zeros(30, 8), frac, packed, nf=2)
