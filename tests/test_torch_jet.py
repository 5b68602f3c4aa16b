"""Port parity: the analytic jet (``ops/jet.py``) and the face
derivative (``grid_interp.locate_dfrac``) vs the JAX package.

Same numpy inputs and bridged ImNet weights through both packages.
Tolerances as ``tests/test_fused_jet.py``: value rtol 2e-4 / atol 2e-5,
Jacobian 2e-4 / 2e-4, Hessian 2e-4 / 2e-3 (f32; the Hessian adds the
second-derivative weights of up to 16 corners).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from space_time_pde_torch.bridge import load_flax_params
from space_time_pde_torch.models import ImNet as TImNet
from space_time_pde_torch.models import query_local_implicit_grid as tquery
from space_time_pde_torch.ops import grid_interp as tgi
from space_time_pde_torch.ops import jet as tjet
from space_time_pde_torch.physics.pde import PDELayer as TPDELayer
from space_time_pde_tpu.models import ImNet
from space_time_pde_tpu.ops import grid_interp as jgi
from space_time_pde_tpu.ops import jet as jjet

TOLS = [dict(rtol=2e-4, atol=2e-5), dict(rtol=2e-4, atol=2e-4),
        dict(rtol=2e-4, atol=2e-3)]
SPATIAL = {2: (5, 6), 3: (4, 5, 6), 4: (3, 4, 3, 5)}


def _pair(dim, lat=8, nf=4, seed=0, activation="leaky_relu"):
    model = ImNet(dim=dim, in_features=lat, out_features=4, nf=nf,
                  activation=activation)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, dim + lat)))["params"]
    tm = load_flax_params(TImNet(dim, lat, 4, nf, activation), params)
    return model, params, tm


def _face_points(rng, dim, n):
    """Uniform points plus points exactly on faces, corners, outside."""
    pts = rng.rand(n, dim).astype(np.float32)
    pts[0] = 0.0
    pts[1] = 1.0
    pts[2, 0] = 1.0
    pts[3, -1] = 0.0
    pts[4] = np.linspace(-0.2, 1.2, dim)
    pts[5, 0] = -0.5
    return pts


def _close(got, want):
    for g, w, tol in zip(got, want, TOLS):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("dim", [2, 3, 4])
def test_multilinear_weight_jet_matches_jax(dim):
    frac = np.random.RandomState(dim).rand(30, dim).astype(np.float32)
    frac[:3] = np.array([0.0, 1.0, 0.5])[:, None]
    got = tjet.multilinear_weight_jet(torch.from_numpy(frac))
    want = jjet.multilinear_weight_jet(jnp.asarray(frac))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("dim", [2, 3, 4])
@pytest.mark.parametrize("xmin,xmax", [(0.0, 1.0), (-1.0, 2.5)])
def test_face_derivative_matches_jax_jvp(dim, xmin, xmax):
    """d frac / d p: the grid scale inside, half of it exactly on a clip
    bound, 0 outside -- JAX's jvp through ``jnp.clip``. Both the closed
    form and torch's jvp through the port's ``_locate`` must give it
    (``torch.clamp`` would give the full scale on the faces)."""
    spatial = SPATIAL[dim]
    unit = _face_points(np.random.RandomState(dim), dim, 40)
    pts = (xmin + (xmax - xmin) * unit).astype(np.float32)
    # Exactly on the faces after the affine map.
    pts[0], pts[1] = xmin, xmax
    want = []
    for a in range(dim):
        tan = np.zeros_like(pts)
        tan[:, a] = 1.0
        _, t = jax.jvp(lambda q: jgi._locate(q, spatial, xmin, xmax)[1],
                       (jnp.asarray(pts),), (jnp.asarray(tan),))
        want.append(np.asarray(t)[:, a])
    want = np.stack(want, -1)
    top = np.asarray(spatial) - 1.0
    assert np.any(np.isclose(want, 0.5 * top / (xmax - xmin))), "no face"
    p = torch.from_numpy(pts)
    got = tgi.locate_dfrac(p, spatial, xmin, xmax)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    via_jvp = torch.stack([
        torch.func.jvp(lambda q: tgi._locate(q, spatial, xmin, xmax)[1],
                       (p,), (torch.eye(dim)[a].expand_as(p),))[1][:, a]
        for a in range(dim)], -1)
    np.testing.assert_allclose(via_jvp.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dim,activation", [(2, "leaky_relu"),
                                            (3, "leaky_relu"),
                                            (3, "relu"),
                                            (4, "leaky_relu")])
def test_query_jet_matches_jax(dim, activation):
    """Value, Jacobian and Hessian in pts units, face points included:
    the 0.5 face derivative enters the Jacobian once and the Hessian
    twice."""
    model, params, tm = _pair(dim, seed=dim, activation=activation)
    rng = np.random.RandomState(10 + dim)
    grid = rng.randn(2, *SPATIAL[dim], 8).astype(np.float32)
    pts = np.stack([_face_points(rng, dim, 24) for _ in range(2)])
    want = jjet.query_local_implicit_grid_jet(
        lambda v: model.apply({"params": params}, v), jnp.asarray(grid),
        jnp.asarray(pts))
    got = tjet.query_local_implicit_grid_jet(tm, torch.from_numpy(grid),
                                             torch.from_numpy(pts))
    _close(got, want)


def test_query_jet_matches_port_towers():
    """The jet against nested ``torch.func.jvp`` towers through the
    port's plain query (the PDE layer's tower mode), faces included."""
    _, _, tm = _pair(3, seed=4)
    rng = np.random.RandomState(5)
    grid = torch.from_numpy(rng.randn(1, 4, 5, 6, 8).astype(np.float32))
    pts = torch.from_numpy(_face_points(rng, 3, 32)[None])
    value, jac, hess = tjet.query_local_implicit_grid_jet(tm, grid, pts)

    layer = TPDELayer(in_vars="t, z, x", out_vars="p, b, u, w")
    names = "tzx"
    for c in "pbuw":
        for a in range(3):
            layer.add_equation(f"dif({c}, {names[a]})", name=f"{c}_{a}")
            for b in range(a, 3):
                layer.add_equation(
                    f"dif(dif({c}, {names[a]}), {names[b]})",
                    name=f"{c}_{a}{b}")
    res, outs = layer(pts, return_outs=True,
                      fwd=lambda q: tquery(tm, grid, q))
    np.testing.assert_allclose(value.detach().numpy(),
                               outs.detach().numpy(), **TOLS[0])
    for ci, c in enumerate("pbuw"):
        for a in range(3):
            np.testing.assert_allclose(
                jac[..., ci, a].detach().numpy(),
                res[f"{c}_{a}"].detach().numpy(), **TOLS[1])
            for b in range(a, 3):
                np.testing.assert_allclose(
                    hess[..., ci, a, b].detach().numpy(),
                    res[f"{c}_{a}{b}"].detach().numpy(), **TOLS[2])
