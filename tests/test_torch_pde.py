"""The port's PDE layer (``physics/``) vs analytic derivatives and the
JAX package.

The ``dif`` DSL lowers through sympy to torch closures; its towers are
nested ``torch.func.jvp``. Analytic checks as ``tests/test_pde.py``;
RB2 residuals and ``residual_loss`` (l2, huber) against the JAX layer
on identical jet arrays (rtol 1e-5: the same f32 closed forms).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from space_time_pde_torch import physics as tphys
from space_time_pde_torch.physics.pde import PDELayer
from space_time_pde_tpu import physics as jphys
from space_time_pde_tpu.physics import systems as jsystems


def _analytic_fwd(coords):
    """u = sin(2 pi x) cos(3 z) exp(-t); w = x^2 z + t."""
    t, z, x = coords[..., 0], coords[..., 1], coords[..., 2]
    u = torch.sin(2 * np.pi * x) * torch.cos(3 * z) * torch.exp(-t)
    w = x ** 2 * z + t
    return torch.stack([u, w], dim=-1)


def _coords(n=40, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).rand(n, 3).astype(np.float32))


def test_first_and_second_derivatives_analytic():
    layer = PDELayer(in_vars="t, z, x", out_vars="u, w")
    layer.add_equation("dif(u, t)", name="u_t")
    layer.add_equation("dif(u, x)", name="u_x")
    layer.add_equation("dif(dif(u, x), x)", name="u_xx")
    layer.add_equation("dif(w, z)", name="w_z")
    layer.add_equation("dif(dif(w, x), z)", name="w_xz")
    layer.update_forward_method(_analytic_fwd)
    coords = _coords()
    res = layer(coords)
    t, z, x = (coords[..., i].numpy() for i in range(3))
    u = np.sin(2 * np.pi * x) * np.cos(3 * z) * np.exp(-t)
    np.testing.assert_allclose(res["u_t"].numpy(), -u, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        res["u_x"].numpy(),
        2 * np.pi * np.cos(2 * np.pi * x) * np.cos(3 * z) * np.exp(-t),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res["u_xx"].numpy(), -(2 * np.pi) ** 2 * u,
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(res["w_z"].numpy(), x ** 2, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(res["w_xz"].numpy(), 2 * x, rtol=1e-4,
                               atol=1e-5)


def test_product_rule_coordinates_and_functions():
    layer = PDELayer(in_vars="t, z, x", out_vars="u, w")
    layer.add_equation("dif(u*w, x) = dif(u, x)*w + u*dif(w, x)",
                       name="leibniz")
    layer.add_equation("w - x**2*z - t", name="forcing")
    layer.add_equation("tanh(u) - sinh(u)/cosh(u) + sqrt(w**2) - Abs(w)",
                       name="funcs")
    layer.update_forward_method(_analytic_fwd)
    res = layer(_coords(seed=1))
    for name in ("leibniz", "forcing", "funcs"):
        np.testing.assert_allclose(res[name].numpy(), 0.0, atol=1e-4)


def test_scaling_matches_unnormalized_reference():
    """Normalised fwd + set_scaling == physical fwd with no scaling."""
    ext = torch.tensor([2.0, 0.5, 4.0])
    mean = np.array([0.3, -1.2], np.float32)
    std = np.array([2.5, 0.7], np.float32)

    def fwd_norm(c):
        return (_analytic_fwd(c * ext) - torch.from_numpy(mean)) \
            / torch.from_numpy(std)

    eqs = [("e1", "dif(u, t) + dif(dif(w, x), x) * u"),
           ("e2", "dif(dif(u, z), z) - w + x")]
    ref, scaled = PDELayer("t, z, x", "u, w"), PDELayer("t, z, x", "u, w")
    for n, e in eqs:
        ref.add_equation(e, n)
        scaled.add_equation(e, n)
    coords = _coords(seed=3)
    want = ref(coords * ext, fwd=_analytic_fwd)
    scaled.set_scaling(coord_scales=(2.0, 0.5, 4.0), out_means=mean,
                       out_stds=std)
    got = scaled(coords, fwd=fwd_norm)
    for n, _ in eqs:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   rtol=5e-3, atol=5e-3)


def _rb2_pair(mean, std, ext):
    kw = dict(mean=mean, std=std, t_crop=ext[0], z_crop=ext[1],
              x_crop=ext[2], rayleigh=1e5, prandtl=0.7)
    return tphys.get_rb2_pde_layer(**kw), jphys.get_rb2_pde_layer(**kw)


@pytest.mark.parametrize("kind", ["l2", "huber"])
def test_rb2_residuals_and_loss_match_jax_on_a_jet(kind):
    """The same (outs, jac, hess) arrays through both layers: the four
    RB2 residuals, the per-equation penalties and their sum."""
    rng = np.random.RandomState(4)
    n = 64
    outs = rng.randn(2, n, 4).astype(np.float32)
    jac = (3 * rng.randn(2, n, 4, 3)).astype(np.float32)
    hess = rng.randn(2, n, 4, 3, 3).astype(np.float32)
    hess = (hess + np.swapaxes(hess, -1, -2)).astype(np.float32)
    coords = rng.rand(2, n, 3).astype(np.float32)
    mean = rng.randn(4).astype(np.float32)
    std = (0.5 + rng.rand(4)).astype(np.float32)
    tl, jl = _rb2_pair(mean, std, (0.75, 1.0 / 8, 1.0 / 16))
    tjet = tuple(torch.from_numpy(a) for a in (outs, jac, hess))
    jjet = tuple(jnp.asarray(a) for a in (outs, jac, hess))
    got = tl(torch.from_numpy(coords), jet=tjet)
    want = jl(jnp.asarray(coords), jet=jjet)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5 *
                                   float(np.abs(want[k]).max()), err_msg=k)
    gt, gper = tl.residual_loss(torch.from_numpy(coords), jet=tjet,
                                kind=kind)
    wt, wper = jl.residual_loss(jnp.asarray(coords), jet=jjet, kind=kind)
    np.testing.assert_allclose(float(gt), float(wt), rtol=1e-5)
    for k in wper:
        np.testing.assert_allclose(float(gper[k]), float(wper[k]),
                                   rtol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="unknown pde loss kind"):
        tl.residual_loss(torch.from_numpy(coords), jet=tjet, kind="l3")


def test_huber_bounds_influence():
    layer = tphys.get_rb2_pde_layer()
    coords = _coords(seed=3)

    def fwd(s):
        return lambda c: s * torch.stack(
            [torch.sin(c[..., 0]), c[..., 1] ** 2, c[..., 2],
             c[..., 0] * c[..., 1]], dim=-1)

    l2, _ = layer.residual_loss(coords, fwd=fwd(1.0), kind="l2")
    hu, _ = layer.residual_loss(coords, fwd=fwd(1.0), kind="huber",
                                huber_delta=1e6)
    np.testing.assert_allclose(float(hu), 0.5 * float(l2), rtol=1e-5)
    l2_big, _ = layer.residual_loss(coords, fwd=fwd(1e6), kind="l2")
    hu_big, _ = layer.residual_loss(coords, fwd=fwd(1e6), kind="huber")
    assert float(hu_big) < 1e-6 * float(l2_big)


def test_systems_registry_matches_jax():
    """Same systems, equation names, derivative orders and residuals on
    a jet; unknown names raise."""
    assert tphys.available_systems() == jsystems.available_systems()
    rng = np.random.RandomState(5)
    for name in tphys.available_systems():
        t, j = tphys.get_pde_layer(name), jsystems.get_pde_layer(name)
        assert t.equation_names == j.equation_names, name
        assert t.max_derivative_order() == j.max_derivative_order() == 2
        d = len(t.in_var_names)
        arrays = (rng.randn(8, 4), rng.randn(8, 4, d), rng.randn(8, 4, d, d))
        arrays = [a.astype(np.float32) for a in arrays]
        coords = rng.rand(8, d).astype(np.float32)
        got = t(torch.from_numpy(coords),
                jet=tuple(torch.from_numpy(a) for a in arrays))
        want = j(jnp.asarray(coords), jet=tuple(jnp.asarray(a)
                                                for a in arrays))
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    with pytest.raises(KeyError):
        tphys.get_pde_layer("nope")
