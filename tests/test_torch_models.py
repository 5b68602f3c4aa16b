"""Port parity: ImNet, UNet3d and the LIG query vs the flax models.

Weights come from a flax init and cross through the port's bridge;
inputs are numpy draws from fixed seeds. Tolerances: ImNet rtol 2e-5
(f32 matmuls summed in another order); UNet3d rtol 1e-4 / atol 1e-5
(a deep conv stack, GroupNorm/BatchNorm statistics summed in another
order).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from space_time_pde_torch.bridge import load_flax_params
from space_time_pde_torch.models import ImNet as TImNet
from space_time_pde_torch.models import UNet3d as TUNet3d
from space_time_pde_torch.models import query_local_implicit_grid as tquery
from space_time_pde_torch.models.nonlinearities import (
    NONLINEARITIES as TACTS, get_activation as tact)
from space_time_pde_torch.models.unet3d import same_pad
from space_time_pde_tpu.models import ImNet, UNet3d, query_local_implicit_grid
from space_time_pde_tpu.models.nonlinearities import (
    NONLINEARITIES as JACTS, PIECEWISE_LINEAR, get_activation as jact)
from space_time_pde_torch.models.nonlinearities import (
    PIECEWISE_LINEAR as TPIECEWISE)


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("name", sorted(JACTS))
def test_activations_match_jax(name):
    """atol 1e-6: XLA's and torch's tanh/exp differ by a few ulp, which
    1 + tanh(..) turns into ~6e-7 absolute in gelu's negative tail."""
    x = np.linspace(-25, 25, 2001, dtype=np.float32)
    np.testing.assert_allclose(
        _np(tact(name, 0.02)(torch.from_numpy(x))),
        np.asarray(jact(name, 0.02)(jnp.asarray(x))), rtol=2e-6, atol=1e-6)


def test_registry_matches_jax():
    assert list(TACTS) == list(JACTS)
    assert TPIECEWISE == PIECEWISE_LINEAR


@pytest.mark.parametrize("activation", ["leaky_relu", "gelu"])
def test_imnet_matches_flax(activation):
    model = ImNet(dim=3, in_features=8, out_features=4, nf=4,
                  activation=activation)
    params = model.init(jax.random.PRNGKey(0), jnp.ones((1, 11)))["params"]
    tm = load_flax_params(TImNet(3, 8, 4, 4, activation), params)
    x = np.random.RandomState(1).randn(5, 8, 11).astype(np.float32)
    np.testing.assert_allclose(
        _np(tm(torch.from_numpy(x))),
        np.asarray(model.apply({"params": params}, jnp.asarray(x))),
        rtol=2e-5, atol=1e-6)


def test_query_local_implicit_grid_matches_jax():
    model = ImNet(dim=3, in_features=4, out_features=4, nf=2)
    params = model.init(jax.random.PRNGKey(3), jnp.ones((1, 7)))["params"]
    tm = load_flax_params(TImNet(3, 4, 4, 2), params)
    rng = np.random.RandomState(4)
    grid = rng.randn(2, 3, 4, 5, 4).astype(np.float32)
    pts = rng.rand(2, 30, 3).astype(np.float32)
    want = query_local_implicit_grid(
        lambda v: model.apply({"params": params}, v), jnp.asarray(grid),
        jnp.asarray(pts))
    got = tquery(tm, torch.from_numpy(grid), torch.from_numpy(pts))
    np.testing.assert_allclose(_np(got), np.asarray(want),
                               rtol=2e-5, atol=2e-6)


def _unet_pair(norm, igres, seed=0):
    kw = dict(in_features=4, out_features=8, igres=igres, nf=4, mf=16,
              norm=norm)
    model = UNet3d(**kw)
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *igres, 4).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    batch_stats = variables.get("batch_stats")
    if batch_stats is not None:
        # Non-trivial running statistics (init gives mean 0, var 1).
        batch_stats = jax.tree.map(
            lambda a: np.asarray(a) + rng.rand(*a.shape).astype(np.float32),
            batch_stats)
        variables = dict(variables, batch_stats=batch_stats)
    tm = load_flax_params(TUNet3d(**kw), variables["params"], batch_stats)
    return model, variables, tm.eval(), x


@pytest.mark.parametrize("norm", ["group", "batch"])
@pytest.mark.parametrize("igres", [(4, 8, 8), (4, 8, 16)])
def test_unet3d_matches_flax(norm, igres):
    model, variables, tm, x = _unet_pair(norm, igres)
    want = model.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("size", [(4, 8, 16), (5, 7, 6)])
def test_strided_same_conv_matches_flax(size):
    """XLA "SAME" pads (0, 1) at even sizes and (1, 1) at odd ones."""
    conv = fnn.Conv(6, (3, 3, 3), strides=(2, 2, 2), padding="SAME")
    rng = np.random.RandomState(7)
    x = rng.randn(1, *size, 3).astype(np.float32)
    params = conv.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = conv.apply({"params": params}, jnp.asarray(x))
    tconv = torch.nn.Conv3d(3, 6, 3, stride=2)
    load_flax_params(tconv, params)
    with torch.no_grad():
        got = tconv(same_pad(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                             3, 2)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(_np(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_unet3d_rejects_wrong_igres():
    with pytest.raises(ValueError, match="igres"):
        TUNet3d(igres=(4, 8, 8))(torch.zeros(1, 4, 8, 16, 4))
    with pytest.raises(ValueError, match="divisible"):
        TUNet3d(igres=(4, 6, 8))
