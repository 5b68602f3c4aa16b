"""The turb3d encoder's temporal product, summed in float64 and rounded
once (``models/unet4d.py::_TimeProduct``), against the flax modules.

On an H100 the f32 rounding of that product put the turb3d training
step's gradients a median 1.73x JAX f32's distance from float64
(``scripts/turb3d_grad_attribution.py``). Here, on the CPU, one
``Conv4d`` and a small ``UNet4d`` take the same numpy-seeded inputs,
weights and output cotangent as their flax counterparts:

- the port's output and gradients against JAX f32's, within
  ``tests/test_fused_jet.py``'s gradient tolerances (rtol 3e-4; atol
  3e-3 for the input's gradient, 5e-3 for the parameters');
- each one's relative L2 distance from the port's float64 recomputation
  of the same module, at most ``SLACK`` times JAX f32's (the card's rule,
  ``chip_smoke.py`` phase 14's ``STEP_MEDIAN``, holds the median of
  those ratios over the step's leaves to 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from space_time_pde_torch.bridge import (
    flatten_tree, load_flax_params, seeded_flax_params,
    state_dict_from_flax)
from space_time_pde_torch.models import Conv4d as TConv4d
from space_time_pde_torch.models import UNet4d as TUNet4d
from space_time_pde_tpu.models import UNet4d
from space_time_pde_tpu.models.unet4d import Conv4d

SLACK = 2.0
RTOL, ATOL_INPUT, ATOL_PARAMS = 3e-4, 3e-3, 5e-3


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _port(module, x, cot, dtype):
    """(output, d input, {param: grad}) of ``module`` in ``dtype`` on
    channels-last ``x`` for the output cotangent ``cot``."""
    module = module.to(dtype)
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    y = module(xt)
    (y * torch.from_numpy(cot).to(dtype)).sum().backward()
    grads = {k: p.grad.double().numpy() for k, p in module.named_parameters()}
    return y.detach().double().numpy(), xt.grad.double().numpy(), grads


def _jax(model, params, x, cot):
    @jax.jit
    def run(p, v, c):
        y, vjp = jax.vjp(lambda p, v: model.apply({"params": p}, v), p, v)
        return (y, *vjp(c))

    y, gp, gx = run(params, jnp.asarray(x), jnp.asarray(cot))
    return np.asarray(y), np.asarray(gx), jax.tree.map(np.asarray, gp)


def _check(name, got32, jax32, got64, jax_atol):
    """``got32`` against JAX f32, then both against float64."""
    np.testing.assert_allclose(got32, jax32, rtol=RTOL,
                               atol=jax_atol * float(np.abs(jax32).max()),
                               err_msg=name)
    port, ref = _rel(got32, got64), _rel(jax32, got64)
    print(f"  {name:28s} rel-L2 from float64: port {port:.3e}, JAX f32 "
          f"{ref:.3e} ({port / ref:.2f}x)")
    return port, ref


class _ChannelsLast(torch.nn.Module):
    """``Conv4d`` on channels-last input and output, as flax's."""

    def __init__(self, conv):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        return self.conv(x.permute(0, 5, 1, 2, 3, 4)).permute(
            0, 2, 3, 4, 5, 1)


@pytest.mark.parametrize("stride,size,kt", [(1, (4, 8, 8, 8), 3),
                                            (2, (4, 8, 8, 8), 3),
                                            (1, (4, 8, 8, 8), 1)])
def test_conv4d_gradients_match_jax_and_float64(stride, size, kt):
    """One Conv4d (16 -> 16 channels, the temporal product's K = 48 or
    16, 4,096 or 512 rows): output, input gradient and both factors'
    weight and bias gradients."""
    conv = Conv4d(16, kt, kt, strides=(stride,) * 4)
    rng = np.random.RandomState(7)
    x = rng.randn(2, *size, 16).astype(np.float32)
    shapes = {k: v.shape for k, v in flatten_tree(conv.init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"]).items()}
    params = seeded_flax_params(shapes, 11)
    y_shape = conv.apply({"params": params}, jnp.asarray(x)).shape
    cot = rng.randn(*y_shape).astype(np.float32)
    y32, gx32, gp32 = _jax(conv, params, x, cot)

    def port(dtype):
        module = _ChannelsLast(load_flax_params(
            TConv4d(16, 16, kt, kt, stride=stride), params))
        y, gx, g = _port(module, x, cot, dtype)
        return y, gx, {k[len("conv."):]: v for k, v in g.items()}

    ty, tgx, tg = port(torch.float32)
    ty64, tgx64, tg64 = port(torch.float64)
    want = state_dict_from_flax(TConv4d(16, 16, kt, kt, stride=stride),
                                gp32)
    ratios = [_check("output", ty, y32, ty64, 1e-5),
              _check("d input", tgx, gx32, tgx64, ATOL_INPUT)]
    for k in tg:
        ratios.append(_check(k, tg[k], want[k].numpy(), tg64[k],
                             ATOL_PARAMS))
    for (port_d, ref_d), name in zip(
            ratios, ["output", "d input", *tg]):
        assert port_d <= SLACK * ref_d, name


def test_unet4d_gradients_match_jax_and_float64():
    """A small UNet4d (igres (2, 8, 8, 8), nf 8, mf 16: one level, every
    block's GroupNorm after a temporal product): output and input
    gradient within SLACK of JAX f32's distance from float64, and the
    median over the parameter leaves of the ratio of those distances
    within SLACK (a leaf's own ratio is a draw of few rounding events:
    the card's step rule holds the median, ``chip_smoke.py`` phase 14).
    Neither f32 path takes another LeakyReLU branch than float64 here; at
    igres (4, 8, 8, 8) one of them does (JAX f32's input gradient sat
    0.8% from float64 with these seeds, the port's with nf 16), and such
    a flip moves a gradient by a finite step, not by rounding."""
    case = dict(igres=(2, 8, 8, 8), nf=8, mf=16, out_features=8)
    model = UNet4d(in_features=4, **case)
    rng = np.random.RandomState(3)
    x = (0.5 * rng.randn(2, *case["igres"], 4)).astype(np.float32)
    shapes = {k: v.shape for k, v in flatten_tree(model.init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"]).items()}
    params = seeded_flax_params(shapes, 5)
    cot = rng.randn(2, *case["igres"], 8).astype(np.float32)
    y32, gx32, gp32 = _jax(model, params, x, cot)

    def port(dtype):
        return _port(load_flax_params(TUNet4d(in_features=4, **case),
                                      params), x, cot, dtype)

    ty, tgx, tg = port(torch.float32)
    ty64, tgx64, tg64 = port(torch.float64)
    want = state_dict_from_flax(TUNet4d(in_features=4, **case), gp32)
    for name, got, ref, got64, atol in (
            ("output", ty, y32, ty64, 1e-5),
            ("d input", tgx, gx32, tgx64, ATOL_INPUT)):
        port_d, ref_d = _check(name, got, ref, got64, atol)
        assert port_d <= SLACK * ref_d, name
    top = max(float(np.abs(g).max()) for g in tg64.values())
    ratios = []
    for k in tg:
        w = want[k].numpy()
        np.testing.assert_allclose(
            tg[k], w, rtol=RTOL,
            atol=ATOL_PARAMS * float(np.abs(w).max()) + 1e-6 * top,
            err_msg=k)
        # A conv bias right before a GroupNorm has a gradient of 0 up to
        # rounding: its distance is noise over noise.
        if np.abs(tg64[k]).max() > 1e-5 * top:
            ratios.append(_rel(tg[k], tg64[k]) / _rel(w, tg64[k]))
    print(f"  {len(ratios)} leaves: rel-L2 from float64 over JAX f32's, "
          f"median {np.median(ratios):.2f}, max {max(ratios):.2f}")
    assert np.median(ratios) <= SLACK
