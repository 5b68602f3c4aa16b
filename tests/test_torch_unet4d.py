"""Port parity: UNet4d and its factorized Conv4d vs the flax modules.

Weights come from a flax init (or a seeded draw) and cross through the
port's bridge; inputs are numpy draws from fixed seeds. Tolerances:
rtol 1e-4 / atol 1e-5 for the whole encoder (a deep factorized conv
stack, GroupNorm statistics summed in another order), 1e-5 for one
Conv4d.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from space_time_pde_torch.bridge import (
    flatten_tree, load_flax_params, seeded_flax_params,
    state_dict_from_flax)
from space_time_pde_torch.models import Conv4d as TConv4d
from space_time_pde_torch.models import UNet4d as TUNet4d
from space_time_pde_torch.train import flax_init_
from space_time_pde_tpu.models import UNet4d
from space_time_pde_tpu.models.unet4d import Conv4d


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("stride,size", [(1, (3, 4, 5, 6)), (2, (4, 8, 8, 8)),
                                         (2, (5, 7, 6, 3))])
def test_conv4d_matches_flax(stride, size):
    """Strided "SAME" pads (0, 1) at even sizes on both factors, the
    spatial 3x3x3 and the temporal size-3 conv."""
    conv = Conv4d(6, 3, 3, strides=(stride,) * 4)
    rng = np.random.RandomState(2)
    x = rng.randn(2, *size, 3).astype(np.float32)
    params = conv.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = conv.apply({"params": params}, jnp.asarray(x))
    tconv = load_flax_params(TConv4d(3, 6, 3, 3, stride=stride), params)
    with torch.no_grad():
        got = tconv(torch.from_numpy(x).permute(0, 5, 1, 2, 3, 4))
    got = got.permute(0, 2, 3, 4, 5, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# igres (4, 4, 4, 4): two stride-2 levels; nf 3 gives odd channel counts
# (GroupNorm groups 1, necks of 1 channel); every up_res block has a
# `proj` shortcut (2 ch in, ch out).
UNET_CASES = [dict(igres=(4, 4, 4, 4), nf=3, mf=8, out_features=5),
              dict(igres=(2, 4, 4, 4), nf=4, mf=16, out_features=8),
              dict(igres=(4, 8, 8, 8), nf=8, mf=8, out_features=4)]


@pytest.mark.parametrize("case", UNET_CASES,
                         ids=[str(c["igres"]) for c in UNET_CASES])
def test_unet4d_matches_flax(case):
    model = UNet4d(in_features=4, **case)
    rng = np.random.RandomState(0)
    x = rng.randn(2, *case["igres"], 4).astype(np.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    # Seeded weights, with non-trivial GroupNorm scales and biases.
    shapes = {k: v.shape for k, v in flatten_tree(params).items()}
    params = seeded_flax_params(shapes, 3)
    want = model.apply({"params": params}, jnp.asarray(x))
    tm = load_flax_params(TUNet4d(in_features=4, **case), params)
    if case["nf"] == 3:
        assert any(isinstance(m, nn.GroupNorm) and m.num_groups == 1
                   for m in tm.modules())
    assert all(getattr(tm, f"up_res{i}").proj is not None
               for i in range(tm.levels))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_unet4d_names_map_one_to_one():
    """Every flax leaf has a torch parameter and vice versa (the bridge
    raises otherwise); the temporal conv crosses as [O, I, k]."""
    case = UNET_CASES[0]
    model = UNet4d(in_features=4, **case)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, *case["igres"], 4)))["params"]
    tm = TUNet4d(in_features=4, **case)
    sd = state_dict_from_flax(tm, params)
    assert set(sd) == set(tm.state_dict())
    k = np.asarray(params["conv_in"]["temporal"]["kernel"])    # [k, I, O]
    np.testing.assert_array_equal(
        sd["conv_in.temporal.weight"].numpy(), np.transpose(k, (2, 1, 0)))
    assert "conv_in.spatial.bias" not in sd


def test_unet4d_rejects_wrong_igres():
    with pytest.raises(ValueError, match="igres"):
        TUNet4d(igres=(4, 8, 8, 8))(torch.zeros(1, 4, 8, 8, 4, 4))
    with pytest.raises(ValueError, match="divisible"):
        TUNet4d(igres=(4, 6, 8, 8))


def test_flax_init_conv1d_statistics():
    """Conv1d kernels draw lecun-normal with fan_in = I * k, biases 0,
    as flax initialises the temporal conv."""
    conv = nn.Conv1d(48, 48, 3)
    flax_init_(conv, torch.Generator().manual_seed(0))
    w = conv.weight.detach().numpy()
    assert float(np.abs(conv.bias.detach().numpy()).max()) == 0.0
    std = np.sqrt(1.0 / (48 * 3))
    assert abs(w.std() / std - 1.0) < 0.05
    assert np.abs(w).max() <= 2.0 * std / 0.87962566103423978 + 1e-7
    flax = Conv4d(48, 3, 3).init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 2, 3, 3, 3, 64)))["params"]
    fk = np.asarray(flax["temporal"]["kernel"])          # [3, 48, 48]
    assert abs(fk.std() / w.std() - 1.0) < 0.05
