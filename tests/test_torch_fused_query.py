"""Port parity: the fused decode's plain PyTorch twins vs the Pallas
kernels (interpret mode on the CPU).

Both packages get the same numpy inputs and bridged ImNet weights.
Tolerance rtol = atol = 2e-5, as ``tests/test_fused_query.py``: f32
throughout, only the summation order differs. On CPU tensors the
wrappers run the plain twins, so the launch counters must stay 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from space_time_pde_torch.bridge import load_flax_params
from space_time_pde_torch.models import ImNet as TImNet
from space_time_pde_torch.ops import fused_query as tfq
from space_time_pde_torch.ops import grid_interp as tgi
from space_time_pde_tpu.models import ImNet
from space_time_pde_tpu.ops import fused_query as jfq

TOL = dict(rtol=2e-5, atol=2e-5)


def _pair(nf, c, activation="leaky_relu", seed=0, dim=3):
    model = ImNet(dim=dim, in_features=c, out_features=4, nf=nf,
                  activation=activation)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.ones((1, dim + c)))["params"]
    tm = load_flax_params(TImNet(dim, c, 4, nf, activation), params)
    return model, params, tm


def test_pack_imnet_params_matches_jax():
    model, params, tm = _pair(nf=4, c=8)
    want = jfq.pack_imnet_params(params, 3, 8, 4, dtype=jnp.float32,
                                 pad_to=0)
    got = tfq.pack_imnet_params(tm)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("dim", [2, 3])
def test_cell_major_features_and_flat_cells_match_jax(dim):
    rng = np.random.RandomState(dim)
    spatial = (3, 4, 5)[:dim]
    grid = rng.randn(*spatial, 2).astype(np.float32)
    np.testing.assert_array_equal(
        tfq.cell_major_features(torch.from_numpy(grid)).numpy(),
        np.asarray(jfq.cell_major_features(jnp.asarray(grid))))
    cell = np.stack([rng.randint(0, s - 1, 30) for s in spatial], -1)
    np.testing.assert_array_equal(
        tfq._flat_cells(torch.from_numpy(cell.astype(np.int32)),
                        spatial).numpy(),
        np.asarray(jfq._flat_cells(jnp.asarray(cell, jnp.int32), spatial)))


@pytest.mark.parametrize("activation", ["leaky_relu", "relu", "gelu"])
@pytest.mark.parametrize("n", [50, 64])
def test_decode_blend_plain_matches_pallas(activation, n):
    model, params, tm = _pair(nf=4, c=8, activation=activation, seed=1)
    rng = np.random.RandomState(2)
    feats = rng.randn(n * 8, 8).astype(np.float32)
    frac = rng.rand(n, 3).astype(np.float32)
    frac[:5] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1], [0.5, 0, 1]]
    packed_j = jfq.pack_imnet_params(params, 3, 8, 4, dtype=jnp.float32,
                                     pad_to=0)
    want = jfq.fused_decode_blend(
        jnp.asarray(feats), jnp.asarray(frac), packed_j, nf=4, n_corners=8,
        compute_dtype=jnp.float32, block_pts=16, pad_to=0, interpret=True,
        activation=activation)
    tfq.reset_launches()
    got = tfq.decode_blend(torch.from_numpy(feats), torch.from_numpy(frac),
                           tfq.pack_imnet_params(tm), nf=4, n_corners=8,
                           activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tfq.LAUNCHES == {"decode_blend_gather": 0, "decode_blend": 0,
                           "decode_blend_gather_bf16": 0}


QUERY_CASES = [
    # (latent spatial, xmin, xmax, activation)
    ((3, 3, 3), 0.0, 1.0, "leaky_relu"),
    ((3, 4, 6), (-1.0, 0.0, 2.0), (1.0, 2.0, 3.0), "relu"),
    ((4, 3, 5), 0.0, 1.0, "gelu"),
]


@pytest.mark.parametrize("gather", ["kernel", "pregather"])
@pytest.mark.parametrize("spatial,xmin,xmax,activation", QUERY_CASES)
def test_fused_query_matches_pallas(gather, spatial, xmin, xmax,
                                    activation):
    """Edge cells, domain faces, out-of-domain points, non-unit domain."""
    model, params, tm = _pair(nf=2, c=4, activation=activation, seed=3)
    rng = np.random.RandomState(4)
    grid = rng.randn(1, *spatial, 4).astype(np.float32)
    lo, hi = np.broadcast_to(xmin, (3,)), np.broadcast_to(xmax, (3,))
    unit = np.concatenate([
        rng.rand(40, 3),
        [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [0, 1, 0.5],
         [1.2, -0.1, 0.5], [0.25, 0.75, 0.999]],
    ])
    pts = (lo + (hi - lo) * unit).astype(np.float32)[None]
    want = jfq.fused_query_local_implicit_grid(
        model, params, jnp.asarray(grid), jnp.asarray(pts), xmin=xmin,
        xmax=xmax, compute_dtype=jnp.float32, pad_to=0, block_pts=16,
        interpret=True, gather=gather)
    tfq.reset_launches()
    got = tfq.fused_query_local_implicit_grid(
        tm, torch.from_numpy(grid), torch.from_numpy(pts), xmin=xmin,
        xmax=xmax, gather=gather)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tfq.LAUNCHES == {"decode_blend_gather": 0, "decode_blend": 0,
                           "decode_blend_gather_bf16": 0}


def test_wrappers_reject_bad_inputs():
    _, _, tm = _pair(nf=2, c=4)
    packed = tfq.pack_imnet_params(tm)
    table = torch.zeros(6, 32)
    frac = torch.zeros(5, 3)
    cells = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(TypeError, match="cell_flat"):
        tfq.decode_blend_gather(table, cells.long(), frac, packed, nf=2)
    with pytest.raises(ValueError, match="contiguous"):
        tfq.decode_blend_gather(table, cells, torch.zeros(3, 5).t(),
                                packed, nf=2)
    with pytest.raises(ValueError, match="wx_feat"):
        tfq.decode_blend_gather(torch.zeros(6, 40), cells, frac, packed,
                                nf=2)
    with pytest.raises(ValueError, match="n_corners"):
        tfq.decode_blend(torch.zeros(20, 4), frac, packed, nf=2,
                         n_corners=4)
    # bf16: the gather entry takes a bf16 table (an f32 one raises); the
    # pre-gathered entry has no bf16 instantiation and says where it is
    # queued.
    with pytest.raises(TypeError, match="table"):
        tfq.decode_blend_gather(table, cells, frac, packed, nf=2,
                                compute_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfq.decode_blend(torch.zeros(40, 4, dtype=torch.bfloat16), frac,
                         packed, nf=2, n_corners=8,
                         compute_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfq.fused_query_local_implicit_grid(
            tm, torch.zeros(1, 2, 2, 2, 4), torch.zeros(1, 3, 3),
            gather="pregather", compute_dtype=torch.bfloat16)


@pytest.mark.parametrize("dim", [2, 3])
def test_packing_carries_gradients_to_imnet(dim):
    """The jet kernels' packed-parameter gradients reach fc0..fc5: grads
    through ``pack_imnet_params`` + the plain decode equal grads through
    ``ImNet`` applied per corner (the corner-bias fold included)."""
    _, _, tm = _pair(nf=2, c=4, dim=dim, seed=6)
    rng = np.random.RandomState(7)
    n, k = 30, 2 ** dim
    feats = torch.from_numpy(rng.randn(n, k, 4).astype(np.float32))
    frac = torch.from_numpy(rng.rand(n, dim).astype(np.float32))
    cot = torch.from_numpy(rng.randn(n, 4).astype(np.float32))

    offs = torch.as_tensor(tgi.corner_offsets(dim), dtype=torch.float32)
    rel = frac[:, None, :] - offs[None]
    out = torch.einsum("nko,nk->no", tm(torch.cat([rel, feats], -1)),
                       tfq._corner_weights(frac))
    want = torch.autograd.grad((out * cot).sum(), list(tm.parameters()))
    got_out = tfq.decode_blend_plain(feats.reshape(-1, 4), frac,
                                     tfq.pack_imnet_params(tm), nf=2,
                                     n_corners=k)
    got = torch.autograd.grad((got_out * cot).sum(), list(tm.parameters()))
    for (name, _), g, w in zip(tm.named_parameters(), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
