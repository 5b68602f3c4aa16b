"""Port parity: space_time_pde_torch.ops.grid_interp vs the JAX module.

Same numpy inputs through both; points include nodes, cell faces,
the domain faces and out-of-domain points (clamped). Tolerance 1e-6:
the two compute the same f32 operations in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from space_time_pde_torch.ops import grid_interp as tgi
from space_time_pde_tpu.ops import grid_interp as jgi

TOL = dict(rtol=1e-6, atol=1e-6)


def _points(rng, spatial, n, xmin, xmax):
    """Random points plus every node, faces and out-of-domain points."""
    dim = len(spatial)
    lo, hi = np.broadcast_to(xmin, (dim,)), np.broadcast_to(xmax, (dim,))
    span = hi - lo
    pts = [lo + span * rng.rand(n, dim)]
    nodes = np.stack(np.meshgrid(*[np.linspace(0, 1, s) for s in spatial],
                                 indexing="ij"), -1).reshape(-1, dim)
    pts.append(lo + span * nodes)
    pts.append(lo + span * rng.choice([0.0, 1.0, 0.5, -0.2, 1.3],
                                      size=(n, dim)))
    return np.concatenate(pts).astype(np.float32)


CASES = [
    ((5, 7), 0.0, 1.0),
    ((4, 5, 6), 0.0, 1.0),
    ((3, 4, 9), (-1.0, 0.5, 2.0), (1.0, 2.0, 5.0)),
]


@pytest.mark.parametrize("spatial,xmin,xmax", CASES)
def test_locate_and_coefficients_match_jax(spatial, xmin, xmax):
    rng = np.random.RandomState(len(spatial))
    grid = rng.randn(*spatial, 3).astype(np.float32)
    pts = _points(rng, spatial, 64, xmin, xmax)

    jc, jf = jgi._locate(jnp.asarray(pts), spatial, xmin, xmax)
    tc, tf = tgi._locate(torch.from_numpy(pts), spatial, xmin, xmax)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)

    want = jgi.grid_interp_coefficients(jnp.asarray(grid), jnp.asarray(pts),
                                        xmin, xmax)
    got = tgi.grid_interp_coefficients(torch.from_numpy(grid),
                                       torch.from_numpy(pts), xmin, xmax)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

    np.testing.assert_allclose(
        tgi.multilinear_interp(torch.from_numpy(grid),
                               torch.from_numpy(pts), xmin, xmax).numpy(),
        np.asarray(jgi.multilinear_interp(jnp.asarray(grid),
                                          jnp.asarray(pts), xmin, xmax)),
        **TOL)


@pytest.mark.parametrize("dim", [2, 3])
def test_gather_and_offsets_match_jax(dim):
    rng = np.random.RandomState(10 + dim)
    spatial = (3, 4, 5)[:dim]
    grid = rng.randn(*spatial, 2).astype(np.float32)
    cell = np.stack([rng.randint(0, s - 1, 20) for s in spatial], -1)
    np.testing.assert_array_equal(tgi.corner_offsets(dim),
                                  jgi.corner_offsets(dim))
    np.testing.assert_array_equal(
        tgi.gather_corner_feats(torch.from_numpy(grid),
                                torch.from_numpy(cell)).numpy(),
        np.asarray(jgi.gather_corner_feats(jnp.asarray(grid),
                                           jnp.asarray(cell, jnp.int32))))
