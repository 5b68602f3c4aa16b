"""The port's ``parallel/halo.py`` and ``parallel/halo_conv.py`` on 4 gloo
ranks against JAX's on a 4-device CPU mesh: the halo exchanges, the
sharded query (interior and boundary points), the sharded jet (fused
twin and plain, forward and backward), HaloConv3d at stride 1 and 2,
ShardedGroupNorm; and ``bin_points_by_shard`` against JAX's.

One 4-rank world (``tests/torch_ranks.py::target_halo``) runs every
port-side check; the tests below read its outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from space_time_pde_torch.bridge import flatten_tree, load_flax_params
from space_time_pde_torch.models import ImNet as TImNet
from space_time_pde_torch.ops.fused_jet import fused_query_jet
from space_time_pde_torch.parallel import halo as thalo
from space_time_pde_tpu.models import ImNet
from space_time_pde_tpu.parallel import halo as jhalo
from space_time_pde_tpu.parallel.halo_conv import (
    HaloConv3d, ShardedGroupNorm, halo_exchange_x)

from torch_ranks import run_world

N = 4
X = 16
C = 6
XSPEC = P(None, None, None, "space", None)


def _mesh(n=N):
    return Mesh(np.asarray(jax.devices()[:n]), ("space",))


def _smap(fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=_mesh(), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _jet_points(rng, b, m):
    """[b, N, m, 3] points, shard s's inside its x range; a quarter of
    them on the shard's lower boundary (interior shard faces for s > 0)
    and a few on t / z faces."""
    span = 1.0 / (X - 1)
    n_loc = X // N
    pts = rng.rand(b, N, m, 3).astype(np.float32)
    for s in range(N):
        lo, hi = s * n_loc * span, min(1.0, (s + 1) * n_loc * span)
        x = lo + (hi - lo) * rng.rand(b, m)
        x[:, : m // 4] = lo
        pts[:, s, :, 2] = x
    pts[:, :, -2:, 0] = np.array([0.0, 1.0], np.float32)
    return pts.astype(np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.RandomState(0)
    imnet = ImNet(dim=3, in_features=C, out_features=4, nf=2)
    params = imnet.init(jax.random.PRNGKey(0), jnp.ones((1, 3 + C)))
    inputs = {f"imnet/{k}": v for k, v in
              flatten_tree(params["params"]).items()}
    inputs["latent"] = rng.randn(1, 4, 5, X, C).astype(np.float32)
    pts = rng.rand(200, 3).astype(np.float32)
    binned, mask, inverse = jhalo.bin_points_by_shard(pts, N, X)
    inputs["binned"] = binned
    # Points on every shard boundary node and the domain extremes.
    inputs["latent2"] = rng.randn(1, 3, 3, X, 4).astype(np.float32)
    xs = np.concatenate([np.arange(0, X, 2) / (X - 1), [0.0, 1.0]])
    pts2 = np.stack([np.full_like(xs, 0.4), np.full_like(xs, 0.6), xs],
                    -1).astype(np.float32)
    binned2, mask2, inverse2 = jhalo.bin_points_by_shard(pts2, N, X)
    inputs["binned2"] = binned2
    inputs["ramp"] = np.arange(2 * 3 * X * 4, dtype=np.float32).reshape(
        1, 2, 3, X, 4)
    inputs["jet_latent"] = (0.5 * rng.randn(2, 4, 5, X, C)).astype(
        np.float32)
    inputs["jet_pts"] = _jet_points(rng, 2, 24)
    for i, shape in enumerate([(4,), (4, 3), (4, 3, 3)]):
        cot = rng.randn(2, N, 24, *shape).astype(np.float32)
        if i:
            # On an interior shard face the sharded jet takes half of
            # d frac / d p, as JAX's does (a clip bound of the local
            # grid): there its derivatives are not the unsharded ones,
            # so the backward check leaves them out.
            cot[:, 1:, :6] = 0.0
        inputs[f"jet_cot{i}"] = cot
    inputs["conv_x"] = rng.randn(2, 4, 4, X, 3).astype(np.float32)
    inputs["gn_x"] = rng.randn(2, 3, 4, X, 8).astype(np.float32)
    jax_params = {}
    for stride in (1, 2):
        m = HaloConv3d(features=5, kernel_size=(3, 3, 3),
                       strides=(1, 1, stride), axis_name="space")
        p = jax.jit(jax.shard_map(
            lambda xs: m.init(jax.random.PRNGKey(stride), xs),
            mesh=_mesh(1), in_specs=(XSPEC,), out_specs=P(),
            check_vma=False))(inputs["conv_x"])
        jax_params[f"conv{stride}"] = (m, p)
        inputs[f"conv{stride}/kernel"] = np.asarray(p["params"]["kernel"])
        inputs[f"conv{stride}/bias"] = np.asarray(p["params"]["bias"])
    gn_scale = rng.rand(8).astype(np.float32) + 0.5
    gn_bias = rng.randn(8).astype(np.float32)
    inputs["gn/scale"], inputs["gn/bias"] = gn_scale, gn_bias
    outs = run_world("halo", N, str(tmp_path_factory.mktemp("halo")),
                     inputs=inputs, spec={"C": C})
    return dict(imnet=imnet, params=params, inputs=inputs, outs=outs,
                mask=mask, inverse=inverse, pts=pts, mask2=mask2,
                inverse2=inverse2, pts2=pts2, jax_params=jax_params)


def _concat(outs, key, axis=0):
    return np.concatenate([o[key] for o in outs], axis=axis)


def test_init_multihost_lines(world):
    for r, o in enumerate(world["outs"]):
        assert f"multihost: process {r}/{N}, backend gloo, device cpu" in \
            o["_log"]


def test_sharded_query_matches_jax(world):
    inp = world["inputs"]
    decoder = lambda v: world["imnet"].apply(world["params"], v)
    want = np.asarray(_smap(
        lambda l, p: jhalo.sharded_query_local_implicit_grid(
            decoder, l, p, "space", X),
        (XSPEC, P("space")), P("space"))(inp["latent"], inp["binned"]))
    got = np.stack([o["query"] for o in world["outs"]])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    # And the unsharded query, through the binning's inverse.
    from space_time_pde_tpu.models import query_local_implicit_grid
    flat = np.asarray(query_local_implicit_grid(
        decoder, jnp.asarray(inp["latent"]),
        jnp.asarray(world["pts"][None])))[0]
    got = np.stack([o["query"] for o in world["outs"]])
    np.testing.assert_allclose(got[world["mask"]][world["inverse"]], flat,
                               rtol=2e-4, atol=2e-5)


def test_sharded_query_boundary_points(world):
    inp = world["inputs"]
    want = np.asarray(_smap(
        lambda l, p: jhalo.sharded_query_local_implicit_grid(
            lambda v: v[..., 3:7], l, p, "space", X),
        (XSPEC, P("space")), P("space"))(inp["latent2"], inp["binned2"]))
    got = np.stack([o["boundary"] for o in world["outs"]])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    from space_time_pde_tpu.models import query_local_implicit_grid
    flat = np.asarray(query_local_implicit_grid(
        lambda v: v[..., 3:7], jnp.asarray(inp["latent2"]),
        jnp.asarray(world["pts2"][None])))[0]
    np.testing.assert_allclose(got[world["mask2"]][world["inverse2"]], flat,
                               rtol=1e-5, atol=1e-6)


def test_halo_exchanges(world):
    ramp = world["inputs"]["ramp"]
    n_loc = X // N
    for s, o in enumerate(world["outs"]):
        own = ramp[..., s * n_loc:(s + 1) * n_loc, :]
        nxt = (ramp[..., (s + 1) * n_loc, :] if s < N - 1
               else ramp[..., -1, :])
        np.testing.assert_array_equal(o["halo"][..., :n_loc, :], own)
        np.testing.assert_array_equal(o["halo"][..., n_loc, :], nxt)
        # Both neighbours, zeros at the global edges.
        left = (ramp[..., s * n_loc - 1, :] if s > 0
                else np.zeros_like(ramp[..., 0, :]))
        right = (ramp[..., (s + 1) * n_loc, :] if s < N - 1
                 else np.zeros_like(ramp[..., 0, :]))
        np.testing.assert_array_equal(o["halo_x"][..., 0, :], left)
        np.testing.assert_array_equal(o["halo_x"][..., 1:-1, :], own)
        np.testing.assert_array_equal(o["halo_x"][..., -1, :], right)
    want = np.asarray(_smap(lambda h: halo_exchange_x(h, "space", 1, 1),
                            (XSPEC,), XSPEC)(ramp))
    got = _concat(world["outs"], "halo_x", axis=3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tag", ["fused", "plain"])
def test_sharded_jet_matches_jax(world, tag):
    """Value, Jacobian and Hessian at interior and shard-boundary points,
    at the jet tolerances of tests/test_fused_jet.py."""
    inp = world["inputs"]
    decoder = lambda v: world["imnet"].apply(world["params"], v)

    def fn(l, p):
        v, j, h = jhalo.sharded_query_jet(decoder, l, p[:, 0], "space", X)
        return v[:, None], j[:, None], h[:, None]

    spec = P(None, "space")
    want = _smap(fn, (XSPEC, spec), (spec, spec, spec))(
        inp["jet_latent"], inp["jet_pts"])
    for i, (rtol, atol) in enumerate([(2e-4, 2e-5), (2e-4, 2e-4),
                                      (2e-4, 2e-3)]):
        got = np.stack([o[f"jet_{tag}_{i}"] for o in world["outs"]], 1)
        np.testing.assert_allclose(got, np.asarray(want[i]), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("tag", ["fused", "plain"])
def test_sharded_jet_backward_matches_unsharded(world, tag):
    """The halo's cotangent returns to its owner: the ranks' latent
    gradients, side by side, and their ImNet gradients, summed, equal the
    unsharded jet's."""
    inp = world["inputs"]
    imnet = load_flax_params(TImNet(dim=3, in_features=C, out_features=4,
                                    nf=2), world["params"]["params"])
    lat = torch.from_numpy(inp["jet_latent"]).requires_grad_(True)
    pts = torch.from_numpy(inp["jet_pts"].reshape(2, -1, 3))
    jet = fused_query_jet(imnet, lat, pts)
    cot = [torch.from_numpy(inp[f"jet_cot{i}"]).reshape(2, -1,
                                                        *j.shape[2:])
           for i, j in enumerate(jet)]
    sum((j * c).sum() for j, c in zip(jet, cot)).backward()
    got = _concat(world["outs"], f"jet_{tag}_dlatent", axis=3)
    want = lat.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    for k, p in imnet.named_parameters():
        got = sum(o[f"jet_{tag}_d/{k}"] for o in world["outs"])
        g = p.grad.numpy()
        np.testing.assert_allclose(got, g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max())


@pytest.mark.parametrize("stride", [1, 2])
def test_halo_conv_matches_jax(world, stride):
    m, p = world["jax_params"][f"conv{stride}"]
    want = np.asarray(_smap(lambda xs: m.apply(p, xs), (XSPEC,), XSPEC)(
        world["inputs"]["conv_x"]))
    got = _concat(world["outs"], f"conv{stride}", axis=3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sharded_groupnorm_matches_jax(world):
    inp = world["inputs"]
    m = ShardedGroupNorm(num_groups=4, axis_name="space")
    params = {"params": {"scale": inp["gn/scale"], "bias": inp["gn/bias"]}}
    want = np.asarray(_smap(lambda xs: m.apply(params, xs), (XSPEC,),
                            XSPEC)(inp["gn_x"]))
    got = _concat(world["outs"], "gn", axis=3)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_bin_points_by_shard_matches_jax():
    rng = np.random.RandomState(2)
    pts = rng.rand(100, 3).astype(np.float32)
    pts[:5, 2] = [0.0, 1.0, 4 / 15, 8 / 15, 12 / 15]
    got = thalo.bin_points_by_shard(pts, 4, 16)
    want = jhalo.bin_points_by_shard(pts, 4, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    binned, mask, inverse = got
    assert mask.sum() == 100
    np.testing.assert_array_equal(binned[mask][inverse], pts)


def test_shard_bounds_match_jax():
    for s in range(N):
        lo, hi = thalo.shard_bounds(s, N, X, 0.0, 1.0)
        jlo, jhi = _smap(lambda _: tuple(
            jnp.broadcast_to(v, (1,)) for v in jhalo.shard_bounds(
                "space", X, jnp.float32(0.0), jnp.float32(1.0))),
            (P("space"),), (P("space"), P("space")))(jnp.zeros(N))
        assert float(lo) == float(np.asarray(jlo)[s])
        assert float(hi) == float(np.asarray(jhi)[s])
