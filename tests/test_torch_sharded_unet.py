"""The port's ``ShardedUNet3d`` / ``ShardedUNet4d`` (4 gloo ranks, x
sharded) against JAX's on a 4-device CPU mesh, with JAX's parameters
carried across by the bridge, and against the port's plain
``UNet3d`` / ``UNet4d`` with the same state dict at 1 and 4 shards
(JAX's tolerance, tests/test_sharded_unet.py: 5e-5); the backward (the
ranks' parameter gradients summed equal the plain module's) and
BatchNorm's train mode with statistics synced over the ranks.

One 4-rank world (``tests/torch_ranks.py::target_sharded_unet``) runs the
port's side.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from space_time_pde_torch.bridge import flatten_tree, load_flax_params
from space_time_pde_torch.models import UNet3d as TUNet3d
from space_time_pde_torch.models import UNet4d as TUNet4d
from space_time_pde_torch.parallel.dp import make_mesh
from space_time_pde_torch.parallel.sharded_unet import ShardedUNet3d as TS3
from space_time_pde_torch.parallel.sharded_unet4d import (
    ShardedUNet4d as TS4)
from space_time_pde_tpu.models import UNet3d
from space_time_pde_tpu.parallel.sharded_unet import (
    ShardedUNet3d, init_sharded_unet_params)
from space_time_pde_tpu.parallel.sharded_unet4d import (
    ShardedUNet4d, init_sharded_unet4d_params)

from torch_ranks import run_world

N = 4
IGRES3 = (4, 16, 32)
IGRES4 = (4, 4, 8, 16)
TOL = dict(rtol=5e-5, atol=5e-5)


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("space",))


def _spec(rank):
    return P(*([None] * rank), "space", None)


def _apply(m, variables, x, n, rank):
    return np.asarray(jax.jit(jax.shard_map(
        lambda xs: m.apply(variables, xs), mesh=_mesh(n),
        in_specs=(_spec(rank),), out_specs=_spec(rank),
        check_vma=False))(x))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.RandomState(0)
    key = jax.random.PRNGKey(3)
    jmods, inputs = {}, {}
    x3 = rng.randn(2, *IGRES3, 4).astype(np.float32)
    x4 = rng.randn(2, *IGRES4, 4).astype(np.float32)
    m3 = ShardedUNet3d(in_features=4, out_features=8, igres=IGRES3, nf=8)
    jmods["u3"] = (m3, init_sharded_unet_params(key, m3, x3), x3, 3)
    m4 = ShardedUNet4d(in_features=4, out_features=8, igres=IGRES4, nf=8)
    jmods["u4"] = (m4, init_sharded_unet4d_params(key, m4, x4), x4, 4)
    bn = UNet3d(in_features=4, out_features=8, igres=IGRES3, nf=8,
                norm="batch")
    jmods["bn"] = (bn, jax.jit(bn.init)(key, x3), x3, 3)
    for tag, (_, variables, x, _) in jmods.items():
        inputs.update({f"{tag}/{k}": v for k, v in
                       flatten_tree(variables["params"]).items()})
        if "batch_stats" in variables:
            inputs.update({f"{tag}_stats/{k}": v for k, v in
                           flatten_tree(variables["batch_stats"]).items()})
        inputs[f"{tag}_x"] = x
        inputs[f"{tag}_cot"] = rng.randn(*x.shape[:-1], 8).astype(
            np.float32)
    outs = run_world("sharded_unet", N,
                     str(tmp_path_factory.mktemp("sharded_unet")),
                     inputs=inputs,
                     spec={"igres3": IGRES3, "igres4": IGRES4})
    return jmods, inputs, outs


def _plain(tag, jmods):
    _, variables, _, _ = jmods[tag]
    if tag == "u4":
        m = TUNet4d(in_features=4, out_features=8, igres=IGRES4, nf=8)
    else:
        m = TUNet3d(in_features=4, out_features=8, igres=IGRES3, nf=8,
                    norm="batch" if tag == "bn" else "group")
    return load_flax_params(m, variables["params"],
                            variables.get("batch_stats"))


@pytest.mark.parametrize("tag", ["u3", "u4"])
def test_sharded_unet_matches_jax_and_plain(world, tag):
    jmods, inputs, outs = world
    m, variables, x, rank = jmods[tag]
    got4 = np.concatenate([o[f"{tag}_y"] for o in outs], axis=rank)
    want4 = _apply(m, variables, x, N, rank)
    assert got4.shape == x.shape[:-1] + (8,)
    np.testing.assert_allclose(got4, want4, **TOL)
    plain = _plain(tag, jmods)
    with torch.no_grad():
        ref = plain(torch.from_numpy(x)).numpy()
        cls = TS3 if tag == "u3" else TS4
        got1 = cls.from_plain(plain, make_mesh(1, 1))(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got1, ref, **TOL)
    np.testing.assert_allclose(got4, ref, **TOL)


@pytest.mark.parametrize("tag", ["u3", "u4", "bn"])
def test_sharded_unet_backward_matches_plain(world, tag):
    """The halo exchanges' and the GroupNorm / BatchNorm all-reduces'
    backward: the 4 ranks' parameter gradients summed equal the plain
    module's on the whole grid."""
    jmods, inputs, outs = world
    plain = _plain(tag, jmods)
    plain.train(tag == "bn")
    y = plain(torch.from_numpy(inputs[f"{tag}_x"]))
    (y * torch.from_numpy(inputs[f"{tag}_cot"])).sum().backward()
    scale = max(float(p.grad.abs().max()) for p in plain.parameters())
    for k, p in plain.named_parameters():
        got = sum(o[f"{tag}_d/{k}"] for o in outs)
        np.testing.assert_allclose(got, p.grad.numpy(), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)


def test_sharded_batchnorm_matches_plain(world):
    """Train mode: outputs and the new running statistics at 4 shards
    equal the plain BatchNorm UNet3d's (tests/test_sharded_unet.py's
    BatchNorm tolerance, 2e-4)."""
    jmods, inputs, outs = world
    plain = _plain("bn", jmods).train()
    with torch.no_grad():
        ref = plain(torch.from_numpy(inputs["bn_x"])).numpy()
    got = np.concatenate([o["bn_y"] for o in outs], axis=3)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    for k, b in plain.named_buffers():
        if "running" in k:
            for o in outs:
                np.testing.assert_allclose(o[f"bn_stat/{k}"], b.numpy(),
                                           rtol=2e-4, atol=2e-4)
