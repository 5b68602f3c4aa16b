"""The port's data parallelism (``parallel/dp.py``) on 2 gloo ranks:

- the data-parallel step against JAX's ``make_dp_train_step`` on 2 CPU
  devices, same weights and batch (tests/test_parallel.py's tolerances:
  loss rtol 1e-5, gradient norm 3e-2, an lr-1e-2 SGD update rtol 2e-2,
  atol 2e-4);
- ``make_dp_multi_step`` against sequential data-parallel steps
  (tests/test_parallel.py: rtol 1e-4, atol 1e-6);
- BatchNorm with its statistics synced over the 2 ranks against the
  single-process BatchNorm step on the whole batch;
- ``replicate_state``: ranks that start apart end equal.

One 2-rank world (``tests/torch_ranks.py::target_dp``) runs the port's
side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from space_time_pde_torch.bridge import flatten_tree, load_flax_params
from space_time_pde_torch.train import build_models as tbuild_models
from space_time_pde_torch.train import make_loss_fn as tmake_loss_fn
from space_time_pde_torch.utils.config import Config as TConfig
from space_time_pde_tpu.data import RB2DataLoader, save_npz, \
    taylor_green_fields
from space_time_pde_tpu.parallel import (
    make_dp_train_step, replicate_state, shard_batch)
from space_time_pde_tpu.train import build_models, init_state, make_loss_fn
from space_time_pde_tpu.utils.config import Config

from torch_ranks import run_world

WORLD = 2


def _cfg(norm="group"):
    cfg = Config()
    cfg.data.nt, cfg.data.nz, cfg.data.nx = 8, 16, 16
    cfg.data.downsamp_t, cfg.data.downsamp_xz = 2, 4
    cfg.data.n_samp_pts_per_crop = 32
    cfg.model.lat_dims, cfg.model.unet_nf, cfg.model.imnet_nf = 8, 8, 2
    cfg.model.norm = norm
    cfg.train.reg_loss_type = "l2"
    cfg.train.alpha_pde = 0.0
    return cfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    save_npz(str(d / "tg.npz"),
             taylor_green_fields(nt=16, nz=16, nx=16, dt=0.05))
    ds = RB2DataLoader(data_folder=str(d), data_filename="tg.npz", nt=8,
                       nz=16, nx=16, n_samp_pts_per_crop=32, downsamp_t=2,
                       downsamp_xz=4)
    batch = ds.sample_batch(np.random.RandomState(0), 8)
    inputs = dict(batch)
    # Taylor-Green's temperature channel is 0, so on its crops a
    # BatchNorm sees a channel of variance ~0 (normalised by eps alone),
    # where f32 rounding of the statistics moves the gradient by ~10%
    # in any summation order; the BatchNorm step takes seeded noise in.
    inputs["bn_lres"] = np.random.RandomState(1).randn(
        *batch["lres"].shape).astype(np.float32)
    states = {}
    for tag in ("gn", "bn"):
        cfg = _cfg("group" if tag == "gn" else "batch")
        unet, imnet = build_models(cfg, ds.lres_shape)
        state = init_state(jax.random.PRNGKey(0), cfg, unet, imnet,
                           optax.sgd(1e-2))
        states[tag] = (cfg, unet, imnet, state)
        for name in ("unet", "imnet"):
            inputs.update({f"{tag}_{name}/{k}": v for k, v in
                           flatten_tree(state.params[name]).items()})
        if state.batch_stats is not None:
            inputs.update({f"{tag}_stats/{k}": v for k, v in
                           flatten_tree(state.batch_stats).items()})
    rng = np.random.RandomState(9)
    seq = [ds.sample_batch(rng, 4) for _ in range(3)]
    for k in ("lres", "point_coord", "point_value"):
        inputs[f"seq_{k}"] = np.stack([b[k] for b in seq])
    spec = {f"config_{t}": states[t][0].to_dict() for t in states}
    spec["lres_shape"] = list(ds.lres_shape)
    outs = run_world("dp", WORLD, str(tmp_path_factory.mktemp("dp")),
                     inputs=inputs, spec=spec)
    return dict(ds=ds, batch=batch, states=states, outs=outs,
                bn_lres=inputs["bn_lres"])


def _port_grads(outs, tag):
    keys = [k for k in outs[0] if k.startswith(f"{tag}_grad/")]
    for o in outs[1:]:
        for k in keys:
            np.testing.assert_array_equal(o[k], outs[0][k])
    return {k[len(tag) + 6:]: outs[0][k] for k in keys}


def test_dp_step_matches_jax(world):
    cfg, unet, imnet, state = world["states"]["gn"]
    tx = optax.sgd(1e-2)
    loss_fn = make_loss_fn(cfg, unet, imnet, pde_layer=None)
    step, mesh = make_dp_train_step(loss_fn, tx, WORLD)
    batch = {k: jnp.asarray(v) for k, v in world["batch"].items()}
    new, metrics = step(replicate_state(state, mesh),
                        shard_batch(batch, mesh))
    outs = world["outs"]
    np.testing.assert_allclose(float(outs[0]["gn_loss"]),
                               float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(outs[0]["gn_grad_norm"]),
                               float(metrics["grad_norm"]), rtol=3e-2)
    grads = _port_grads(outs, "gn")
    tcfg = TConfig.from_dict(cfg.to_dict())
    models = tbuild_models(tcfg, world["ds"].lres_shape, "cpu")
    for name, module in zip(("unet", "imnet"), models):
        p0 = {k: v.clone() for k, v in load_flax_params(
            module, state.params[name]).state_dict().items()}
        p1 = load_flax_params(module, new.params[name]).state_dict()
        for k in p0:
            got = p0[k].numpy() - 1e-2 * grads[f"{name}.{k}"]
            np.testing.assert_allclose(got, p1[k].numpy(), rtol=2e-2,
                                       atol=2e-4, err_msg=k)


def test_dp_multi_step_matches_sequential(world):
    outs = world["outs"]
    for o in outs:
        assert int(o["seq_step"]) == int(o["multi_step"]) == 3
        np.testing.assert_allclose(float(o["multi_loss"]),
                                   float(o["seq_loss"]), rtol=1e-4)
        for k in o:
            if k.startswith("seq/"):
                np.testing.assert_allclose(o["multi/" + k[4:]], o[k],
                                           rtol=1e-4, atol=1e-6)
    # The replicas stayed equal.
    for k in outs[0]:
        if k.startswith("multi/"):
            np.testing.assert_array_equal(outs[1][k], outs[0][k])


def test_synced_batchnorm_matches_single_process(world):
    """Statistics averaged over the ranks (flax's pmean): the averaged
    gradients and the new running statistics equal one process's step on
    the whole batch."""
    cfg, _, _, state = world["states"]["bn"]
    tcfg = TConfig.from_dict(cfg.to_dict())
    unet, imnet = tbuild_models(tcfg, world["ds"].lres_shape, "cpu")
    load_flax_params(unet, state.params["unet"], state.batch_stats)
    load_flax_params(imnet, state.params["imnet"])
    loss, _ = tmake_loss_fn(tcfg, unet, imnet, None)(
        {"lres": torch.from_numpy(world["bn_lres"]),
         "point_coord": torch.from_numpy(world["batch"]["point_coord"]),
         "point_value": torch.from_numpy(world["batch"]["point_value"])})
    loss.backward()
    outs = world["outs"]
    np.testing.assert_allclose(float(outs[0]["bn_loss"]), float(loss.detach()),
                               rtol=1e-5)
    grads = _port_grads(outs, "bn")
    want = {f"unet.{k}": p.grad.numpy() for k, p in unet.named_parameters()}
    want.update({f"imnet.{k}": p.grad.numpy()
                 for k, p in imnet.named_parameters()})
    # A conv bias before a BatchNorm has a gradient of 0 (noise in both):
    # every leaf is read against the model's largest gradient.
    scale = max(np.abs(g).max() for g in want.values())
    for k, g in want.items():
        np.testing.assert_allclose(grads[k], g, rtol=2e-4,
                                   atol=1e-5 * scale, err_msg=k)
    for k, b in unet.named_buffers():
        if "running" in k:
            for o in outs:
                np.testing.assert_allclose(o[f"bn_stat/{k}"], b.numpy(),
                                           rtol=2e-4, atol=2e-6, err_msg=k)


def test_replicate_state_broadcasts_rank0(world):
    outs = world["outs"]
    np.testing.assert_array_equal(outs[1]["replicated"],
                                  outs[0]["replicated"])
    assert int(outs[0]["replicated_count"]) == \
        int(outs[1]["replicated_count"]) == 7
