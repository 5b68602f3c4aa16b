"""The port's data x space step (``parallel/dp_sp.py``) on a 2 x 2 gloo
world against JAX's ``make_dp_sp_train_step`` on a 2 x 2 CPU mesh and
against the port's single-process step:

- ``make_dp_sp_batch`` / ``stack_dp_sp_batches`` equal JAX's bit for
  bit;
- rb2d, l2 / l2 (the only loss kinds JAX's step computes), replicated
  and sharded encoders, with the PDE loss: the loss terms and the
  all-reduced gradients against JAX's (tests/test_dp_sp.py's tolerance:
  loss rtol 1e-4; the SGD update rtol 2e-2, atol 5e-4);
- rb2d, L1 + Huber (the flagship's kinds, which JAX's step ignores),
  sharded encoder, against the port's single-process step on the same
  points;
- 4-D (UNet4d, ns3d PDE), both encoders, against the single-process
  step: the shard-count invariance of tests/test_dp_sp.py.

One 4-rank world (``tests/torch_ranks.py::target_dp_sp``) runs every
port-side step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from space_time_pde_torch.bridge import flatten_tree, load_flax_params
from space_time_pde_torch.parallel import dp_sp as tdp_sp
from space_time_pde_torch.physics import get_pde_layer as tget_pde_layer
from space_time_pde_torch.train import build_models as tbuild_models
from space_time_pde_torch.train import make_loss_fn as tmake_loss_fn
from space_time_pde_torch.utils.config import Config as TConfig
from space_time_pde_tpu.data import (
    Field4DDataset, RB2DataLoader, abc_flow_fields, save_npz,
    taylor_green_fields)
from space_time_pde_tpu.models import ImNet, UNet4d
from space_time_pde_tpu.parallel import dp_sp as jdp_sp
from space_time_pde_tpu.parallel.sharded_unet import ShardedUNet3d
from space_time_pde_tpu.physics import get_rb2_pde_layer
from space_time_pde_tpu.train import build_models, init_state
from space_time_pde_tpu.utils.config import Config

from torch_ranks import run_world

N_DATA, N_SPACE = 2, 2
RAYLEIGH, VISCOSITY = 1e4, 0.05


def _rb2d_cfg(reg="l2", pde="l2"):
    cfg = Config()
    cfg.data.nt, cfg.data.nz, cfg.data.nx = 8, 16, 32
    cfg.data.downsamp_t, cfg.data.downsamp_xz = 2, 4
    cfg.data.n_samp_pts_per_crop = 64
    cfg.model.lat_dims, cfg.model.unet_nf, cfg.model.imnet_nf = 8, 8, 2
    cfg.train.reg_loss_type, cfg.train.pde_loss_type = reg, pde
    cfg.train.alpha_pde = 0.05
    cfg.physics.rayleigh = RAYLEIGH
    return cfg


def _4d_cfg():
    cfg = Config()
    cfg.model.lat_dims, cfg.model.unet_nf, cfg.model.imnet_nf = 4, 4, 1
    cfg.train.reg_loss_type, cfg.train.alpha_pde = "l2", 0.05
    cfg.physics.pde_system, cfg.physics.viscosity = "ns3d", VISCOSITY
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    save_npz(str(d / "tg.npz"),
             taylor_green_fields(nt=16, nz=16, nx=32, dt=0.05))
    save_npz(str(d / "abc.npz"),
             abc_flow_fields(nt=10, nz=8, ny=8, nx=16, viscosity=VISCOSITY))
    ds = RB2DataLoader(data_folder=str(d), data_filename="tg.npz", nt=8,
                       nz=16, nx=32, n_samp_pts_per_crop=64, downsamp_t=2,
                       downsamp_xz=4)                     # lres (4, 4, 8)
    ds4 = Field4DDataset(data_folder=str(d), data_filename="abc.npz", nt=8,
                         nz=8, ny=8, nx=16, n_samp_pts_per_crop=48,
                         downsamp_t=2, downsamp_xyz=2)    # lres (4, 4, 4, 8)
    cfg = _rb2d_cfg()
    unet, imnet = build_models(cfg, ds.lres_shape)
    tx = optax.sgd(1.0)
    state = init_state(jax.random.PRNGKey(0), cfg, unet, imnet, tx)
    et, ez, ex = ds.coord_extents
    pde = get_rb2_pde_layer(ds.channel_mean, ds.channel_std, et, ez, ex,
                            rayleigh=RAYLEIGH)
    batch = ds.sample_batch(np.random.RandomState(1), 4)
    sp = jdp_sp.make_dp_sp_batch(batch, N_SPACE, ds.lres_shape[2])

    unet4 = UNet4d(in_features=4, out_features=4, igres=ds4.lres_shape,
                   nf=4)
    imnet4 = ImNet(dim=4, in_features=4, out_features=4, nf=1)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    params4 = {
        "unet": jax.jit(unet4.init)(
            k1, jnp.zeros((1, *ds4.lres_shape, 4)))["params"],
        "imnet": jax.jit(imnet4.init)(k2, jnp.zeros((1, 8)))["params"]}
    batch4 = ds4.sample_batch(np.random.RandomState(3), 4)
    sp4 = jdp_sp.make_dp_sp_batch(batch4, N_SPACE, ds4.lres_shape[-1])

    inputs = {}
    for fam, params, b, dset in (("rb2d", state.params, sp, ds),
                                 ("ns3d", params4, sp4, ds4)):
        inputs.update({f"{fam}/{k}": v
                       for k, v in flatten_tree(params).items()})
        inputs.update({f"{fam}/sp/{k}": v for k, v in b.items()})
        inputs[f"{fam}/channel_mean"] = np.asarray(dset.channel_mean)
        inputs[f"{fam}/channel_std"] = np.asarray(dset.channel_std)
    fams = {
        "rb2d": dict(lres_shape=list(ds.lres_shape),
                     coord_extents=[float(e) for e in ds.coord_extents],
                     rayleigh=RAYLEIGH),
        "ns3d": dict(lres_shape=list(ds4.lres_shape),
                     coord_extents=[float(e) for e in ds4.coord_extents],
                     viscosity=VISCOSITY)}
    runs = [dict(tag="rep", family="rb2d", sharded=False,
                 config=_rb2d_cfg().to_dict()),
            dict(tag="shd", family="rb2d", sharded=True,
                 config=_rb2d_cfg().to_dict()),
            dict(tag="hub", family="rb2d", sharded=True,
                 config=_rb2d_cfg("l1", "huber").to_dict()),
            dict(tag="rep4", family="ns3d", sharded=False,
                 config=_4d_cfg().to_dict()),
            dict(tag="shd4", family="ns3d", sharded=True,
                 config=_4d_cfg().to_dict())]
    outs = run_world("dp_sp", N_DATA * N_SPACE,
                     str(tmp_path_factory.mktemp("dp_sp")), inputs=inputs,
                     spec=dict(fams, n_space=N_SPACE, runs=runs))
    return dict(ds=ds, ds4=ds4, unet=unet, imnet=imnet, state=state,
                pde=pde, batch=batch, sp=sp, batch4=batch4, fams=fams,
                params4=params4, outs=outs, runs={r["tag"]: r for r in runs})


def test_make_dp_sp_batch_matches_jax_bit_for_bit(setup):
    ds = setup["ds"]
    rng = np.random.RandomState(5)
    batches = [ds.sample_batch(rng, 3) for _ in range(2)]
    for m_round in (64, 0):
        got = [tdp_sp.make_dp_sp_batch(b, N_SPACE, 8, m_round)
               for b in batches]
        want = [jdp_sp.make_dp_sp_batch(b, N_SPACE, 8, m_round)
                for b in batches]
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
        gs, ws = (tdp_sp.stack_dp_sp_batches(got),
                  jdp_sp.stack_dp_sp_batches(want))
        for k in ws:
            np.testing.assert_array_equal(gs[k], ws[k])
    b4 = setup["ds4"].sample_batch(np.random.RandomState(6), 2)
    g4 = tdp_sp.make_dp_sp_batch(b4, N_SPACE, 8)
    w4 = jdp_sp.make_dp_sp_batch(b4, N_SPACE, 8)
    for k in w4:
        np.testing.assert_array_equal(g4[k], w4[k])


def _grads(outs, tag):
    """The all-reduced gradients (equal on every rank: checked)."""
    keys = [k for k in outs[0] if k.startswith(f"{tag}_grad/")]
    for o in outs[1:]:
        for k in keys:
            np.testing.assert_array_equal(o[k], outs[0][k])
    return {k[len(tag) + 6:]: outs[0][k] for k in keys}


def _metrics(outs, tag):
    return {k[len(tag) + 3:]: float(outs[0][k]) for k in outs[0]
            if k.startswith(f"{tag}_m/")}


@pytest.mark.parametrize("tag,sharded", [("rep", False), ("shd", True)])
def test_dp_sp_step_matches_jax(setup, tag, sharded):
    cfg = _rb2d_cfg()
    unet = setup["unet"]
    if sharded:
        unet = ShardedUNet3d(in_features=4, out_features=8,
                             igres=setup["ds"].lres_shape, nf=8)
    step, _, place = jdp_sp.make_dp_sp_train_step(
        cfg, unet, setup["imnet"], setup["pde"], optax.sgd(1.0), N_DATA,
        N_SPACE, sharded_encoder=sharded)
    state, placed = place(setup["state"], {k: jnp.asarray(v)
                                           for k, v in setup["sp"].items()})
    new, metrics = step(state, placed)
    got_m = _metrics(setup["outs"], tag)
    for k in ("loss", "reg_loss", "pde_loss"):
        np.testing.assert_allclose(got_m[k], float(metrics[k]), rtol=1e-4)
    # SGD(1): the update is the gradient; hold the port's to JAX's at the
    # JAX test's tolerance of an lr-1e-2 SGD step.
    p0 = setup["state"].params
    jgrad = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), p0,
                         new.params)
    tgrads = _grads(setup["outs"], tag)
    models = tbuild_models(TConfig.from_dict(cfg.to_dict()),
                           setup["ds"].lres_shape, "cpu")
    # JAX's gradient tree in the port's layout, through the bridge.
    refs = {f"{name}.{k}": g.numpy()
            for name, module in zip(("unet", "imnet"), models)
            for k, g in load_flax_params(module, jgrad[name])
            .state_dict().items()}
    # A conv bias right before a GroupNorm has a gradient of 0 (noise in
    # both): every leaf is read against the model's largest gradient.
    scale = max(np.abs(g).max() for g in refs.values())
    for k, g in refs.items():
        np.testing.assert_allclose(-1e-2 * tgrads[k], -1e-2 * g, rtol=2e-2,
                                   atol=5e-4, err_msg=k)
        np.testing.assert_allclose(tgrads[k], g, rtol=1e-3,
                                   atol=1e-5 * scale, err_msg=k)


def _single_process(cfg_dict, params, batch, fam, setup):
    """The port's single-process step on the unbinned batch: (metrics,
    gradients)."""
    cfg = TConfig.from_dict(cfg_dict)
    spec = setup["fams"][fam]
    dset = setup["ds"] if fam == "rb2d" else setup["ds4"]
    unet, imnet = tbuild_models(cfg, tuple(spec["lres_shape"]), "cpu")
    load_flax_params(unet, params["unet"])
    load_flax_params(imnet, params["imnet"])
    ext = spec["coord_extents"]
    kw = (dict(t_crop=ext[0], z_crop=ext[1], x_crop=ext[2],
               rayleigh=RAYLEIGH) if fam == "rb2d" else
          dict(t_crop=ext[0], z_crop=ext[1], y_crop=ext[2], x_crop=ext[3],
               viscosity=VISCOSITY))
    pde = tget_pde_layer(cfg.physics.pde_system, mean=dset.channel_mean,
                         std=dset.channel_std, **kw)
    loss, metrics = tmake_loss_fn(cfg, unet, imnet, pde)(
        {k: torch.from_numpy(np.asarray(batch[k]))
         for k in ("lres", "point_coord", "point_value")})
    loss.backward()
    grads = {f"unet.{k}": p.grad.numpy() for k, p in unet.named_parameters()}
    grads.update({f"imnet.{k}": p.grad.numpy()
                  for k, p in imnet.named_parameters()})
    return {k: float(v.detach()) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("tag", ["hub", "rep4", "shd4"])
def test_dp_sp_step_matches_single_process(setup, tag):
    """The masked means over the binned points equal the single-process
    loss on the same points, L1 + Huber included, and so do the
    gradients (the 4-D cases: shard-count invariance)."""
    run = setup["runs"][tag]
    fam = run["family"]
    params = setup["state"].params if fam == "rb2d" else setup["params4"]
    batch = setup["batch"] if fam == "rb2d" else setup["batch4"]
    want_m, want_g = _single_process(run["config"], params, batch, fam,
                                     setup)
    got_m = _metrics(setup["outs"], tag)
    for k in ("loss", "reg_loss", "pde_loss"):
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-4)
    got_g = _grads(setup["outs"], tag)
    scale = max(np.abs(g).max() for g in want_g.values())
    for k, g in want_g.items():
        np.testing.assert_allclose(got_g[k], g, rtol=1e-3,
                                   atol=1e-5 * scale, err_msg=k)
