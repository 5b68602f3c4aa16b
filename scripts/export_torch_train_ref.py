"""Export a JAX-CPU reference of one flagship training step.

Writes a file under ``space_time_pde_torch/assets/`` (``RECIPES``) that
``chip_smoke.py`` holds the port's training step on the card against.
Four recipes:

- ``rb2d`` (default): the rb2d flagship's widths (lat_dims 64, unet_nf
  32, imnet_nf 64, igres (4, 16, 16)), batch 8 x 1,024 points, the RB2
  equations at Ra 1e6, Pr 1; the batch drawn by the JAX
  ``RB2DataLoader`` from a Taylor–Green field (32 x 128 x 256 frames,
  made from the closed form);
- ``rb2d_bn``: ``rb2d`` with ``norm="batch"``: the encoder in train
  mode, its running statistics starting where flax starts them (mean 0,
  var 1); the file also holds the new statistics, JAX f32
  (``stats32/``) and float64 (``stats64/``), keyed by the port's buffer
  names;
- ``turb3d``: the ``r5_turb3d_200x_big`` recipe
  (``log/r5_turb3d_200x_big/command.sh``): UNet4d nf 32 / mf 256 (the
  driver's default), lat_dims 64, ImNet(dim=4) nf 64, crop (8, 32, 32,
  32) down-sampled t 2 / xyz 4 to igres (4, 8, 8, 8), batch 4 x 1,024
  points, the ns3d equations at viscosity 1e-2; the batch drawn by the
  JAX ``Field4DDataset`` from the Beltrami realization of seed 42 (a
  training seed, 24 x 32^3, made from the closed form).

All three: alpha_pde 0.1, huber PDE loss, l1 regression, the jet
derivatives (``--pde_derivs jet``, the JAX jnp jet on the CPU). The
file holds:

- the batch, drawn with ``RandomState(--batch_seed)``, with its channel
  stats;
- the weights: not stored. Both packages draw them from
  ``--weight_seed`` with ``bridge.seeded_flax_params`` over the parameter
  paths and shapes that the file lists;
- the JAX float32 loss terms and, per gradient leaf (in the port's
  layout, keyed by its parameter names), its relative L2 distance from
  the float64 leaf below (``relnorm/``; the leaves themselves are not
  kept);
- a float64 recomputation of the same step (the port's plain PyTorch
  path on the CPU in float64, ``--pde_derivs jet_jnp``; the JAX modules
  cast their outputs to float32, so they cannot give one): the encoder
  over the whole batch, the decode one batch element at a time; its
  loss terms, its gradient leaves (rounded to float32 for size: 6e-8
  relative, far below the tolerance), and per leaf its scale (its
  largest magnitude; the model's largest gradient where the leaf's is 0
  up to rounding, below ``ZERO_GRAD`` of it) and the ``atol`` (a
  fraction of that) at which JAX's float32 leaf meets it,
  ``|g32 - g64| <= rtol |g64| + atol scale``.

``rb2d_bf16``: the ``rb2d`` step under the bf16 compute policy
(``use_bf16``; the jet f32, as the JAX trainer runs it without
``--pde_bf16``), on the weights and batch of the ``rb2d`` file (read
from it, with its float64 gradient leaves and their scales). The file
holds JAX bf16's loss terms (jitted, as the JAX trainer runs a step)
and per leaf the atol (a fraction of the ``rb2d`` file's scale) at which
JAX bf16's gradient meets the float64 leaf (``need/``) and its relative
L2 distance from it (``relnorm/``); the bf16 leaves themselves are not
kept. Needs the ``rb2d`` file; a few minutes on the CPU.

``rb2d_resume`` resumes the committed flagship checkpoint
(``--ckpt``, the step of ``assets/r5_rb2d_4x_e900_230400_opt.npz``) as
the JAX ``CheckpointManager`` does, with a ``--resume_epochs`` cosine
schedule (the flagship's own, 900 epochs, ends at the checkpoint: its
learning rate there is 0), and takes one JAX f32 step on a batch of the
RB2D val simulation (``--data_folder``/``--resume_data``, drawn with
``--batch_seed``; ``data/regen_rb2d.sh`` makes it). The file holds the
batch, the loss terms and the gradients' global norm (JAX f32, and the
port's float64 recomputation), per parameter the L2 norms of the
changes of the parameter, ``mu`` and ``nu`` (``norm/dp|dmu|dnu/``), and
for the ImNet leaves the whole parameter change (``dp/``) with the atol
(a fraction of its largest magnitude) at which it meets a float64 Adam
step from the same moments at rtol ``DP_RTOL`` (``dp_need/``).

Runs on the CPU (JAX is forced there), a few minutes and a few GB.
Usage:
    python scripts/export_torch_train_ref.py \
        [--recipe turb3d | rb2d_bn | rb2d_bf16 | rb2d_resume]
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from export_torch_params import optimizer_state, restore  # JAX on the CPU

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from space_time_pde_tpu.data import RB2DataLoader, save_npz, \
    taylor_green_fields
from space_time_pde_tpu.data.dataset4d import Field4DDataset
from space_time_pde_tpu.data.generator import (
    abc_flow_fields, beltrami_realization_params)
from space_time_pde_tpu.models import ImNet, UNet4d
from space_time_pde_tpu.physics.systems import get_pde_layer
from space_time_pde_tpu.train import build_models, init_state, make_loss_fn
from space_time_pde_tpu.train.trainer import make_optimizer
from space_time_pde_tpu.utils.checkpoint import CheckpointManager
from space_time_pde_tpu.utils.config import Config
from space_time_pde_torch import bridge
from space_time_pde_torch import physics as tphysics
from space_time_pde_torch import train as ttrain
from space_time_pde_torch.utils.config import Config as TConfig

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "space_time_pde_torch", "assets")
TG_SHAPE = (32, 128, 256)      # Taylor–Green frames, z, x
BELTRAMI_SEED = 42             # a training realization
TURB3D_CROP = (8, 32, 32, 32)  # nt, nz, ny, nx
TURB3D_DOWNSAMP = (2, 4)       # t, xyz
GRAD_RTOL = 1e-4
DP_RTOL = 1e-3                 # rb2d_resume: the parameter update
ZERO_GRAD = 1e-12              # a gradient leaf this far below the top is 0
RECIPES = {"rb2d": "rb2d_train_step_ref.npz",
           "rb2d_bn": "rb2d_bn_train_step_ref.npz",
           "turb3d": "turb3d_train_step_ref.npz",
           "rb2d_bf16": "rb2d_bf16_train_step_ref.npz",
           "rb2d_resume": "rb2d_resume_step_ref.npz"}


def flagship_config(recipe: str) -> dict:
    cfg = Config()
    cfg.model.lat_dims, cfg.model.unet_nf, cfg.model.imnet_nf = 64, 32, 64
    d, t = cfg.data, cfg.train
    d.n_samp_pts_per_crop = 1024
    t.alpha_pde, t.lr, t.lr_schedule = 0.1, 5e-3, "cosine"
    t.pde_loss_type, t.reg_loss_type, t.pde_derivs = "huber", "l1", "jet"
    if recipe == "rb2d":
        d.nt, d.nz, d.nx, d.downsamp_t, d.downsamp_xz = 16, 128, 128, 4, 8
        t.batch_size_per_gpu = 8
    else:
        # experiments/turb3d/train.py::make_config with the recipe's flags.
        cfg.model.unet_mf = 256
        d.nt, d.nz, d.downsamp_t = TURB3D_CROP[0], TURB3D_CROP[1], \
            TURB3D_DOWNSAMP[0]
        t.batch_size_per_gpu = 4
        cfg.physics.pde_system, cfg.physics.viscosity = "ns3d", 1e-2
    return cfg.to_dict()


def make_batch(recipe: str, cfg, batch_seed: int):
    """(dataset, batch) of the recipe, data made from its closed form."""
    with tempfile.TemporaryDirectory() as tmp:
        d = cfg.data
        if recipe == "rb2d":
            nt, nz, nx = TG_SHAPE
            save_npz(os.path.join(tmp, "tg.npz"),
                     taylor_green_fields(nt=nt, nz=nz, nx=nx))
            ds = RB2DataLoader(
                data_folder=tmp, data_filename="tg.npz", nt=d.nt, nz=d.nz,
                nx=d.nx, n_samp_pts_per_crop=d.n_samp_pts_per_crop,
                downsamp_t=d.downsamp_t, downsamp_xz=d.downsamp_xz)
        else:
            a, b, c, phases = beltrami_realization_params(BELTRAMI_SEED)
            save_npz(os.path.join(tmp, "b.npz"), abc_flow_fields(
                nt=24, nz=32, ny=32, nx=32, A=a, B=b, C=c, phases=phases))
            nt, nz, ny, nx = TURB3D_CROP
            ds = Field4DDataset(
                data_folder=tmp, data_filename="b.npz", nt=nt, nz=nz, ny=ny,
                nx=nx, n_samp_pts_per_crop=d.n_samp_pts_per_crop,
                downsamp_t=TURB3D_DOWNSAMP[0],
                downsamp_xyz=TURB3D_DOWNSAMP[1])
    return ds, ds.sample_batch(np.random.RandomState(batch_seed),
                               cfg.train.batch_size_per_gpu)


def jax_models(recipe: str, cfg, lres_shape):
    if recipe == "rb2d":
        return build_models(cfg, lres_shape)
    # experiments/turb3d/train.py::build_turb3d_models.
    m = cfg.model
    return (UNet4d(in_features=4, out_features=m.lat_dims,
                   igres=tuple(lres_shape), nf=m.unet_nf, mf=m.unet_mf),
            ImNet(dim=4, in_features=m.lat_dims, out_features=4,
                  nf=m.imnet_nf))


def pde_kwargs(recipe: str, cfg, extents):
    if recipe == "rb2d":
        return dict(t_crop=extents[0], z_crop=extents[1], x_crop=extents[2],
                    rayleigh=cfg.physics.rayleigh,
                    prandtl=cfg.physics.prandtl)
    return dict(t_crop=extents[0], z_crop=extents[1], y_crop=extents[2],
                x_crop=extents[3], viscosity=cfg.physics.viscosity)


def atol_needed(got, want, rtol=GRAD_RTOL, scale=None):
    """Smallest atol (a fraction of ``scale``, default max |want|) with
    |got - want| <= rtol |want| + atol scale everywhere."""
    scale = float(np.abs(want).max()) if scale is None else scale
    if scale == 0.0:
        return 0.0, 0.0
    need = float(np.max(np.abs(got - want) - rtol * np.abs(want))) / scale
    return max(0.0, need), scale


class _Fixed(torch.nn.Module):
    """An encoder stand-in that returns a latent computed beforehand."""

    def __init__(self, latent):
        super().__init__()
        self.latent = latent

    def forward(self, lres):
        return self.latent


def float64_step(tcfg, tunet, timnet, tpde, batch):
    """The port's plain path in float64 on the CPU: the encoder (train
    mode) over the whole batch, as BatchNorm's statistics need, then the
    decode and the loss one batch element at a time (the loss is a mean
    over equal-sized elements, so it and its gradient are the means of
    theirs), the latent's gradient summed and sent back through the
    encoder. Leaves the gradients in the parameters' ``.grad`` and the
    new running statistics in the encoder's buffers; returns the loss
    terms."""
    tunet.train()
    latent = tunet(torch.from_numpy(batch["lres"]).double())
    lat = latent.detach().requires_grad_(True)
    b = lat.shape[0]
    terms64 = {}
    for i in range(b):
        part = {k: torch.from_numpy(v[i:i + 1]).double()
                for k, v in batch.items()}
        loss_i, m_i = ttrain.make_loss_fn(
            tcfg, _Fixed(lat[i:i + 1]), timnet, tpde)(part)
        (loss_i / b).backward()
        for k, v in m_i.items():
            terms64[k] = terms64.get(k, 0.0) + float(v.detach()) / b
    latent.backward(lat.grad)
    return terms64


def port_float64(cfg_dict, lres_shape, params, batch_stats, pde_args,
                 batch):
    """(unet, imnet, terms64) of :func:`float64_step` with ``params``."""
    tcfg = TConfig.from_dict(cfg_dict)
    tcfg.train.pde_derivs = "jet_jnp"
    tunet, timnet = ttrain.build_models(tcfg, lres_shape, "cpu")
    bridge.load_flax_params(tunet, params["unet"], batch_stats)
    bridge.load_flax_params(timnet, params["imnet"])
    tunet.double()
    timnet.double()
    system, mean, std, kw = pde_args
    tpde = tphysics.get_pde_layer(system, mean=mean.astype(np.float64),
                                  std=std.astype(np.float64), **kw)
    return tunet, timnet, float64_step(tcfg, tunet, timnet, tpde, batch)


def _port_leaves(tree, modules):
    """``{"unet.<name>": array}`` of a flax tree in the params' layout."""
    out = {}
    for name, module in modules.items():
        sd = bridge.state_dict_from_flax(module, tree[name], buffers=False)
        out.update({f"{name}.{k}": sd[k].numpy().astype(np.float64)
                    for k, _ in module.named_parameters()})
    return out


def _stats_leaves(batch_stats):
    """``{"<layer>.running_mean" | ".running_var": array}``."""
    names = {"mean": "running_mean", "var": "running_var"}
    out = {}
    for k, v in bridge.flatten_tree(batch_stats).items():
        layer, leaf = k.rsplit("/", 1)
        out[f"{layer.replace('/', '.')}.{names[leaf]}"] = np.asarray(v)
    return out


def step_reference(args):
    """The ``rb2d``, ``rb2d_bn`` and ``turb3d`` files: seeded weights,
    one value_and_grad in JAX f32 against the port in float64."""
    recipe = "turb3d" if args.recipe == "turb3d" else "rb2d"
    cfg_dict = flagship_config(recipe)
    if args.recipe == "rb2d_bn":
        cfg_dict["model"]["norm"] = "batch"
    cfg = Config.from_dict(cfg_dict)
    system = cfg.physics.pde_system

    ds, batch = make_batch(recipe, cfg, args.batch_seed)
    extents = np.asarray(ds.coord_extents, np.float64)
    dim = len(ds.lres_shape)

    # JAX, float32: the weights from the seed, one value_and_grad.
    unet, imnet = jax_models(recipe, cfg, ds.lres_shape)
    lres = jnp.asarray(batch["lres"])
    uvars = jax.jit(unet.init)(jax.random.PRNGKey(0), lres)
    template = {
        "unet": uvars["params"],
        "imnet": jax.jit(imnet.init)(
            jax.random.PRNGKey(1),
            jnp.zeros((1, dim + cfg.model.lat_dims)))["params"]}
    shapes = {k: list(np.shape(v))
              for k, v in bridge.flatten_tree(template).items()}
    params = bridge.seeded_flax_params(shapes, args.weight_seed)
    # BatchNorm's running statistics start where flax starts them.
    batch_stats = (jax.tree.map(np.asarray, uvars["batch_stats"])
                   if "batch_stats" in uvars else None)
    pde = get_pde_layer(system, mean=ds.channel_mean, std=ds.channel_std,
                        **pde_kwargs(recipe, cfg, extents))
    loss_fn = make_loss_fn(cfg, unet, imnet, pde)
    extra = () if batch_stats is None else (batch_stats,)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree.map(jnp.asarray, params),
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                *extra)
    new_stats32 = metrics.pop("_batch_stats", None)
    terms32 = {k: float(v) for k, v in metrics.items()}
    print(f"JAX f32: {terms32}", flush=True)

    tunet, timnet, terms64 = port_float64(
        cfg_dict, ds.lres_shape, params, batch_stats,
        (system, ds.channel_mean, ds.channel_std,
         pde_kwargs(recipe, cfg, extents)), batch)
    print(f"port f64: {terms64}", flush=True)

    out = {
        "spec": np.asarray(json.dumps({
            "config": cfg_dict, "shapes": shapes,
            "weight_seed": args.weight_seed, "batch_seed": args.batch_seed,
            "recipe": args.recipe, "grad_rtol": GRAD_RTOL,
            "data": (list(TG_SHAPE) if recipe == "rb2d" else
                     {"beltrami_seed": BELTRAMI_SEED,
                      "crop": list(TURB3D_CROP),
                      "downsamp": list(TURB3D_DOWNSAMP)}),
            "terms32": terms32, "terms64": terms64}, sort_keys=True)),
        "lres": batch["lres"], "point_coord": batch["point_coord"],
        "point_value": batch["point_value"],
        "channel_mean": ds.channel_mean, "channel_std": ds.channel_std,
        "coord_extents": extents,
    }
    g_np = jax.tree.map(np.asarray, grads)
    worst = 0.0
    # A leaf whose float64 gradient is 0 up to rounding (a conv bias right
    # before a BatchNorm, whose mean subtraction cancels it) is read
    # against the model's largest gradient: both f32 values are noise.
    top = max(float(p.grad.abs().max()) for m in (tunet, timnet)
              for p in m.parameters())
    for name, module in (("unet", tunet), ("imnet", timnet)):
        g32 = bridge.state_dict_from_flax(module, g_np[name], buffers=False)
        for k, p in module.named_parameters():
            key = f"{name}.{k}"
            g64 = p.grad.numpy()
            leaf_max = float(np.abs(g64).max())
            need, scale = atol_needed(
                g32[k].numpy().astype(np.float64), g64,
                scale=leaf_max if leaf_max > ZERO_GRAD * top else top)
            out[f"relnorm/{key}"] = np.float64(
                np.linalg.norm(g32[k].numpy() - g64) / np.linalg.norm(g64))
            out[f"grad64/{key}"] = g64.astype(np.float32)
            out[f"need/{key}"] = np.float64(need)
            out[f"scale/{key}"] = np.float64(scale)
            worst = max(worst, need)
            print(f"{key:40s} max|g64| {scale:.4e}  JAX f32 needs atol "
                  f"{need:.3e} x max at rtol {GRAD_RTOL:g}")
    if new_stats32 is not None:
        # The new running statistics: JAX f32 and float64.
        stats32 = _stats_leaves(jax.tree.map(np.asarray, new_stats32))
        buffers = dict(tunet.named_buffers())
        stats_worst = 0.0
        for key, v32 in stats32.items():
            v64 = buffers[key].numpy()
            out[f"stats32/unet.{key}"] = v32
            out[f"stats64/unet.{key}"] = v64
            stats_worst = max(stats_worst, atol_needed(
                v32.astype(np.float64), v64)[0])
        print(f"{len(stats32)} running statistics: JAX f32 needs atol "
              f"{stats_worst:.3e} x max at rtol {GRAD_RTOL:g}")
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB); "
          f"worst JAX f32 leaf needs atol {worst:.3e}; loss rel diff f32 vs "
          f"f64 {abs(terms32['loss'] - terms64['loss']) / abs(terms64['loss']):.3e}")


def bf16_step_reference(args):
    """The ``rb2d_bf16`` file: the ``rb2d`` file's step in JAX under
    ``use_bf16``, held to that file's float64 gradients."""
    with np.load(os.path.join(ASSETS, RECIPES["rb2d"]),
                 allow_pickle=False) as z:
        ref = {k: z[k] for k in z.files}
    spec = json.loads(str(ref["spec"]))
    cfg_dict = spec["config"]
    cfg_dict["model"]["use_bf16"] = True
    cfg = Config.from_dict(cfg_dict)
    batch = {k: ref[k] for k in ("lres", "point_coord", "point_value")}
    unet, imnet = build_models(cfg, batch["lres"].shape[1:4])
    params = bridge.seeded_flax_params(spec["shapes"], spec["weight_seed"])
    pde = get_pde_layer(
        cfg.physics.pde_system, mean=ref["channel_mean"],
        std=ref["channel_std"],
        **pde_kwargs("rb2d", cfg, ref["coord_extents"]))
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        make_loss_fn(cfg, unet, imnet, pde), has_aux=True))(
            jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    terms = {k: float(v) for k, v in metrics.items()}
    print(f"JAX bf16: {terms}\nJAX f32:  {spec['terms32']}", flush=True)
    out = {"spec": np.asarray(json.dumps({
        "config": cfg_dict, "step_ref": RECIPES["rb2d"],
        "terms_bf16": terms, "terms32": spec["terms32"],
        "terms64": spec["terms64"], "grad_rtol": GRAD_RTOL},
        sort_keys=True))}
    g_np = jax.tree.map(np.asarray, grads)
    modules = dict(zip(("unet", "imnet"), ttrain.build_models(
        TConfig.from_dict(cfg_dict), batch["lres"].shape[1:4], "cpu")))
    worst = 0.0
    for key, g16 in _port_leaves(g_np, modules).items():
        g64 = ref[f"grad64/{key}"].astype(np.float64)
        need, _ = atol_needed(g16, g64, scale=float(ref[f"scale/{key}"]))
        out[f"need/{key}"] = np.float64(need)
        out[f"relnorm/{key}"] = np.float64(
            np.linalg.norm(g16 - g64) / np.linalg.norm(g64))
        worst = max(worst, need)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB); "
          f"worst JAX bf16 leaf needs atol {worst:.3e} x its scale at rtol "
          f"{GRAD_RTOL:g} against float64")


def restore_jax(ckpt_dir: str, step: int, template):
    """The JAX ``CheckpointManager``'s own resume of ``ckpt_dir/step``
    (with ``template``; from a temporary copy)."""
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(ckpt_dir, str(step)),
                        os.path.join(tmp, str(step)))
        mngr = CheckpointManager(tmp)
        try:
            return mngr.restore(template, step=step)
        finally:
            mngr.close()


def resume_reference(args):
    """The ``rb2d_resume`` file: the committed flagship checkpoint
    resumed with a ``--resume_epochs`` cosine schedule, one step on a
    batch of the RB2D val simulation."""
    with np.load(os.path.join(ASSETS, "r5_rb2d_4x_e900_230400_opt.npz"),
                 allow_pickle=False) as z:
        step = int(z["step"])
    state0, extra = restore(args.ckpt, step)
    cfg_dict = extra["config"]
    cfg_dict["train"]["epochs"] = args.resume_epochs
    cfg = Config.from_dict(cfg_dict)
    d = cfg.data
    steps_per_epoch = cfg.train.pseudo_epoch_size // \
        cfg.train.batch_size_per_gpu
    ds = RB2DataLoader(
        data_folder=args.data_folder, data_filename=args.resume_data,
        nt=d.nt, nz=d.nz, nx=d.nx, n_samp_pts_per_crop=d.n_samp_pts_per_crop,
        downsamp_t=d.downsamp_t, downsamp_xz=d.downsamp_xz,
        normalize_output=d.normalize_channels, lres_filter=d.lres_filter,
        lres_interp=d.lres_interp)
    ds.channel_mean = np.asarray(extra["channel_mean"], np.float32)
    ds.channel_std = np.asarray(extra["channel_std"], np.float32)
    batch = ds.sample_batch(np.random.RandomState(args.batch_seed),
                            cfg.train.batch_size_per_gpu)
    extents = np.asarray(ds.coord_extents, np.float64)

    unet, imnet = build_models(cfg, ds.lres_shape)
    tx = make_optimizer(cfg, steps_per_epoch)
    state, _ = restore_jax(args.ckpt, step, init_state(
        jax.random.PRNGKey(0), cfg, unet, imnet, tx))
    assert int(state.step) == step == int(state0.step)
    pde = get_pde_layer(cfg.physics.pde_system, mean=ds.channel_mean,
                        std=ds.channel_std, **pde_kwargs("rb2d", cfg,
                                                         extents))
    loss_fn = make_loss_fn(cfg, unet, imnet, pde)
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(state.params,
                                {k: jnp.asarray(v) for k, v in batch.items()})
    updates, opt2 = tx.update(grads, state.opt_state, state.params)
    params2 = optax.apply_updates(state.params, updates)
    terms32 = {k: float(v) for k, v in metrics.items()}
    terms32["grad_norm"] = float(optax.global_norm(grads))
    lr = float(optax.cosine_decay_schedule(
        cfg.train.lr, cfg.train.epochs * steps_per_epoch)(step))
    print(f"JAX f32 at count {step}, lr {lr:.6g}: {terms32}", flush=True)

    np_tree = lambda t: jax.tree.map(np.asarray, t)
    opt1, opt2 = (optimizer_state(o)[0] for o in (state.opt_state, opt2))
    tunet, timnet, terms64 = port_float64(
        cfg_dict, ds.lres_shape, np_tree(state.params), None,
        (cfg.physics.pde_system, ds.channel_mean, ds.channel_std,
         pde_kwargs("rb2d", cfg, extents)), batch)
    modules = {"unet": tunet, "imnet": timnet}
    leaves = {k: _port_leaves(np_tree(t), modules) for k, t in (
        ("p", state.params), ("p2", params2), ("mu", opt1["mu"]),
        ("mu2", opt2["mu"]), ("nu", opt1["nu"]), ("nu2", opt2["nu"]))}
    g64 = {f"{n}.{k}": p.grad.numpy() for n, m in modules.items()
           for k, p in m.named_parameters()}
    norm64 = np.sqrt(sum(np.sum(g * g) for g in g64.values()))
    terms64["grad_norm"] = float(norm64)
    print(f"port f64: {terms64}", flush=True)
    # Adam in float64 from the same moments (optax's formulas).
    clip = cfg.train.clip_grad
    count = int(opt1["count"]) + 1
    bc1, bc2 = 1 - 0.9 ** count, 1 - 0.999 ** count
    out = {
        "spec": np.asarray(json.dumps({
            "config": cfg_dict, "recipe": args.recipe, "step": step,
            "steps_per_epoch": steps_per_epoch, "lr": lr,
            "data": args.resume_data, "batch_seed": args.batch_seed,
            "dp_rtol": DP_RTOL, "terms32": terms32, "terms64": terms64},
            sort_keys=True)),
        "lres": batch["lres"], "point_coord": batch["point_coord"],
        "point_value": batch["point_value"],
        "channel_mean": ds.channel_mean, "channel_std": ds.channel_std,
        "coord_extents": extents,
    }
    worst = 0.0
    for key, g in g64.items():
        if clip and norm64 >= clip:
            g = g / norm64 * clip
        mu2 = 0.1 * g + 0.9 * leaves["mu"][key]
        nu2 = 0.001 * g * g + 0.999 * leaves["nu"][key]
        dp64 = -lr * (mu2 / bc1) / (np.sqrt(nu2 / bc2) + 1e-8)
        dp32 = leaves["p2"][key] - leaves["p"][key]
        for what, a, b in (("dp", "p2", "p"), ("dmu", "mu2", "mu"),
                           ("dnu", "nu2", "nu")):
            out[f"norm/{what}/{key}"] = np.float64(np.linalg.norm(
                leaves[a][key] - leaves[b][key]))
        if key.startswith("imnet."):
            need = atol_needed(dp32, dp64, DP_RTOL)[0]
            worst = max(worst, need)
            out[f"dp/{key}"] = dp32.astype(np.float32)
            out[f"dp_need/{key}"] = np.float64(need)
    print(f"ImNet dp: JAX f32 needs atol {worst:.3e} x max|dp64| at rtol "
          f"{DP_RTOL:g} against float64 Adam")
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB)")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--recipe", choices=RECIPES, default="rb2d")
    parser.add_argument("--out", default=None,
                        help="default: the assets' file of the recipe")
    parser.add_argument("--weight_seed", type=int, default=0)
    parser.add_argument("--batch_seed", type=int, default=1)
    parser.add_argument("--ckpt", default="log/r5_rb2d_4x_e900/checkpoints",
                        help="rb2d_resume: the orbax checkpoint directory")
    parser.add_argument("--resume_epochs", type=int, default=1800,
                        help="rb2d_resume: the resumed run's --epochs")
    parser.add_argument("--data_folder", default="data")
    parser.add_argument("--resume_data", default="rb2d_ra1e6_s7.npz",
                        help="rb2d_resume: the simulation of the batch")
    args = parser.parse_args(argv)
    args.out = args.out or os.path.join(ASSETS, RECIPES[args.recipe])
    if args.recipe == "rb2d_resume":
        resume_reference(args)
    elif args.recipe == "rb2d_bf16":
        bf16_step_reference(args)
    else:
        step_reference(args)


if __name__ == "__main__":
    main()
