"""Export a JAX-CPU reference of one flagship training step.

Writes ``space_time_pde_torch/assets/<recipe>_train_step_ref.npz``,
which ``chip_smoke.py`` holds the port's training step on the card
against. Two recipes:

- ``rb2d`` (default): the rb2d flagship's widths (lat_dims 64, unet_nf
  32, imnet_nf 64, igres (4, 16, 16)), batch 8 x 1,024 points, the RB2
  equations at Ra 1e6, Pr 1; the batch drawn by the JAX
  ``RB2DataLoader`` from a Taylor–Green field (32 x 128 x 256 frames,
  made from the closed form);
- ``turb3d``: the ``r5_turb3d_200x_big`` recipe
  (``log/r5_turb3d_200x_big/command.sh``): UNet4d nf 32 / mf 256 (the
  driver's default), lat_dims 64, ImNet(dim=4) nf 64, crop (8, 32, 32,
  32) down-sampled t 2 / xyz 4 to igres (4, 8, 8, 8), batch 4 x 1,024
  points, the ns3d equations at viscosity 1e-2; the batch drawn by the
  JAX ``Field4DDataset`` from the Beltrami realization of seed 42 (a
  training seed, 24 x 32^3, made from the closed form).

Both: alpha_pde 0.1, huber PDE loss, l1 regression, the jet derivatives
(``--pde_derivs jet``, the JAX jnp jet on the CPU). The file holds:

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
  cast their outputs to float32, so they cannot give one), one batch
  element at a time: its loss terms, its gradient leaves (rounded to
  float32 for size: 6e-8 relative, far below the tolerance), and per
  leaf its largest magnitude and the ``atol`` (a fraction of that) at
  which JAX's float32 leaf meets it,
  ``|g32 - g64| <= rtol |g64| + atol max|g64|``.

Runs on the CPU (JAX is forced there), a few minutes and a few GB.
Usage:
    python scripts/export_torch_train_ref.py [--recipe turb3d]
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import torch

from space_time_pde_tpu.data import RB2DataLoader, save_npz, \
    taylor_green_fields
from space_time_pde_tpu.data.dataset4d import Field4DDataset
from space_time_pde_tpu.data.generator import (
    abc_flow_fields, beltrami_realization_params)
from space_time_pde_tpu.models import ImNet, UNet4d
from space_time_pde_tpu.physics.systems import get_pde_layer
from space_time_pde_tpu.train import build_models, make_loss_fn
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


def atol_needed(got, want, rtol=GRAD_RTOL):
    """Smallest atol (a fraction of max |want|) with
    |got - want| <= rtol |want| + atol max|want| everywhere."""
    scale = float(np.abs(want).max())
    if scale == 0.0:
        return 0.0, 0.0
    need = float(np.max(np.abs(got - want) - rtol * np.abs(want))) / scale
    return max(0.0, need), scale


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--recipe", choices=("rb2d", "turb3d"),
                        default="rb2d")
    parser.add_argument("--out", default=None,
                        help="default: the assets' <recipe>_train_step_ref"
                             ".npz")
    parser.add_argument("--weight_seed", type=int, default=0)
    parser.add_argument("--batch_seed", type=int, default=1)
    args = parser.parse_args(argv)
    out_path = args.out or os.path.join(
        ASSETS, f"{args.recipe}_train_step_ref.npz")
    cfg_dict = flagship_config(args.recipe)
    cfg = Config.from_dict(cfg_dict)
    system = cfg.physics.pde_system

    ds, batch = make_batch(args.recipe, cfg, args.batch_seed)
    extents = np.asarray(ds.coord_extents, np.float64)
    dim = len(ds.lres_shape)

    # JAX, float32: the weights from the seed, one value_and_grad.
    unet, imnet = jax_models(args.recipe, cfg, ds.lres_shape)
    lres = jnp.asarray(batch["lres"])
    template = {
        "unet": jax.jit(unet.init)(jax.random.PRNGKey(0), lres)["params"],
        "imnet": jax.jit(imnet.init)(
            jax.random.PRNGKey(1),
            jnp.zeros((1, dim + cfg.model.lat_dims)))["params"]}
    shapes = {k: list(np.shape(v))
              for k, v in bridge.flatten_tree(template).items()}
    params = bridge.seeded_flax_params(shapes, args.weight_seed)
    pde = get_pde_layer(system, mean=ds.channel_mean, std=ds.channel_std,
                        **pde_kwargs(args.recipe, cfg, extents))
    loss_fn = make_loss_fn(cfg, unet, imnet, pde)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree.map(jnp.asarray, params),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    terms32 = {k: float(v) for k, v in metrics.items()}
    print(f"JAX f32: {terms32}", flush=True)

    # The port on the CPU in float64, one batch element at a time (the
    # loss is a mean over equal-sized elements, so it and its gradient
    # are the means of theirs).
    tcfg = TConfig.from_dict(cfg_dict)
    tcfg.train.pde_derivs = "jet_jnp"
    tunet, timnet = ttrain.build_models(tcfg, ds.lres_shape)
    bridge.load_flax_params(tunet, params["unet"])
    bridge.load_flax_params(timnet, params["imnet"])
    tunet.double()
    timnet.double()
    tpde = tphysics.get_pde_layer(
        system, mean=ds.channel_mean.astype(np.float64),
        std=ds.channel_std.astype(np.float64),
        **pde_kwargs(args.recipe, cfg, extents))
    tloss = ttrain.make_loss_fn(tcfg, tunet, timnet, tpde)
    b = cfg.train.batch_size_per_gpu
    terms64 = {}
    for i in range(b):
        part = {k: torch.from_numpy(v[i:i + 1]).double()
                for k, v in batch.items()}
        loss_i, m_i = tloss(part)
        (loss_i / b).backward()
        for k, v in m_i.items():
            terms64[k] = terms64.get(k, 0.0) + float(v.detach()) / b
    print(f"port f64: {terms64}", flush=True)

    out = {
        "spec": np.asarray(json.dumps({
            "config": cfg_dict, "shapes": shapes,
            "weight_seed": args.weight_seed, "batch_seed": args.batch_seed,
            "recipe": args.recipe, "grad_rtol": GRAD_RTOL,
            "data": (list(TG_SHAPE) if args.recipe == "rb2d" else
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
    for name, module in (("unet", tunet), ("imnet", timnet)):
        g32 = bridge.state_dict_from_flax(module, g_np[name])
        for k, p in module.named_parameters():
            key = f"{name}.{k}"
            g64 = p.grad.numpy()
            need, scale = atol_needed(g32[k].numpy().astype(np.float64),
                                      g64)
            out[f"relnorm/{key}"] = np.float64(
                np.linalg.norm(g32[k].numpy() - g64) / np.linalg.norm(g64))
            out[f"grad64/{key}"] = g64.astype(np.float32)
            out[f"need/{key}"] = np.float64(need)
            out[f"scale/{key}"] = np.float64(scale)
            worst = max(worst, need)
            print(f"{key:40s} max|g64| {scale:.4e}  JAX f32 needs atol "
                  f"{need:.3e} x max at rtol {GRAD_RTOL:g}")
    np.savez_compressed(out_path, **out)
    print(f"wrote {out_path} ({os.path.getsize(out_path) / 1e6:.2f} MB); "
          f"worst JAX f32 leaf needs atol {worst:.3e}; loss rel diff f32 vs "
          f"f64 {abs(terms32['loss'] - terms64['loss']) / abs(terms64['loss']):.3e}")


if __name__ == "__main__":
    main()
