"""Export a JAX-CPU reference of one rb2d flagship training step.

Writes ``space_time_pde_torch/assets/rb2d_train_step_ref.npz``, which
``chip_smoke.py`` holds the port's training step on the card against:

- the step: the flagship's widths (lat_dims 64, unet_nf 32, imnet_nf 64,
  igres (4, 16, 16)), batch 8 x 1,024 points, alpha_pde 0.1, huber PDE
  loss, l1 regression, the RB2 equations at Ra 1e6, Pr 1, the jet
  derivatives (``--pde_derivs jet``, the JAX jnp jet on the CPU);
- the batch: drawn by the JAX ``RB2DataLoader`` with
  ``RandomState(--batch_seed)`` from a Taylor–Green field (32 x 128 x
  256 frames, made from the closed form), stored with its channel stats;
- the weights: not stored. Both packages draw them from
  ``--weight_seed`` with ``bridge.seeded_flax_params`` over the parameter
  paths and shapes that the file lists;
- the JAX float32 loss terms and every gradient leaf (in the port's
  layout, keyed by its parameter names);
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
    python scripts/export_torch_train_ref.py
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
from space_time_pde_tpu.physics.systems import get_pde_layer
from space_time_pde_tpu.train import build_models, make_loss_fn
from space_time_pde_tpu.utils.config import Config
from space_time_pde_torch import bridge
from space_time_pde_torch import physics as tphysics
from space_time_pde_torch import train as ttrain
from space_time_pde_torch.utils.config import Config as TConfig

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                   "space_time_pde_torch", "assets", "rb2d_train_step_ref.npz")
TG_SHAPE = (32, 128, 256)      # Taylor–Green frames, z, x
GRAD_RTOL = 1e-4


def flagship_config() -> dict:
    cfg = Config()
    cfg.model.lat_dims, cfg.model.unet_nf, cfg.model.imnet_nf = 64, 32, 64
    d = cfg.data
    d.nt, d.nz, d.nx, d.downsamp_t, d.downsamp_xz = 16, 128, 128, 4, 8
    d.n_samp_pts_per_crop = 1024
    t = cfg.train
    t.batch_size_per_gpu, t.alpha_pde, t.lr, t.lr_schedule = 8, 0.1, 5e-3, \
        "cosine"
    t.pde_loss_type, t.reg_loss_type, t.pde_derivs = "huber", "l1", "jet"
    return cfg.to_dict()


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
    parser.add_argument("--out", default=OUT)
    parser.add_argument("--weight_seed", type=int, default=0)
    parser.add_argument("--batch_seed", type=int, default=1)
    args = parser.parse_args(argv)
    cfg_dict = flagship_config()
    cfg = Config.from_dict(cfg_dict)

    with tempfile.TemporaryDirectory() as tmp:
        nt, nz, nx = TG_SHAPE
        save_npz(os.path.join(tmp, "tg.npz"),
                 taylor_green_fields(nt=nt, nz=nz, nx=nx))
        d = cfg.data
        ds = RB2DataLoader(
            data_folder=tmp, data_filename="tg.npz", nt=d.nt, nz=d.nz,
            nx=d.nx, n_samp_pts_per_crop=d.n_samp_pts_per_crop,
            downsamp_t=d.downsamp_t, downsamp_xz=d.downsamp_xz)
    batch = ds.sample_batch(np.random.RandomState(args.batch_seed),
                            cfg.train.batch_size_per_gpu)
    extents = np.asarray(ds.coord_extents, np.float64)

    # JAX, float32: the weights from the seed, one value_and_grad.
    unet, imnet = build_models(cfg, ds.lres_shape)
    lres = jnp.asarray(batch["lres"])
    template = {
        "unet": jax.jit(unet.init)(jax.random.PRNGKey(0), lres)["params"],
        "imnet": jax.jit(imnet.init)(
            jax.random.PRNGKey(1),
            jnp.zeros((1, 3 + cfg.model.lat_dims)))["params"]}
    shapes = {k: list(np.shape(v))
              for k, v in bridge.flatten_tree(template).items()}
    params = bridge.seeded_flax_params(shapes, args.weight_seed)
    pde = get_pde_layer("rb2d", mean=ds.channel_mean, std=ds.channel_std,
                        t_crop=extents[0], z_crop=extents[1],
                        x_crop=extents[2], rayleigh=cfg.physics.rayleigh,
                        prandtl=cfg.physics.prandtl)
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
        "rb2d", mean=ds.channel_mean.astype(np.float64),
        std=ds.channel_std.astype(np.float64), t_crop=extents[0],
        z_crop=extents[1], x_crop=extents[2], rayleigh=cfg.physics.rayleigh,
        prandtl=cfg.physics.prandtl)
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
            "tg_shape": TG_SHAPE, "grad_rtol": GRAD_RTOL,
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
            out[f"grad/{key}"] = g32[k].numpy()
            out[f"grad64/{key}"] = g64.astype(np.float32)
            out[f"need/{key}"] = np.float64(need)
            out[f"scale/{key}"] = np.float64(scale)
            worst = max(worst, need)
            print(f"{key:40s} max|g64| {scale:.4e}  JAX f32 needs atol "
                  f"{need:.3e} x max at rtol {GRAD_RTOL:g}")
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB); "
          f"worst JAX f32 leaf needs atol {worst:.3e}; loss rel diff f32 vs "
          f"f64 {abs(terms32['loss'] - terms64['loss']) / abs(terms64['loss']):.3e}")


if __name__ == "__main__":
    main()
