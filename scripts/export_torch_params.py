"""Export an orbax checkpoint of the JAX package for the PyTorch port.

Restores ``<ckpt>/<step>`` with the JAX package's ``CheckpointManager``
from a temporary copy (the checkpoint directory itself is never
written) and writes one ``.npz`` that the port reads with numpy alone
(``space_time_pde_torch/bridge.py::load_exported``): the ``params`` and
``batch_stats`` trees, ``channel_mean`` / ``channel_std``, ``step`` and
the training config as JSON.

Beside it, ``<out>_ref.npz`` holds a JAX-CPU reference for the port's
smoke run on the card: on a Taylor–Green dataset at the flagship eval
geometry (``--tg_nt`` x 128 x 512 frames, made from the closed form), the
window starting at frame 0 is encoded by the JAX ``UNet3d`` at the eval
igres and decoded by the JAX jnp query path at ``--ref_points`` lattice
points drawn with ``--seed``; the file keeps the flat lattice indices,
the decoder outputs (normalised units) in float32 and, recomputed with
jax x64, in float64, and the geometry.

Runs on the CPU (JAX is forced there). Usage:
    python scripts/export_torch_params.py \
        --ckpt log/r5_rb2d_4x_e900/checkpoints --step 230400 \
        --out space_time_pde_torch/assets/r5_rb2d_4x_e900_230400.npz
"""

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from space_time_pde_tpu.data import RB2DataLoader, save_npz, \
    taylor_green_fields
from space_time_pde_tpu.models import query_local_implicit_grid
from space_time_pde_tpu.train import build_models
from space_time_pde_tpu.utils.checkpoint import CheckpointManager
from space_time_pde_tpu.utils.config import Config
from space_time_pde_torch.bridge import save_exported


def restore(ckpt_dir: str, step: int):
    """(state, extra) of ``ckpt_dir/step``, read from a temporary copy."""
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(ckpt_dir, str(step)),
                        os.path.join(tmp, str(step)))
        mngr = CheckpointManager(tmp)
        try:
            return mngr.restore(step=step)
        finally:
            mngr.close()


def reference(cfg: Config, params, batch_stats, channel_mean, channel_std,
              tg_nt: int, n_points: int, seed: int):
    """JAX-CPU decoder outputs of Taylor–Green window 0 at seeded
    lattice points (see the module docstring)."""
    nz, nx, nt = 128, 512, cfg.data.nt
    with tempfile.TemporaryDirectory() as tmp:
        save_npz(os.path.join(tmp, "tg.npz"),
                 taylor_green_fields(nt=tg_nt, nz=nz, nx=nx))
        ds = RB2DataLoader(
            data_folder=tmp, data_filename="tg.npz", nt=nt,
            nz=cfg.data.nz, nx=cfg.data.nx, downsamp_t=cfg.data.downsamp_t,
            downsamp_xz=cfg.data.downsamp_xz,
            normalize_output=cfg.data.normalize_channels,
            lres_filter=cfg.data.lres_filter, lres_interp=cfg.data.lres_interp)
    ds.channel_mean = np.asarray(channel_mean, np.float32)
    ds.channel_std = np.asarray(channel_std, np.float32)
    lres = ds.full_lres_sequence(0, nt)
    unet, imnet = build_models(cfg, lres.shape[:3])
    uvars = {"params": params["unet"]}
    if batch_stats is not None:
        uvars["batch_stats"] = batch_stats
    latent = jax.jit(unet.apply)(uvars, jnp.asarray(lres)[None])
    out_shape = (nt, nz, nx)
    idx = np.sort(np.random.RandomState(seed).choice(
        int(np.prod(out_shape)), n_points, replace=False)).astype(np.int64)
    axes = [np.linspace(0, 1, n, dtype=np.float32) for n in out_shape]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    vals = query_local_implicit_grid(
        lambda v: imnet.apply({"params": params["imnet"]}, v),
        latent, jnp.asarray(pts[idx])[None])[0]
    # The same computation in float64: how far f32 itself lands from it
    # is the noise floor the port's error is read against.
    jax.config.update("jax_enable_x64", True)
    f64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                    tree)
    uvars64 = dict(f64(uvars))
    lat64 = unet.clone(dtype=jnp.float64).apply(
        uvars64, jnp.asarray(lres, jnp.float64)[None])
    imnet64 = imnet.clone(dtype=jnp.float64)
    vals64 = query_local_implicit_grid(
        lambda v: imnet64.apply({"params": f64(params["imnet"])}, v),
        lat64, jnp.asarray(pts[idx], jnp.float64)[None])[0]
    jax.config.update("jax_enable_x64", False)
    return {"index": idx, "values": np.asarray(vals, np.float32),
            "values_f64": np.asarray(vals64, np.float64),
            "out_shape": np.asarray(out_shape), "tg_nt": np.asarray(tg_nt),
            "t0": np.asarray(0), "seed": np.asarray(seed),
            "lres_shape": np.asarray(lres.shape)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt", required=True,
                        help="orbax checkpoint directory")
    parser.add_argument("--step", type=int, required=True)
    parser.add_argument("--out", required=True, help="output .npz")
    parser.add_argument("--ref_points", type=int, default=4096,
                        help="JAX reference points (0 = no reference)")
    parser.add_argument("--tg_nt", type=int, default=32,
                        help="frames of the reference Taylor–Green data")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    state, extra = restore(args.ckpt, args.step)
    params = jax.tree.map(np.asarray, state.params)
    batch_stats = (jax.tree.map(np.asarray, state.batch_stats)
                   if state.batch_stats is not None else None)
    save_exported(args.out, params, batch_stats, extra["config"],
                  extra["channel_mean"], extra["channel_std"],
                  int(state.step))
    n = sum(int(np.size(v)) for v in jax.tree.leaves(params))
    print(f"wrote {args.out}: step {int(state.step)}, {n} parameters")
    if args.ref_points:
        ref = reference(Config.from_dict(extra["config"]), params,
                        batch_stats, extra["channel_mean"],
                        extra["channel_std"], args.tg_nt, args.ref_points,
                        args.seed)
        path = os.path.splitext(args.out)[0] + "_ref.npz"
        np.savez_compressed(path, **ref)
        print(f"wrote {path}: {args.ref_points} JAX-CPU reference points")


if __name__ == "__main__":
    main()
