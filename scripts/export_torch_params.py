"""Export an orbax checkpoint of the JAX package for the PyTorch port.

Restores ``<ckpt>/<step>`` with the JAX package's ``CheckpointManager``
from a temporary copy (the checkpoint directory itself is never
written) and writes one ``.npz`` that the port reads with numpy alone
(``space_time_pde_torch/bridge.py::load_exported``): the ``params`` and
``batch_stats`` trees, ``channel_mean`` / ``channel_std``, ``step`` and
the training config as JSON, and in ``meta`` the epoch the run stopped
at. With ``--with_opt_state`` the file also holds the optimizer state
(Adam's ``mu``, ``nu`` and count, the ``apply_if_finite`` counters), so
that the port's train CLIs resume the run from it (``--resume
<file>.npz``); ``--opt_out PATH`` writes that state to a file of its own
that names ``--out`` as its ``params_file`` (the parameters are not
stored twice). Both layouts of the JAX ``opt_state`` are read: wrapped
by ``optax.apply_if_finite``, and the legacy inner-only one of
checkpoints written before that wrap (fresh counters, as the JAX
``CheckpointManager`` gives them). Adam's count must equal the cosine
schedule's.

Beside it, ``<out>_ref.npz`` holds a JAX-CPU reference for the port's
smoke run on the card: on a Taylor–Green dataset at the flagship eval
geometry (``--tg_nt`` x 128 x 512 frames, made from the closed form), the
window starting at frame 0 is encoded by the JAX ``UNet3d`` at the eval
igres and decoded by the JAX jnp query path at ``--ref_points`` lattice
points drawn with ``--seed``; the file keeps the flat lattice indices,
the decoder outputs (normalised units) in float32 and, recomputed with
jax x64, in float64, and the geometry.

``--windows_out PATH`` writes a real-data reference of the eval CLI's
windows: for each window of the val and test splits (``--split_windows``
a split, on the canonical RB2D val and test simulations in
``--data_folder``; the same windows ``experiments/rb2d/evaluation.py
--split val|test`` evaluates), the normalised low-res input, the flat
indices of ``--ref_points`` lattice points drawn with ``--seed`` plus
the window's number, the JAX-CPU f32 decode there, its float64
recomputation and the high-res truth (physical units).

``--windows_bf16_out PATH`` writes the bf16 decode of those windows
(read from ``--windows_in``, the file ``--windows_out`` wrote, so the
datasets are not needed): each window's low-res input encoded by the
JAX ``UNet3d`` in the checkpoint's own policy, then decoded at
``compute_dtype=bfloat16`` by the TPU gather kernel
(``fused_query_local_implicit_grid``, ``gather="kernel"``, ``pad_to=0``)
in Pallas interpret mode at the same lattice points; blocks of
``BF16_BLOCK_PTS`` points keep every block inside the kernel's two
128-cell windows, so its pre-gathered fallback (which rounds elsewhere)
never runs. Beside the JAX f32 and float64 decode already in
``--windows_in``.

Runs on the CPU (JAX is forced there). Usage:
    python scripts/export_torch_params.py \
        --ckpt log/r5_rb2d_4x_e900/checkpoints --step 230400 \
        --out space_time_pde_torch/assets/r5_rb2d_4x_e900_230400.npz
    # the optimizer state beside it, and the real-data windows (needs
    # data/rb2d_ra1e6_s{7,123}.npz; data/regen_rb2d.sh makes them):
    python scripts/export_torch_params.py \
        --ckpt log/r5_rb2d_4x_e900/checkpoints --step 230400 \
        --out space_time_pde_torch/assets/r5_rb2d_4x_e900_230400.npz \
        --no_write --ref_points 0 \
        --opt_out space_time_pde_torch/assets/r5_rb2d_4x_e900_230400_opt.npz \
        --windows_out space_time_pde_torch/assets/r5_rb2d_4x_e900_230400_rb2d_windows.npz
    # the bf16 decode of those windows (no datasets needed; ~2 min):
    python scripts/export_torch_params.py \
        --ckpt log/r5_rb2d_4x_e900/checkpoints --step 230400 \
        --out space_time_pde_torch/assets/r5_rb2d_4x_e900_230400.npz \
        --no_write --ref_points 0 \
        --windows_in space_time_pde_torch/assets/r5_rb2d_4x_e900_230400_rb2d_windows.npz \
        --windows_bf16_out space_time_pde_torch/assets/r5_rb2d_4x_e900_230400_rb2d_windows_bf16.npz
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
from space_time_pde_tpu.data.splits import SplitSpec, window_starts
from space_time_pde_tpu.models import query_local_implicit_grid
from space_time_pde_tpu.ops.fused_query import (
    fused_query_local_implicit_grid)
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


def lattice_index(out_shape, n_points: int, seed: int) -> np.ndarray:
    """Sorted flat indices of ``n_points`` lattice points drawn with
    ``seed``."""
    return np.sort(np.random.RandomState(seed).choice(
        int(np.prod(out_shape)), n_points, replace=False)).astype(np.int64)


def decode_points(cfg: Config, params, batch_stats, lres, out_shape, idx):
    """(JAX f32, float64) decoder outputs of the window ``lres`` (eval
    mode) at the flat lattice indices ``idx`` of ``out_shape``."""
    unet, imnet = build_models(cfg, lres.shape[:3])
    uvars = {"params": params["unet"]}
    if batch_stats is not None:
        uvars["batch_stats"] = batch_stats
    latent = jax.jit(unet.apply)(uvars, jnp.asarray(lres)[None])
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
    return np.asarray(vals, np.float32), np.asarray(vals64, np.float64)


def _loader(cfg: Config, folder: str, filename: str, channel_mean,
            channel_std):
    ds = RB2DataLoader(
        data_folder=folder, data_filename=filename, nt=cfg.data.nt,
        nz=cfg.data.nz, nx=cfg.data.nx, downsamp_t=cfg.data.downsamp_t,
        downsamp_xz=cfg.data.downsamp_xz,
        normalize_output=cfg.data.normalize_channels,
        lres_filter=cfg.data.lres_filter, lres_interp=cfg.data.lres_interp)
    ds.channel_mean = np.asarray(channel_mean, np.float32)
    ds.channel_std = np.asarray(channel_std, np.float32)
    return ds


def reference(cfg: Config, params, batch_stats, channel_mean, channel_std,
              tg_nt: int, n_points: int, seed: int):
    """JAX-CPU decoder outputs of Taylor–Green window 0 at seeded
    lattice points (see the module docstring)."""
    nz, nx, nt = 128, 512, cfg.data.nt
    with tempfile.TemporaryDirectory() as tmp:
        save_npz(os.path.join(tmp, "tg.npz"),
                 taylor_green_fields(nt=tg_nt, nz=nz, nx=nx))
        ds = _loader(cfg, tmp, "tg.npz", channel_mean, channel_std)
    lres = ds.full_lres_sequence(0, nt)
    out_shape = (nt, nz, nx)
    idx = lattice_index(out_shape, n_points, seed)
    vals, vals64 = decode_points(cfg, params, batch_stats, lres, out_shape,
                                 idx)
    return {"index": idx, "values": vals, "values_f64": vals64,
            "out_shape": np.asarray(out_shape), "tg_nt": np.asarray(tg_nt),
            "t0": np.asarray(0), "seed": np.asarray(seed),
            "lres_shape": np.asarray(lres.shape)}


def windows_reference(cfg: Config, params, batch_stats, channel_mean,
                      channel_std, folder: str, n_windows: int,
                      n_points: int, seed: int):
    """The eval CLI's val and test windows on the canonical RB2D
    simulations (see the module docstring)."""
    spec, nt = SplitSpec.canonical(), cfg.data.nt
    out = {k: [] for k in ("lres", "index", "values", "values_f64",
                           "truth", "t0", "split")}
    files = []
    for parity, split in enumerate(("val", "test")):
        name = getattr(spec, f"{split}_data")
        files.append(name)
        ds = _loader(cfg, folder, name, channel_mean, channel_std)
        out_shape = (nt,) + ds.data.shape[1:3]
        for t0 in window_starts(ds.data.shape[0], nt, n_windows,
                                parity=parity):
            t0 = int(t0)
            lres = ds.full_lres_sequence(t0, nt)
            idx = lattice_index(out_shape, n_points, seed + len(out["t0"]))
            vals, vals64 = decode_points(cfg, params, batch_stats, lres,
                                         out_shape, idx)
            truth = ds.data[t0:t0 + nt].reshape(-1, ds.data.shape[-1])[idx]
            for k, v in (("lres", lres), ("index", idx), ("values", vals),
                         ("values_f64", vals64), ("truth", truth),
                         ("t0", t0), ("split", split)):
                out[k].append(v)
            rel = lambda v: np.linalg.norm(v * ds.channel_std
                                           + ds.channel_mean - truth) \
                / np.linalg.norm(truth)
            print(f"  {split} window t0={t0}: pointwise rel-L2 JAX f32 "
                  f"{rel(vals):.6f}, float64 {rel(vals64):.6f}", flush=True)
    out = {k: np.asarray(v) for k, v in out.items()}
    out["index"] = out["index"].astype(np.int32)
    out["truth"] = out["truth"].astype(np.float32)
    out.update(out_shape=np.asarray(out_shape), eval_data=np.asarray(files),
               channel_mean=np.asarray(channel_mean, np.float32),
               channel_std=np.asarray(channel_std, np.float32),
               seed=np.asarray(seed))
    return out


BF16_BLOCK_PTS = 64


def _lattice(out_shape) -> np.ndarray:
    axes = [np.linspace(0, 1, n, dtype=np.float32) for n in out_shape]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(
        -1, len(out_shape))


def windows_bf16_reference(cfg: Config, params, batch_stats,
                           windows_in: str):
    """The bf16 decode of the windows of ``windows_in`` (see the module
    docstring)."""
    with np.load(windows_in, allow_pickle=False) as z:
        ref = {k: z[k] for k in z.files}
    unet, imnet = build_models(cfg, ref["lres"].shape[1:4])
    uvars = {"params": params["unet"]}
    if batch_stats is not None:
        uvars["batch_stats"] = batch_stats
    encode = jax.jit(unet.apply)
    pts = _lattice(tuple(ref["out_shape"]))
    vals = []
    for w, (lres, idx) in enumerate(zip(ref["lres"], ref["index"])):
        latent = encode(uvars, jnp.asarray(lres)[None])
        vals.append(np.asarray(fused_query_local_implicit_grid(
            imnet, params["imnet"], latent, jnp.asarray(pts[idx])[None],
            compute_dtype=jnp.bfloat16, gather="kernel", pad_to=0,
            block_pts=BF16_BLOCK_PTS, interpret=True)[0], np.float32))
        scale = np.abs(ref["values_f64"][w]).max()
        print(f"  {ref['split'][w]} window t0={ref['t0'][w]}: JAX bf16 vs "
              f"float64 max |err| {np.abs(vals[-1] - ref['values_f64'][w]).max() / scale:.3e}"
              f" x max|ref| (f32 {np.abs(ref['values'][w] - ref['values_f64'][w]).max() / scale:.3e})",
              flush=True)
    return {"values_bf16": np.stack(vals), "t0": ref["t0"],
            "split": ref["split"], "block_pts": np.asarray(BF16_BLOCK_PTS),
            "windows_file": np.asarray(os.path.basename(windows_in))}


def _plain(tree):
    """A restored pytree as nested dicts (NamedTuples by field name) and
    lists."""
    if hasattr(tree, "_asdict"):
        return {k: _plain(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def _nodes(tree):
    """Every dict node of a ``_plain`` tree."""
    if isinstance(tree, dict):
        yield tree
        children = tree.values()
    elif isinstance(tree, list):
        children = tree
    else:
        return
    for c in children:
        yield from _nodes(c)


def optimizer_state(opt_state):
    """``bridge.save_exported``'s ``opt_state`` from a restored JAX
    ``opt_state``: ``apply_if_finite(...)``'s, or the legacy inner-only
    layout (then fresh counters). Raises unless there is exactly one
    Adam state and every schedule count equals Adam's."""
    tree = _plain(opt_state)
    adam = [n for n in _nodes(tree) if {"count", "mu", "nu"} <= set(n)]
    if len(adam) != 1:
        raise ValueError(f"expected one Adam state in opt_state, found "
                         f"{len(adam)}")
    count = int(np.asarray(adam[0]["count"]))
    sched = [int(np.asarray(n["count"])) for n in _nodes(tree)
             if set(n) == {"count"}]
    if any(c != count for c in sched):
        raise ValueError(f"Adam's count {count} and the schedule's "
                         f"{sched} disagree")
    wrapped = isinstance(tree, dict) and "notfinite_count" in tree
    counters = ({k: np.asarray(tree[k]) for k in
                 ("notfinite_count", "last_finite", "total_notfinite")}
                if wrapped else
                {"notfinite_count": np.asarray(0, np.int32),
                 "last_finite": np.asarray(True),
                 "total_notfinite": np.asarray(0, np.int32)})
    return dict(mu=jax.tree.map(np.asarray, adam[0]["mu"]),
                nu=jax.tree.map(np.asarray, adam[0]["nu"]),
                count=np.asarray(count, np.int64), **counters), \
        "apply_if_finite" if wrapped else "legacy"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt", required=True,
                        help="orbax checkpoint directory")
    parser.add_argument("--step", type=int, required=True)
    parser.add_argument("--out", required=True, help="output .npz")
    parser.add_argument("--no_write", action="store_true",
                        help="do not (re)write --out (it must exist when "
                             "--opt_out names it)")
    parser.add_argument("--with_opt_state", action="store_true",
                        help="put the optimizer state into --out")
    parser.add_argument("--opt_out", default="",
                        help="write the optimizer state to this file, "
                             "with --out as its params_file")
    parser.add_argument("--ref_points", type=int, default=4096,
                        help="JAX reference points (0 = no reference)")
    parser.add_argument("--tg_nt", type=int, default=32,
                        help="frames of the reference Taylor–Green data")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--windows_out", default="",
                        help="write the real-data windows reference here")
    parser.add_argument("--data_folder", default="data")
    parser.add_argument("--split_windows", type=int, default=4)
    parser.add_argument("--window_points", type=int, default=4096)
    parser.add_argument("--windows_in", default="",
                        help="the windows reference the bf16 decode reads")
    parser.add_argument("--windows_bf16_out", default="",
                        help="write the windows' JAX bf16 decode here")
    args = parser.parse_args(argv)

    state, extra = restore(args.ckpt, args.step)
    params = jax.tree.map(np.asarray, state.params)
    batch_stats = (jax.tree.map(np.asarray, state.batch_stats)
                   if state.batch_stats is not None else None)
    step = int(state.step)
    common = dict(config=extra["config"], channel_mean=extra["channel_mean"],
                  channel_std=extra["channel_std"], step=step,
                  meta={"epoch": int(extra.get("epoch", -1))})
    opt = layout = None
    if args.with_opt_state or args.opt_out:
        opt, layout = optimizer_state(state.opt_state)
    if not args.no_write:
        save_exported(args.out, params, batch_stats,
                      opt_state=opt if args.with_opt_state else None,
                      **common)
        n = sum(int(np.size(v)) for v in jax.tree.leaves(params))
        print(f"wrote {args.out}: step {step}, {n} parameters"
              + (f", optimizer state ({layout})" if args.with_opt_state
                 else ""))
    if args.opt_out:
        rel = os.path.relpath(os.path.abspath(args.out), os.path.dirname(
            os.path.abspath(args.opt_out)))
        save_exported(args.opt_out, None, None, opt_state=opt,
                      params_file=rel, **common)
        print(f"wrote {args.opt_out}: optimizer state ({layout}) at count "
              f"{int(opt['count'])}, params from {rel}")
    cfg = Config.from_dict(extra["config"])
    if args.ref_points:
        ref = reference(cfg, params, batch_stats, extra["channel_mean"],
                        extra["channel_std"], args.tg_nt, args.ref_points,
                        args.seed)
        path = os.path.splitext(args.out)[0] + "_ref.npz"
        np.savez_compressed(path, **ref)
        print(f"wrote {path}: {args.ref_points} JAX-CPU reference points")
    if args.windows_out:
        ref = windows_reference(cfg, params, batch_stats,
                                extra["channel_mean"], extra["channel_std"],
                                args.data_folder, args.split_windows,
                                args.window_points, args.seed)
        np.savez_compressed(args.windows_out, **ref)
        print(f"wrote {args.windows_out}: {len(ref['t0'])} windows x "
              f"{args.window_points} points "
              f"({os.path.getsize(args.windows_out) / 1e6:.2f} MB)")
    if args.windows_bf16_out:
        ref = windows_bf16_reference(cfg, params, batch_stats,
                                     args.windows_in or args.windows_out)
        np.savez_compressed(args.windows_bf16_out, **ref)
        print(f"wrote {args.windows_bf16_out}: {len(ref['t0'])} windows "
              f"({os.path.getsize(args.windows_bf16_out) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
