"""turb3d training CLI on the PyTorch / CUDA port: 3-D turbulence, 4-D
space-time super-resolution.

Counterpart of ``experiments/turb3d/train.py``: the same flags, data
(``Field4DDataset`` over comma-separated Beltrami realizations, with
the held-out-seed check), model (UNet4d encoder, ImNet(dim=4) decoder
on the 16-corner local implicit grid), ns3d PDE loss, schedule,
device batch assembly, ``--inner_steps``, cliff recovery and
checkpoints with resume, plus ``--device`` and ``--run_epochs N`` (stop
after N epochs of this run; the schedule still spans ``--epochs``, as in
the rb2d CLI). Each step's derivative jet
runs the hand-written CUDA jet kernels at D = 4
(``space_time_pde_torch/csrc/fused_jet.cu``, forward and backward) on a
card, their plain PyTorch twins on the CPU; the per-epoch eval decodes
through the CUDA decode kernel. Checkpoints are ``torch.save`` files
under ``<log_dir>/checkpoints``, written after every healthy epoch.

Example (on a machine with the card; the ``r5_turb3d_200x_big``
recipe, ``log/r5_turb3d_200x_big/command.sh``, on its 201 files):
    python experiments/turb3d/train_torch.py --data_folder data \
        --train_data beltrami_s42.npz,beltrami_s100.npz,... \
        --eval_data beltrami_s7.npz --nt 8 --nz 32 --ny 32 --nx 32 \
        --downsamp_t 2 --downsamp_xyz 4 --lat_dims 64 --unet_nf 32 \
        --imnet_nf 64 --n_samp_pts_per_crop 1024 --batch_size_per_gpu 4 \
        --inner_steps 8 --pseudo_epoch_size 2048 --alpha_pde 0.1 \
        --lr 5e-3 --lr_schedule cosine --pde_loss_type huber --epochs 150

``--resume`` takes a directory of the port's checkpoints or an ``.npz``
exported from a JAX run with its optimizer state
(``scripts/export_torch_turb3d.py --with_opt_state``): parameters, Adam
moments and counters carry over exactly, the batches do not (the JAX
PRNG key does not carry over).

Several ranks, as the rb2d CLI (``space_time_pde_torch/parallel/
layout.py``): under ``torchrun --nproc_per_node N`` the run is
data-parallel over N ranks; ``--space_devices S`` splits the 4-D latent
grid along x over S ranks (the data x space step), with
``--sharded_encoder`` the encoder too (``ShardedUNet4d``, halo convs).

``--use_bf16 true`` trains under the bf16 compute policy (the encoder
and ImNet in bf16 with f32 parameters, the jet f32, the epoch eval on
the decode kernel's bf16 instantiation); ``--pde_bf16 true`` with it
runs the jet in bf16 too (the bf16 jet kernels at D = 4), except under
``--space_devices`` (the sharded jet is f32, as in JAX). The provenance
line names the policy and the jet's dtype.

On a card a single-process run dispatches its ``--inner_steps`` steps as
one CUDA graph (``train/trainer.py::CapturedStep``): the first dispatch
runs eagerly, the second captures, every later one replays; eager on the
CPU and in launched worlds (the provenance line's ``step=``).

Not carried over: the ``maybe_force_platform`` call and the 16-corner
XLA:TPU compiler guard of the eval query (TPU workarounds).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

from space_time_pde_torch.data.dataset4d import Field4DDataset
from space_time_pde_torch.data.device_pipeline import DeviceSampler
from space_time_pde_torch.data.prefetch import BatchPrefetcher
from space_time_pde_torch.data.splits import check_train_files
from space_time_pde_torch.parallel.layout import Layout, step_text
from space_time_pde_torch.physics.systems import get_ns3d_pde_layer
from space_time_pde_torch.train import (
    CliffDetector, build_models, init_state, jet_compute_dtype, make_eval_fn,
    make_loss_fn, make_optimizer)
from space_time_pde_torch.utils.checkpoint import CheckpointManager, resume
from space_time_pde_torch.utils.config import Config
from space_time_pde_torch.utils.logging import MetricsLogger

TURB3D_ARGS = ("nt", "nz", "ny", "nx", "downsamp_t", "downsamp_xyz",
               "lat_dims", "unet_nf", "unet_mf", "imnet_nf", "viscosity")


def _bool(s):
    return s.lower() in ("1", "true", "yes")


def add_turb3d_args(parser: argparse.ArgumentParser) -> None:
    """The JAX driver's flags, same names and defaults, plus
    ``--device`` and ``--run_epochs`` (as the rb2d CLI's)."""
    p = parser.add_argument
    p("--data_folder", type=str, default="./data")
    p("--train_data", type=str, default="abc_flow.npz")
    p("--eval_data", type=str, default="abc_flow.npz")
    p("--allow_split_leak", action="store_true",
      help="downgrade the held-out-seed-in-training-list error to a "
           "warning")
    p("--nt", type=int, default=8)
    p("--nz", type=int, default=16)
    p("--ny", type=int, default=16)
    p("--nx", type=int, default=16)
    p("--downsamp_t", type=int, default=2)
    p("--downsamp_xyz", type=int, default=4)
    p("--n_samp_pts_per_crop", type=int, default=512)
    p("--lat_dims", type=int, default=16)
    p("--unet_nf", type=int, default=8)
    p("--unet_mf", type=int, default=256)
    p("--imnet_nf", type=int, default=16)
    p("--use_bf16", type=_bool, default=False, metavar="BOOL")
    p("--epochs", type=int, default=20)
    p("--batch_size_per_gpu", type=int, default=4)
    p("--lr", type=float, default=1e-2)
    p("--lr_schedule", type=str, default="constant")
    p("--alpha_pde", type=float, default=0.05)
    p("--reg_loss_type", type=str, default="l1")
    p("--clip_grad", type=float, default=1.0)
    p("--pseudo_epoch_size", type=int, default=512)
    p("--log_dir", type=str, default="./log/turb3d")
    p("--resume", type=str, default=None)
    p("--seed", type=int, default=42)
    p("--viscosity", type=float, default=1e-2)
    p("--inner_steps", type=int, default=1)
    p("--pde_derivs", type=str, default="jet",
      choices=("jet", "jet_jnp", "tower"))
    p("--pde_loss_type", type=str, default="l2", choices=("l2", "huber"))
    p("--pde_bf16", type=_bool, default=False, metavar="BOOL")
    p("--device_data", type=_bool, default=True, metavar="BOOL")
    p("--space_devices", type=int, default=1,
      help="ranks of the 'space' axis (4-D latent grid split along x, "
           "points binned, one-node halo); the others form 'data'")
    p("--sharded_encoder", action="store_true",
      help="with --space_devices > 1: the halo-conv ShardedUNet4d")
    p("--cliff_recovery", type=_bool, default=True, metavar="BOOL")
    p("--recovery_lr_factor", type=float, default=0.5)
    p("--device", type=str, default="cuda",
      help="torch device; 'cpu' runs the kernels' plain PyTorch twins "
           "(tests, tiny models)")
    p("--run_epochs", type=int, default=0,
      help="stop after N epochs of this run (0 = run to --epochs)")


def make_config(args) -> Config:
    """The turb3d flags on the shared Config, as the JAX driver maps
    them (checkpoint metadata and the generic trainer pieces)."""
    cfg = Config()
    m, t, d = cfg.model, cfg.train, cfg.data
    m.lat_dims, m.unet_nf, m.unet_mf = args.lat_dims, args.unet_nf, \
        args.unet_mf
    m.imnet_nf, m.use_bf16 = args.imnet_nf, args.use_bf16
    t.alpha_pde, t.reg_loss_type = args.alpha_pde, args.reg_loss_type
    t.clip_grad, t.lr, t.lr_schedule = args.clip_grad, args.lr, \
        args.lr_schedule
    t.epochs, t.pde_derivs = args.epochs, args.pde_derivs
    t.pde_loss_type, t.pde_bf16 = args.pde_loss_type, args.pde_bf16
    t.cliff_recovery = args.cliff_recovery
    t.recovery_lr_factor = args.recovery_lr_factor
    t.batch_size_per_gpu = args.batch_size_per_gpu
    t.pseudo_epoch_size, t.seed = args.pseudo_epoch_size, args.seed
    t.log_dir = args.log_dir
    cfg.physics.pde_system = "ns3d"
    cfg.physics.viscosity = args.viscosity
    d.data_folder, d.train_data = args.data_folder, args.train_data
    d.eval_data, d.nt, d.nz = args.eval_data, args.nt, args.nz
    d.downsamp_t = args.downsamp_t
    d.n_samp_pts_per_crop = args.n_samp_pts_per_crop
    return cfg


def _provenance(cfg, device, sampler, layout, step_kind, inner) -> str:
    alpha_pde, pde_derivs = cfg.train.alpha_pde, cfg.train.pde_derivs
    bf16 = cfg.model.use_bf16
    jet16 = (jet_compute_dtype(cfg) == torch.bfloat16
             and layout.n_space == 1)
    if alpha_pde <= 0:
        jet = "none (alpha_pde 0)"
    elif pde_derivs == "jet":
        jet = ((f"jet_fwd{'_bf16' * jet16} + jet_bwd{'_bf16' * jet16} at "
                f"D=4 (csrc/fused_jet{'_bf16' * jet16}.cu)")
               if device.type == "cuda" else "jet_fwd_plain (CPU twin)")
    else:
        jet = f"{pde_derivs} (plain PyTorch)"
    decode = ("decode_blend_gather" + ("_bf16" if bf16 else "")
              + f" at D=4 (csrc/fused_query{'_bf16' * bf16}.cu)"
              if device.type == "cuda" else "plain PyTorch")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    policy = f"bf16 (jet {'bf16' if jet16 else 'f32'})" if bf16 else "f32"
    return (f"train provenance: device={device} ({name}) "
            f"policy={policy} "
            f"tf32_matmul={torch.backends.cuda.matmul.allow_tf32} "
            f"tf32_cudnn={torch.backends.cudnn.allow_tf32} "
            f"cudnn_in_step=False jet={jet} eval_decode={decode} "
            f"batch_assembly={'device' if sampler is not None else 'host'} "
            f"step={step_text(step_kind, inner)} "
            f"{layout.describe()}")


def main(argv=None):
    """Train; returns ``{"epochs": [per-epoch metrics], "start_epoch",
    "step", "provenance", "state"}`` (the final ``TrainState``)."""
    parser = argparse.ArgumentParser(description=__doc__)
    add_turb3d_args(parser)
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("no CUDA device here; --device cpu runs the plain "
                         "PyTorch path")
    layout = Layout(args.space_devices, args.sharded_encoder, False,
                    args.device)
    device = layout.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = make_config(args)

    def make_ds(fname):
        return Field4DDataset(
            data_folder=args.data_folder, data_filename=fname,
            nt=args.nt, nz=args.nz, ny=args.ny, nx=args.nx,
            n_samp_pts_per_crop=args.n_samp_pts_per_crop,
            downsamp_t=args.downsamp_t, downsamp_xyz=args.downsamp_xyz)

    check_train_files(args.train_data, eval_data=args.eval_data,
                      allow_leak=args.allow_split_leak or None)
    ds = make_ds(args.train_data)
    eval_ds = make_ds(args.eval_data)
    eval_ds.channel_mean = ds.channel_mean
    eval_ds.channel_std = ds.channel_std

    unet, imnet = build_models(cfg, ds.lres_shape, device)
    et, ez, ey, ex = ds.coord_extents
    pde_layer = get_ns3d_pde_layer(
        mean=ds.channel_mean, std=ds.channel_std, t_crop=et, z_crop=ez,
        y_crop=ey, x_crop=ex, viscosity=args.viscosity,
    ) if args.alpha_pde > 0 else None

    per_rank = args.batch_size_per_gpu
    batch_per_step = layout.global_rows(per_rank)
    steps_per_epoch = max(1, args.pseudo_epoch_size // batch_per_step)
    inner = max(1, args.inner_steps)
    opt = make_optimizer(cfg, steps_per_epoch)
    state = init_state(args.seed, unet, imnet, opt)
    layout.prepare(unet, cfg.model.norm)
    loss_fn = make_loss_fn(cfg, unet, imnet, pde_layer)
    sampler = None
    if args.device_data and layout.n_space == 1 and \
            DeviceSampler.supported(ds):
        sampler = DeviceSampler(ds, device)
        loss_fn = sampler.wrap_loss(loss_fn)

    step_kind = layout.step_kind()

    def build_step(opt):
        # Captured: a new graph (the next dispatch warms up and captures).
        return layout.make_step(cfg, imnet, pde_layer, loss_fn, opt, inner)

    step_fn = build_step(opt)
    # The eval runs the plain module (the same parameters either way).
    eval_fn = make_eval_fn(cfg, unet, imnet)
    provenance = _provenance(cfg, device, sampler, layout, step_kind,
                             inner)
    if layout.is_main:
        print(provenance, flush=True)

    ckpt_dir = os.path.join(args.log_dir, "checkpoints")
    mngr = CheckpointManager(ckpt_dir, keep=3)
    start_epoch = 0
    if args.resume:
        state, start_epoch, line = resume(state, args.resume, mngr,
                                          steps_per_epoch)
        if layout.is_main:
            print(line, flush=True)
    state = layout.replicate(state)

    logger = (MetricsLogger(args.log_dir, use_tensorboard=False)
              if layout.is_main else None)
    rng = np.random.RandomState(args.seed)
    eval_rng = np.random.RandomState(args.seed + 1)
    eval_batch_host = eval_ds.sample_batch(eval_rng, batch_per_step)

    def upload(host):
        return {k: torch.as_tensor(v, device=device)
                for k, v in host.items()}

    eval_batch = upload(eval_batch_host)

    def one_batch(rows):
        if sampler is not None:
            o, p = sampler.draw(rng, rows)
            return {"origins": o, "point_coord": p}
        return ds.sample_batch(rng, rows)

    def make_raw():
        return layout.draw(one_batch, per_rank, inner, ds.lres_shape[-1])

    prefetcher = BatchPrefetcher(make_raw, depth=4)

    best_eval = float("inf")
    lr_scale = 1.0
    cliff = CliffDetector() if args.cliff_recovery else None
    history = []
    try:
        last = args.epochs
        if args.run_epochs > 0:
            last = min(last, start_epoch + args.run_epochs)
        for epoch in range(start_epoch, last):
            t0 = time.time()
            for _ in range(max(1, steps_per_epoch // inner)):
                state, metrics = step_fn(state, upload(prefetcher.get()))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            metrics = {k: float(v) for k, v in metrics.items()}
            recover_reason = None
            epoch_healthy = all(np.isfinite(v) for v in metrics.values())
            if not epoch_healthy:
                bad = sorted(k for k, v in metrics.items()
                             if not np.isfinite(v))
                if all(bool(torch.isfinite(p).all())
                       for p in state.params().values()):
                    if sampler is not None:
                        sampler.refresh()
                    eval_batch = upload(eval_batch_host)
                    if layout.is_main:
                        print(f"epoch {epoch}: non-finite {bad} — "
                              "update(s) skipped, params healthy, "
                              "continuing", flush=True)
                else:
                    recover_reason = f"non-finite params ({bad})"
            if recover_reason is None and cliff is not None:
                recover_reason = cliff.update(metrics)
            if recover_reason is not None:
                if cliff is None or mngr.latest_step() is None:
                    raise SystemExit(
                        f"{recover_reason} at epoch {epoch} and no healthy "
                        "checkpoint to restore — lower --lr / --alpha_pde")
                lr_scale *= cfg.train.recovery_lr_factor
                opt = make_optimizer(cfg, steps_per_epoch, lr_scale=lr_scale)
                step_fn = build_step(opt)
                layout.barrier()
                state, _ = mngr.restore(state)
                cliff.reset()
                if layout.is_main:
                    print(f"epoch {epoch}: CLIFF RECOVERY — "
                          f"{recover_reason}; restored step {state.step}, "
                          f"continuing with lr x{lr_scale:g}", flush=True)
                continue
            sec_per_step = (time.time() - t0) / steps_per_epoch
            metrics["sec_per_step"] = sec_per_step
            metrics["pts_per_sec"] = (batch_per_step *
                                      args.n_samp_pts_per_crop /
                                      sec_per_step)
            em = {}
            if layout.is_main:
                logger.log(state.step, metrics, prefix="train/")
                em = {k: float(v) for k, v in eval_fn(eval_batch).items()
                      if v.ndim == 0}
                logger.log(state.step, em, prefix="eval/")
                print(f"epoch {epoch}: loss={metrics.get('loss', 0):.5f} "
                      f"reg={metrics.get('reg_loss', 0):.5f} "
                      f"pde={metrics.get('pde_loss', 0):.5f} "
                      f"eval_rel_l2={em.get('rel_l2', 0):.5f} "
                      f"({sec_per_step:.3f}s/step)", flush=True)
            history.append(dict(metrics, epoch=epoch, step=state.step,
                                **{f"eval/{k}": v for k, v in em.items()}))
            best_eval = min(best_eval, em.get("rel_l2", 1e9))
            # Never checkpoint an unhealthy epoch: cliff recovery restores
            # the latest checkpoint.
            if layout.is_main and epoch_healthy:
                mngr.save(state.step, state, extra={
                    "config": cfg.to_dict(),
                    "turb3d_args": {k: getattr(args, k)
                                    for k in TURB3D_ARGS},
                    "epoch": epoch,
                    "channel_mean": np.asarray(ds.channel_mean),
                    "channel_std": np.asarray(ds.channel_std),
                    "coord_extents": np.asarray(ds.coord_extents),
                    "best_eval": float(best_eval),
                })
            layout.barrier()        # rank 0's checkpoint, seen by all
    finally:
        prefetcher.close()
        if logger is not None:
            logger.close()
    return {"epochs": history, "start_epoch": start_epoch,
            "step": state.step, "provenance": provenance, "state": state}


if __name__ == "__main__":
    main()
