"""RB2D training CLI on the PyTorch / CUDA port.

Counterpart of ``experiments/rb2d/train.py``: the same data, model,
loss, schedule and checkpoint flags, the same per-epoch line, the same
non-finite and cliff-recovery handling, and per-epoch eval on a fixed
val batch (through the CUDA decode kernel on a card). Each step's
derivative jet runs the hand-written CUDA jet kernels
(``space_time_pde_torch/csrc/fused_jet.cu``: forward, and backward in
the gradient) on a card, their plain PyTorch twins on the CPU.
Checkpoints are ``torch.save`` files under ``<log_dir>/checkpoints``.

Example (on a machine with the card; the rb2d flagship's flags):
    python experiments/rb2d/train_torch.py --data_folder data \
        --train_data rb2d_ra1e6_s42.npz --val_data rb2d_ra1e6_s7.npz \
        --nt 16 --nz 128 --nx 128 --downsamp_t 4 --downsamp_xz 8 \
        --lat_dims 64 --unet_nf 32 --imnet_nf 64 \
        --n_samp_pts_per_crop 1024 --batch_size_per_gpu 8 \
        --inner_steps 8 --alpha_pde 0.1 --lr 5e-3 --lr_schedule cosine \
        --pde_loss_type huber --epochs 900 --log_dir log/rb2d_torch

``--resume`` takes a directory of the port's checkpoints or an ``.npz``
exported from a JAX run with its optimizer state
(``scripts/export_torch_params.py --with_opt_state``): the run continues
from the JAX step with the same parameters, BatchNorm statistics, Adam
moments and counters, but not the same batches (the JAX PRNG key does
not carry over). Pass a longer ``--epochs`` than the JAX run's when its
cosine schedule ended at the checkpoint. ``--run_epochs N`` stops after
N epochs of this run (the schedule still spans ``--epochs``).

``--use_bf16 true`` trains under the bf16 compute policy (the encoder
and ImNet in bf16 with f32 parameters, the jet f32, the epoch eval on
the decode kernel's bf16 instantiation); ``--pde_bf16 true`` with it
runs the jet in bf16 too (the bf16 jet kernels), as the JAX trainer
does, except under ``--space_devices``, whose sharded jet is f32 in
both packages. The provenance line names the policy and the jet's
dtype.

``--profile_epoch N`` writes a ``torch.profiler`` trace of epoch N to
``<log_dir>/profile/`` (Chrome trace JSON). In a single-process run it
also turns the port's spans on (``space_time_pde_torch/utils/tracing.py``)
before the first dispatch, so the graph a card captures holds their CUDA
events and the trace of a dispatch that runs host code (on the CPU, or
epoch 0's warm-up and capture) their ranges; after epoch N it prints
each span's device ms a step, from the epoch's last dispatch, and logs
them as ``profile/<span>_ms``. ``--debug_nans`` checks the loss terms
and the gradients of every step and raises ``FloatingPointError``
naming the first non-finite one.

On a card a single-process run dispatches its ``--inner_steps`` steps as
one CUDA graph (``train/trainer.py::CapturedStep``, the counterpart of
the JAX driver's jitted ``lax.scan``): the first dispatch runs eagerly,
the second captures, every later one replays. The step stays eager on
the CPU, under ``--debug_nans`` and in launched worlds; the provenance
line's ``step=`` says which.

Several ranks (``space_time_pde_torch/parallel/layout.py``): under
``torchrun --nproc_per_node N`` the run is data-parallel over N ranks
(``batch_size_per_gpu`` crops each, gradients averaged);
``--space_devices S`` splits every crop's latent grid along x over S
ranks (the data x space step, N / S data ranks), with ``--sharded_encoder``
the encoder too (halo convs); ``--multihost`` joins a run of one process
per host through ``STPDE_COORDINATOR`` / ``STPDE_NUM_PROCESSES`` /
``STPDE_PROCESS_ID`` (data axis only). The backend is NCCL when every
rank has a card of its own, gloo when ranks share a card:
    torchrun --nproc_per_node 4 experiments/rb2d/train_torch.py \
        <the flags above> --space_devices 2 --sharded_encoder
"""

import argparse
import contextlib
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

from space_time_pde_torch.data.dataset import RB2DataLoader
from space_time_pde_torch.data.device_pipeline import DeviceSampler
from space_time_pde_torch.data.prefetch import BatchPrefetcher
from space_time_pde_torch.data.splits import check_train_files
from space_time_pde_torch.parallel.layout import Layout, step_text
from space_time_pde_torch.physics.systems import (
    available_systems, get_pde_layer)
from space_time_pde_torch.train import (
    CliffDetector, build_models, init_state, jet_compute_dtype, make_eval_fn,
    make_loss_fn, make_optimizer)
from space_time_pde_torch.utils import tracing
from space_time_pde_torch.utils.checkpoint import CheckpointManager, resume
from space_time_pde_torch.utils.config import add_args, config_from_args
from space_time_pde_torch.utils.logging import MetricsLogger


def _loader(cfg, filename):
    d = cfg.data
    return RB2DataLoader(
        data_folder=d.data_folder, data_filename=filename, nt=d.nt,
        nz=d.nz, nx=d.nx, n_samp_pts_per_crop=d.n_samp_pts_per_crop,
        downsamp_t=d.downsamp_t, downsamp_xz=d.downsamp_xz,
        normalize_output=d.normalize_channels, lres_filter=d.lres_filter,
        lres_interp=d.lres_interp, velonly=d.velonly)


def _provenance(cfg, device, sampler, layout, step_kind, inner) -> str:
    derivs = cfg.train.pde_derivs
    jet16 = (jet_compute_dtype(cfg) == torch.bfloat16
             and layout.n_space == 1)
    if cfg.train.alpha_pde <= 0:
        jet = "none (alpha_pde 0)"
    elif derivs == "jet" and cfg.model.fused_query:
        jet = (("jet_fwd_bf16 + jet_bwd_bf16 (csrc/fused_jet_bf16.cu)"
                if jet16 else "jet_fwd + jet_bwd (csrc/fused_jet.cu)")
               if device.type == "cuda" else "jet_fwd_plain (CPU twin)")
    else:
        jet = f"{derivs} (plain PyTorch)"
    bf16 = cfg.model.use_bf16
    decode = ("decode_blend_gather" + ("_bf16" if bf16 else "")
              + f" (csrc/fused_query{'_bf16' * bf16}.cu)"
              if cfg.model.fused_query and device.type == "cuda"
              else "plain PyTorch")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    policy = f"bf16 (jet {'bf16' if jet16 else 'f32'})" if bf16 else "f32"
    return (f"train provenance: device={device} ({name}) "
            f"policy={policy} "
            f"tf32_matmul={torch.backends.cuda.matmul.allow_tf32} "
            f"tf32_cudnn={torch.backends.cudnn.allow_tf32} jet={jet} "
            f"eval_decode={decode} batch_assembly="
            f"{'device' if sampler is not None else 'host'} "
            f"step={step_text(step_kind, inner)} {layout.describe()}")


@contextlib.contextmanager
def profiled(on: bool, device, out_dir: str, name: str):
    """A ``torch.profiler`` trace of the block (host, and the card's
    kernels on a CUDA device), written to ``out_dir/<name>.json``."""
    if not on:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    print(f"wrote a torch.profiler trace of {name} to {path}", flush=True)


def main(argv=None):
    """Train; returns ``{"epochs": [per-epoch metrics], "start_epoch",
    "step", "provenance", "state"}`` (``state``: the final
    ``TrainState``)."""
    parser = argparse.ArgumentParser(description=__doc__)
    add_args(parser)
    parser.add_argument("--inner_steps", type=int, default=1,
                        help="optimizer steps per prefetched batch group")
    parser.add_argument("--val_data", type=str, default="",
                        help="validation-split npz (overrides --eval_data)")
    parser.add_argument("--allow_split_leak", action="store_true",
                        help="downgrade the held-out-seed-in-training-list "
                             "error to a warning")
    parser.add_argument(
        "--device_data", type=lambda s: s.lower() in ("1", "true", "yes"),
        default=True, metavar="BOOL",
        help="assemble batches on the device (field uploaded once; the "
             "host draws origins + points); off for filtered low-res")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain "
                             "PyTorch twins (tests, tiny models)")
    parser.add_argument("--run_epochs", type=int, default=0,
                        help="stop after N epochs of this run (0 = run to "
                             "--epochs)")
    parser.add_argument("--profile_epoch", type=int, default=-1,
                        help="epoch to write a torch.profiler trace of, "
                             "under <log_dir>/profile, and to print and "
                             "log the spans' device ms a step of")
    parser.add_argument("--debug_nans", action="store_true",
                        help="check every step's loss terms and gradients; "
                             "raise naming the first non-finite one")
    parser.add_argument("--space_devices", type=int, default=1,
                        help="ranks of the 'space' axis (latent grid split "
                             "along x, points binned, one-node halo); the "
                             "other ranks form the 'data' axis")
    parser.add_argument("--sharded_encoder", action="store_true",
                        help="with --space_devices > 1: the halo-conv "
                             "ShardedUNet3d (no rank holds a whole grid)")
    parser.add_argument("--multihost", action="store_true",
                        help="join a run of one process per host "
                             "(STPDE_COORDINATOR / STPDE_NUM_PROCESSES / "
                             "STPDE_PROCESS_ID); data axis only")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    if args.val_data:
        cfg.data.eval_data = args.val_data
    if cfg.train.alpha_pde > 0 and \
            cfg.physics.pde_system not in available_systems():
        raise SystemExit(
            f"unknown --pde_system {cfg.physics.pde_system!r}; "
            f"available: {available_systems()}")
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("no CUDA device here; --device cpu runs the plain "
                         "PyTorch path")
    layout = Layout(args.space_devices, args.sharded_encoder,
                    args.multihost, args.device, cfg.train.num_devices)
    device = layout.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg.data.velonly:
        cfg.model.out_channels = 2
        if cfg.train.alpha_pde > 0:
            raise SystemExit(
                "--velonly predicts (u, w) only; the PDE residuals need "
                "all 4 fields — set --alpha_pde 0")

    check_train_files(cfg.data.train_data, eval_data=cfg.data.eval_data,
                      allow_leak=args.allow_split_leak or None)
    ds = _loader(cfg, cfg.data.train_data)
    eval_ds = _loader(cfg, cfg.data.eval_data)
    eval_ds.channel_mean = ds.channel_mean
    eval_ds.channel_std = ds.channel_std

    unet, imnet = build_models(cfg, ds.lres_shape, device)
    et, ez, ex = ds.coord_extents
    pde_layer = get_pde_layer(
        cfg.physics.pde_system, mean=ds.channel_mean, std=ds.channel_std,
        t_crop=et, z_crop=ez, x_crop=ex, rayleigh=cfg.physics.rayleigh,
        prandtl=cfg.physics.prandtl, viscosity=cfg.physics.viscosity,
    ) if cfg.train.alpha_pde > 0 else None

    per_rank = cfg.train.batch_size_per_gpu
    batch_per_step = layout.global_rows(per_rank)
    steps_per_epoch = max(1, cfg.train.pseudo_epoch_size // batch_per_step)
    inner = max(1, args.inner_steps)
    opt = make_optimizer(cfg, steps_per_epoch)
    state = init_state(cfg.train.seed, unet, imnet, opt)
    layout.prepare(unet, cfg.model.norm)
    loss_fn = make_loss_fn(cfg, unet, imnet, pde_layer)
    sampler = None
    if args.device_data and layout.n_space == 1 and \
            DeviceSampler.supported(ds):
        sampler = DeviceSampler(ds, device)
        loss_fn = sampler.wrap_loss(loss_fn)

    step_kind = layout.step_kind(args.debug_nans)

    def build_step(opt):
        # Captured: a new graph (the next dispatch warms up and captures).
        return layout.make_step(cfg, imnet, pde_layer, loss_fn, opt, inner,
                                args.debug_nans)

    step_fn = build_step(opt)
    # The eval runs the plain module (the same parameters either way).
    eval_fn = make_eval_fn(cfg, unet, imnet)
    provenance = _provenance(cfg, device, sampler, layout, step_kind,
                             inner)
    if layout.is_main:
        print(provenance, flush=True)

    ckpt_dir = os.path.join(cfg.train.log_dir, "checkpoints")
    mngr = CheckpointManager(ckpt_dir, keep=cfg.train.keep_checkpoints)
    start_epoch = 0
    if cfg.train.resume:
        state, start_epoch, line = resume(state, cfg.train.resume, mngr,
                                          steps_per_epoch)
        if layout.is_main:
            print(line, flush=True)
    state = layout.replicate(state)

    logger = (MetricsLogger(cfg.train.log_dir, use_tensorboard=False)
              if layout.is_main else None)
    # --multihost: each process its own rows (the JAX driver's seeds);
    # otherwise every rank draws the global batch and keeps its block.
    rng = np.random.RandomState(cfg.train.seed + (
        1000 * layout.rank if layout.multihost else 0))
    eval_rng = np.random.RandomState(cfg.train.seed + 1)
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
        return layout.draw(one_batch, per_rank, inner, ds.lres_shape[2])

    prefetcher = BatchPrefetcher(make_raw, depth=4)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    best_eval = float("inf")
    lr_scale = 1.0
    cliff = CliffDetector() if cfg.train.cliff_recovery else None
    history = []
    if args.profile_epoch >= start_epoch and not layout.launched:
        tracing.enable()
    try:
        last = cfg.train.epochs
        if args.run_epochs > 0:
            last = min(last, start_epoch + args.run_epochs)
        for epoch in range(start_epoch, last):
            t0 = time.time()
            with profiled(epoch == args.profile_epoch and layout.is_main,
                          device,
                          os.path.join(cfg.train.log_dir, "profile"),
                          f"epoch_{epoch}"):
                for _ in range(max(1, steps_per_epoch // inner)):
                    state, metrics = step_fn(state,
                                             upload(prefetcher.get()))
                sync()
            if epoch == args.profile_epoch and tracing.enabled():
                tracing.disable()
                spans = tracing.device_ms()
                steps = spans.get("step", (0.0, 1))[1]
                per_step = {k: v / steps for k, (v, _) in spans.items()}
                if layout.is_main:
                    logger.log(state.step, {f"{k}_ms": v for k, v in
                                            per_step.items()},
                               prefix="profile/")
                    print(f"epoch {epoch}: device ms a step: " + " ".join(
                        f"{k}={v:.3f}" for k, v in per_step.items()),
                        flush=True)
            metrics = {k: float(v) for k, v in metrics.items()}
            recover_reason = None
            epoch_healthy = all(np.isfinite(v) for v in metrics.values())
            if not epoch_healthy:
                bad = sorted(k for k, v in metrics.items()
                             if not np.isfinite(v))
                params_ok = all(bool(torch.isfinite(p).all())
                                for p in state.params().values())
                if params_ok:
                    # A skipped update (apply_if_finite) or a corrupted
                    # device buffer: re-upload the field and eval batch.
                    if sampler is not None:
                        sampler.refresh()
                    eval_batch = upload(eval_batch_host)
                    if layout.is_main:
                        print(f"epoch {epoch}: non-finite {bad} — "
                              "update(s) skipped (apply_if_finite), params "
                              "healthy; device buffers re-uploaded, "
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
                                      cfg.data.n_samp_pts_per_crop /
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
            # Never checkpoint an unhealthy epoch: cliff recovery restores
            # the latest checkpoint.
            if layout.is_main and epoch_healthy and (
                    (epoch + 1) % cfg.train.ckpt_every_epochs == 0 or
                    em.get("rel_l2", 1e9) < best_eval):
                best_eval = min(best_eval, em.get("rel_l2", 1e9))
                mngr.save(state.step, state, extra={
                    "config": cfg.to_dict(),
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
