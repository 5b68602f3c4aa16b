"""RB2D evaluation CLI on the PyTorch / CUDA port.

Counterpart of ``experiments/rb2d/evaluation.py``: load exported
weights, encode each eval window's low-res input once, decode the dense
high-res space-time lattice through the port's fused CUDA kernel, and
report per-window rel-L2 against the ground truth, with the same
provenance and ``rel_l2`` lines as the JAX CLI.

``--params`` takes the ``.npz`` written by
``scripts/export_torch_params.py`` (the flagship's is committed at
``space_time_pde_torch/assets/r5_rb2d_4x_e900_230400.npz``) in place of
``--ckpt``: orbax checkpoints need JAX to read.

Example (on a machine with the card):
    python experiments/rb2d/evaluation_torch.py \
        --params space_time_pde_torch/assets/r5_rb2d_4x_e900_230400.npz \
        --data_folder ./data --split test --save_path ./log/pred.npz

Not carried over: ``--fetch_dtype`` and ``--matmul_precision`` (TPU
and remote-tunnel knobs; here TF32 is off and printed), ``--decode_dtype``
(the kernel is f32 only), rendering and animation.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

from space_time_pde_torch.bridge import load_exported, load_flax_params
from space_time_pde_torch.data import RB2EvalData
from space_time_pde_torch.data.splits import SplitSpec, window_starts
from space_time_pde_torch.inference import (
    fit_dense_decoder, igres_mismatch_note, make_dense_decoder,
    stitched_decode)
from space_time_pde_torch.models import ImNet, UNet3d
from space_time_pde_torch.utils.config import Config, add_args


def build_models(cfg: Config, igres, exported, device):
    """UNet3d at ``igres`` + ImNet from the config, weights from the
    exported params, in eval mode on ``device``."""
    m = cfg.model
    if m.use_bf16:
        raise NotImplementedError(
            "checkpoint trained with use_bf16: the port's decode kernels "
            "are f32 only")
    unet = UNet3d(in_features=m.in_channels, out_features=m.lat_dims,
                  igres=tuple(igres), nf=m.unet_nf, mf=m.unet_mf,
                  negative_slope=m.negative_slope, activation=m.activation,
                  norm=m.norm)
    imnet = ImNet(dim=3, in_features=m.lat_dims, out_features=m.out_channels,
                  nf=m.imnet_nf, activation=m.activation,
                  negative_slope=m.negative_slope)
    params = exported["params"]
    load_flax_params(unet, params["unet"], exported["batch_stats"])
    load_flax_params(imnet, params["imnet"])
    return unet.to(device).eval(), imnet.to(device).eval()


def _rel(pred, gt):
    return float(np.linalg.norm(pred - gt) / (np.linalg.norm(gt) + 1e-12))


def main(argv=None):
    """Run the eval; returns a dict of what it measured (also printed):
    ``rel_l2`` per window, ``t0s``, ``decode_seconds`` per window,
    ``points_per_window``, ``provenance``, the first window's low-res
    input ``lres0`` and decoder output ``window0`` (normalised units, on
    the device) and the ``models``."""
    parser = argparse.ArgumentParser(description=__doc__)
    add_args(parser)
    parser.add_argument("--params", type=str, required=True,
                        help="exported weights .npz "
                             "(scripts/export_torch_params.py)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain "
                             "PyTorch twins (tests, tiny models)")
    parser.add_argument("--eval_t0", type=int, default=0)
    parser.add_argument("--eval_nt", type=int, default=0,
                        help="frames in the eval window (0 = --nt)")
    parser.add_argument("--save_path", type=str, default="eval_pred.npz")
    parser.add_argument("--query_chunk", type=int, default=65536)
    parser.add_argument("--eval_windows", type=int, default=1)
    parser.add_argument("--full_sequence", action="store_true")
    parser.add_argument("--stitch_stride", type=int, default=0,
                        help="window stride for --full_sequence; 0 = nt/2")
    parser.add_argument("--split", choices=["custom", "val", "test"],
                        default="custom")
    args = parser.parse_args(argv)
    # Flags typed on the command line (a re-parse with every default
    # suppressed keeps only those).
    for action in parser._actions:
        action.default = argparse.SUPPRESS
    explicit = set(vars(parser.parse_known_args(argv)[0]))

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device here; --device cpu runs the plain "
                         "PyTorch path")
    exported = load_exported(args.params)
    cfg = Config.from_dict(exported["config"])
    step = exported["step"]
    train_igres = (cfg.data.nt // cfg.data.downsamp_t,
                   cfg.data.nz // cfg.data.downsamp_xz,
                   cfg.data.nx // cfg.data.downsamp_xz)
    for flag in ("data_folder", "eval_data", "nt", "nz", "nx",
                 "downsamp_t", "downsamp_xz", "lres_filter", "lres_interp"):
        if flag in explicit:
            setattr(cfg.data, flag, getattr(args, flag))
    if args.split != "custom" and "eval_data" not in explicit:
        cfg.data.eval_data = getattr(SplitSpec.canonical(),
                                     f"{args.split}_data")
        print(f"split={args.split}: evaluating {cfg.data.eval_data}")

    ds = RB2EvalData(
        data_folder=cfg.data.data_folder, data_filename=cfg.data.eval_data,
        nt=cfg.data.nt, nz=cfg.data.nz, nx=cfg.data.nx,
        downsamp_t=cfg.data.downsamp_t, downsamp_xz=cfg.data.downsamp_xz,
        normalize_output=cfg.data.normalize_channels,
        lres_filter=cfg.data.lres_filter, lres_interp=cfg.data.lres_interp)
    ds.channel_mean = np.asarray(exported["channel_mean"], np.float32)
    ds.channel_std = np.asarray(exported["channel_std"], np.float32)

    eval_nt = args.eval_nt or cfg.data.nt
    lres0 = ds.full_lres_sequence(args.eval_t0, eval_nt)
    note = igres_mismatch_note(lres0.shape[:3], train_igres,
                               homogeneous_axes=(2,))
    if note:
        print(note, flush=True)
    unet, imnet = build_models(cfg, lres0.shape[:3], exported, device)
    print(f"restored step {step}; lres {lres0.shape}")

    T_total, Z_hi, X_hi = ds.data.shape[:3]
    if args.split != "custom":
        n_windows = args.eval_windows if "eval_windows" in explicit else 4
        t0s = window_starts(T_total, eval_nt, n_windows,
                            parity=int(args.split == "test"))
    else:
        t0s = np.unique(np.linspace(args.eval_t0, T_total - eval_nt,
                                    max(1, args.eval_windows)).astype(int))
    t0s = [int(t) for t in t0s]

    probe_t0 = 0 if args.full_sequence else t0s[0]
    probe_lres = ds.full_lres_sequence(probe_t0, eval_nt)
    tp0 = time.perf_counter()
    decoder, probe_out = fit_dense_decoder(
        lambda c: make_dense_decoder(unet, imnet, (eval_nt, Z_hi, X_hi),
                                     chunk=c),
        probe_lres, chunk=args.query_chunk)
    t_probe = time.perf_counter() - tp0
    prov = decoder.provenance
    print(f"decode provenance: backend={prov['backend']} "
          f"device={prov['device']} kernel={prov['kernel']} "
          f"dtype={prov['compute_dtype']} "
          f"tf32_matmul={prov['tf32_matmul']} "
          f"tf32_cudnn={prov['tf32_cudnn']} "
          f"chunk={prov['chunk']} block_pts={prov['block_pts']} "
          f"eval_data={cfg.data.eval_data} step={step} "
          f"windows={'full_sequence' if args.full_sequence else t0s}",
          flush=True)
    n_q = eval_nt * Z_hi * X_hi
    results = {"provenance": prov, "points_per_window": n_q,
               "models": (unet, imnet), "t0s": t0s, "lres0": probe_lres}

    if args.full_sequence:
        stride = args.stitch_stride or max(1, eval_nt // 2)
        tq0 = time.perf_counter()
        pred, starts = stitched_decode(
            decoder, lambda t0: ds.full_lres_sequence(t0, eval_nt),
            T_total, eval_nt, stride, (Z_hi, X_hi),
            channel_mean=ds.channel_mean, channel_std=ds.channel_std)
        tq = time.perf_counter() - tq0
        gt = ds.data
        print(f"stitched {len(starts)} windows (stride {stride}) over "
              f"{T_total} frames: {len(starts) * n_q} pts in {tq:.2f}s = "
              f"{len(starts) * n_q / tq / 1e6:.2f}M pts/s", flush=True)
        rel_l2 = _rel(pred, gt)
        per_ch = np.asarray([_rel(pred[..., c], gt[..., c])
                             for c in range(4)])
        print(f"full-sequence rel_l2 = {rel_l2:.5f}  per-channel "
              f"(p,b,u,w) = " + " ".join(f"{v:.5f}" for v in per_ch))
        results.update(rel_l2=[rel_l2], window0=probe_out,
                       decode_seconds=[tq])
    else:
        all_rel, all_per_ch, secs = [], [], []
        pred = gt = None
        for wi, t0 in enumerate(t0s):
            if wi == 0:
                out, dt = probe_out, t_probe
            else:
                lres = ds.full_lres_sequence(t0, eval_nt)
                td0 = time.perf_counter()
                out = decoder(lres)
                if out.is_cuda:
                    torch.cuda.synchronize(out.device)
                dt = time.perf_counter() - td0
            secs.append(dt)
            pred_w = out.cpu().numpy() * ds.channel_std + ds.channel_mean
            gt_w = ds.data[t0:t0 + eval_nt]
            all_rel.append(_rel(pred_w, gt_w))
            all_per_ch.append([_rel(pred_w[..., c], gt_w[..., c])
                               for c in range(4)])
            if wi == 0:
                pred, gt = pred_w, gt_w
                results["window0"] = out
            print(f"  window t0={t0}: encode+decode {dt:.3f}s"
                  + (" (incl. kernel build)" if wi == 0 else ""), flush=True)
            print(f"window t0={t0}: rel_l2 = {all_rel[-1]:.5f}", flush=True)
        if len(t0s) > 1:
            steady = n_q * (len(t0s) - 1) / sum(secs[1:])
            print(f"  decode rate: {steady / 1e6:.3f}M pts/s over windows "
                  f"2..{len(t0s)} on {prov['device']} (window 1 "
                  f"{secs[0]:.2f}s incl. build)", flush=True)
            results["steady_pts_per_s"] = steady
        rel_l2 = float(np.mean(all_rel))
        per_ch = np.mean(np.asarray(all_per_ch), axis=0)
        print(f"rel_l2 = {rel_l2:.5f} (std {np.std(all_rel):.5f} over "
              f"{len(t0s)} windows)  per-channel (p,b,u,w) = "
              + " ".join(f"{v:.5f}" for v in per_ch))
        results.update(rel_l2=all_rel, decode_seconds=secs)

    os.makedirs(os.path.dirname(os.path.abspath(args.save_path)),
                exist_ok=True)
    np.savez_compressed(
        args.save_path,
        p=pred[..., 0], b=pred[..., 1], u=pred[..., 2], w=pred[..., 3],
        rel_l2=rel_l2, rel_l2_per_channel=np.asarray(per_ch))
    print(f"saved predictions to {args.save_path}")
    return results


if __name__ == "__main__":
    main()
