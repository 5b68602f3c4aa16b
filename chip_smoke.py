"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases (any failure raises and exits non-zero):

1. require a CUDA device; print the card (``nvidia-smi`` name and power
   limit), the torch / CUDA / sympy versions and both TF32 flags
   (switched off);
2. build every kernel from ``space_time_pde_torch/csrc`` (one nvcc per
   source, in parallel); print each kernel's registers and spills from
   ptxas, both D instantiations of the jet kernels apart, and the decode
   block's rows and dynamic shared memory at the flagship widths;
3. both decode kernels against their plain PyTorch twins on the card,
   at the rb2d flagship widths (C = 64, nf = 64, D = 3, out = 4) on
   65,536 seeded points that include lattice faces, cell edges and
   points outside the domain; tolerance rtol = atol = 1e-4 against the
   f32 twin (the kernel's 3xTF32 products are f32-grade; the summation
   order and the order of the blend-before-head rounding differ); and
   against the twin run in float64 on the card, at most DECODE_SLACK
   times as far from it as the f32 twin, ``|err| <= 1e-4 |ref| + atol
   max|ref|`` (both distances printed); CUDA-event times of both;
4. both jet kernels against their plain twins at the flagship widths on
   8,192 such points (the flagship step's count): the forward's value,
   Jacobian and Hessian blocks against ``jet_fwd_plain``, the backward's
   d feats2 and 9 parameter gradients for a seeded cotangent against
   autograd through it. The plain twin also runs in float64 on the card;
   per quantity, the kernel may sit at most JET_SLACK times as far from
   it as the f32 twin does, ``|err| <= rtol |ref| + atol max|ref|``
   (``atol_needed`` below; floor JET_FLOOR), or (see FLIP_REL) differ
   only by LeakyReLU branches taken within rounding of 0 and meet that
   rule on its own branches. CUDA-event times, plain / kernel / kernel /
   plain;
5. the flagship serving path end to end: the committed rb2d flagship
   weights (``space_time_pde_torch/assets``), a Taylor–Green dataset at
   the flagship eval geometry, ``evaluation_torch.main`` answering three
   window requests (UNet3d at igres (4, 16, 64), dense decode of a
   (16, 128, 512) lattice per window); the kernel launch counts of that
   run alone (only ``decode_blend_gather`` is on it);
6. the pre-gathered entry (``decode_blend``, off the main path on a GPU:
   the TPU ran it only as a fallback the port does not need) answering
   one scattered-point request at the reference points, counted apart;
7. 4,096 lattice points of window 0, from the dense decode and from the
   scattered request, against the JAX-CPU reference stored beside the
   weights, point by point: ``|err| <= REF_RTOL |ref| + REF_ATOL
   max|ref|`` (see below for why the absolute part scales);
8. one flagship training step against the JAX-CPU reference of
   ``scripts/export_torch_train_ref.py`` (same seeded weights, same
   batch): the loss terms within LOSS_RTOL of JAX's float32, and every
   gradient leaf against the float64 recomputation, point by point, at
   most STEP_SLACK times as far as JAX's own float32 gradients (below);
9. the training path end to end: ``train_torch.main`` with the flagship's
   model and loss flags on a Taylor–Green field made here, 2 epochs x
   8 steps (``--inner_steps 8``), then a resume that continues at epoch
   2; the jet kernels' launch counts of the first run alone, finite
   losses, the resumed step count, s/step and points/s;

and the turb3d stack (the ``r5_turb3d_200x_big`` recipe: UNet4d, 16
corners):

10. both decode kernels against their twins at D = 4 (C = 64, nf = 64,
    out = 4) on 65,536 such points, as phase 3;
11. both jet kernels at D = 4 on 4,096 points (the turb3d step: 4 crops
    x 1,024), as phase 4;
12. the turb3d serving path: the Beltrami val and test realizations
    made here with the port's generator and checked against
    ``data/SHA256SUMS.beltrami`` (or, where the zip bytes differ, the
    raw arrays against the digest stored with the reference points);
    ``experiments/turb3d/evaluation_torch.main`` on the committed
    export, 4 windows of each split, each a dense decode of an
    (8, 32, 32, 32) lattice; the launch counts of those runs alone;
    every per-window rel-L2 within TURB3D_REL_TOL of the committed
    JAX-CPU log's;
13. the 4,096 reference points of val window 0 against the dense
    decode, and a scattered-point request (``decode_blend`` at D = 4)
    encoded with cuDNN on and off, point by point: atol twice JAX f32's
    own distance from its float64 recomputation, read from the asset;
14. one turb3d training step against
    ``assets/turb3d_train_step_ref.npz``, by phase 8's rule;
15. ``experiments/turb3d/train_torch.main`` with the recipe's model and
    loss flags on three Beltrami realizations made here, 2 epochs x 8
    steps, then a resume; as phase 9;

then three paths of the rb2d flagship added later (each phase's launch
counts are set to 0 just before its path runs and read just after):

A. real RB2D windows: the 8 eval windows of the JAX-CPU log
   ``log/r5_rb2d_4x_e900/eval_cpu.log`` (val s7 at t0 0/46/92/138, test
   s123 at t0 23/69/115/161), exported with their low-res input, 4,096
   seeded lattice points each, JAX's f32 and float64 decode there and
   the high-res truth (``assets/r5_rb2d_4x_e900_230400_rb2d_windows.npz``;
   the datasets themselves are not in the repo); the port's eval path
   (the eval CLI's models, UNet3d on cuDNN, ``make_dense_decoder``
   through ``decode_blend_gather``) decodes each window's whole (16, 128,
   512) lattice; every point is held to phase 7's rule with the atol
   twice JAX f32's own worst distance from float64 over the windows
   (REF_SLACK); the port's and JAX's pointwise rel-L2 against the truth;
B. a BatchNorm step: one flagship-width ``norm="batch"`` step against
   ``assets/rb2d_bn_train_step_ref.npz`` by phase 8's rule, plus every
   new running statistic against float64 at rtol STATS_RTOL with an
   atol twice JAX f32's own worst (STEP_SLACK); then ``train_torch.main``
   with the flagship flags and ``--norm batch`` for 2 epochs x 8 steps,
   a resume that trains no epoch (its running statistics equal the first
   run's bit for bit) and a resume that trains epoch 2, as phase 9;
C. a JAX run resumed: the flagship's exported optimizer state
   (``assets/r5_rb2d_4x_e900_230400_opt.npz``) restored bit for bit
   (parameters, Adam moments, count, counters); one step on the batch of
   ``assets/rb2d_resume_step_ref.npz`` with the resumed run's schedule
   (``--epochs 1800``: the flagship's own ends at the checkpoint, with a
   learning rate of 0 there): the loss terms and the gradients' global
   norm within LOSS_RTOL of JAX f32, per parameter the norms of its
   change and of the changes of ``mu`` and ``nu`` within DNORM_RTOL of
   JAX's, the ImNet's parameter changes within DP_RTOL plus twice JAX
   f32's own atol against float64 Adam; then ``train_torch.main
   --resume <the export> --epochs 1800 --run_epochs 1`` on the
   Taylor–Green field (the cliff detector off: the model is far off its
   data there): it starts at step 230,400, finite losses;

and the parallel paths (``space_time_pde_torch/parallel``), their ranks
processes of this script (``--worker``) started as ``torchrun`` starts
them; with more ranks than cards the ranks share the cards over gloo
(halo planes through host memory, the compute on the card), so their
times measure no scaling:

D. the flagship step of phase 8's reference on 4 ranks, each held to
   phase 8's rule with its constants, the gradients compared being the
   all-reduced ones: data-parallel over 2 data ranks (each data group of
   the 2 x 2 world), the data x space step on 2 x 2 with the replicated
   encoder and with ``ShardedUNet3d`` (L1 + Huber: the port's sharded
   loss honours the loss kinds), and phase B's BatchNorm step over 2 data
   ranks with synced statistics (phase B's rule);
E. phase 14's turb3d step on 2 x 2 with ``ShardedUNet4d``, jets at D = 4;
F. the train CLIs: rb2d with ``--space_devices 2 --sharded_encoder`` on
   4 ranks (an 8-step epoch and a resume), with the replicated encoder,
   data-parallel on 2 ranks, and at world 1 on NCCL in this process;
   turb3d with ``--space_devices 2 --sharded_encoder`` on 4 ranks; with
   two cards or more also rb2d data-parallel over NCCL, a rank a card.
   Each path's launches are summed over its ranks;

and the bf16 compute policy (``use_bf16``; each phase's launch counts
set to 0 just before its path and read just after):

G. the gather decode's bf16 instantiation (``decode_blend_gather`` with
   ``compute_dtype=bfloat16``, ``stpde_decode_blend_gather_bf16``)
   against its bf16 plain twin on phase 3's and 10's 65,536 points and
   grids (D = 3 and 4, C = 64, nf = 64), the table rounded to bf16: per
   point within BF16_DIRECT of max |twin|, and against the f32 function
   in float64 at most BF16_KERNEL_SLACK times as far as the twin; CUDA-
   event times against the bf16 bound;
H. the 8 real RB2D windows of phase A through the eval CLI's models and
   ``make_dense_decoder`` at ``--decode_dtype bf16`` (the f32 checkpoint's
   UNet, the bf16 decode): per point within BF16_DIRECT of max |JAX bf16|
   (``assets/r5_rb2d_4x_e900_230400_rb2d_windows_bf16.npz``, the TPU
   gather kernel at bf16 in interpret mode), and at most BF16_SLACK times
   JAX bf16's worst distance from float64; per-window rel-L2 of the port
   bf16, JAX bf16 and JAX f32;
I. phase 8's step under ``use_bf16`` against
   ``assets/rb2d_bf16_train_step_ref.npz``: the loss terms within
   BF16_LOSS_RTOL of JAX bf16's, every gradient leaf against phase 8's
   float64 leaves within STEP_SLACK times JAX bf16's worst;
J. both train CLIs with ``--use_bf16 true`` (phases 9's and 15's flags,
   2 epochs x 8 steps: finite, s/step) and both eval CLIs with
   ``--decode_dtype bf16`` (phase 5's 3 Taylor–Green windows and 4
   turb3d val windows: points/s, rel-L2), decoding through the bf16
   kernel alone;

and the bf16 jets (``--use_bf16 --pde_bf16``) and the bf16 pre-gathered
decode (each phase's launch counts set to 0 just before its path and
read just after):

K. both bf16 jet kernels (``stpde_jet_fwd_bf16`` / ``_bwd_bf16``,
   ``csrc/fused_jet_bf16.cu``) against their bf16 twins
   (``jet_fwd_plain`` at bf16, ``jet_bwd_bf16_plain``) on phase 4's 8,192
   points (D = 3) and phase 11's 4,096 (D = 4), rows rounded to bf16 and
   weights packed at bf16: every forward block and backward gradient
   within BF16_DIRECT of max |twin|, and from the f32 function in float64
   at most BF16_KERNEL_SLACK times the twin's atol; a LeakyReLU branch
   the kernel took otherwise than the twin passes where the twin's
   pre-activation lies within BF16_FLIP_REL of its layer's max |pre| and
   the kernel meets both rules on its own branches (read from its
   workspace); CUDA-event times against the bf16 bound;
L. the pre-gathered decode's bf16 instantiation (``decode_blend`` at
   bf16, ``stpde_decode_blend_bf16``) against its bf16 twin by phase G's
   rule at D = 3 and 4 on 65,536 points, and one scattered-point request
   at bf16 through ``gather="pregather"`` on the same points (off the
   main paths, counted apart);
M. phase 8's step under ``use_bf16`` with ``pde_bf16`` against
   ``assets/rb2d_bf16_pde_train_step_ref.npz`` (JAX's loss with its jet
   the Pallas kernels at bf16, op by op) by phase I's rules, except that
   a loss term outside BF16_LOSS_RTOL of JAX bf16's passes if it is no
   farther from float64 than STEP_SLACK times JAX bf16's own distance
   (the bf16 jet's rounding noise on the PDE terms is about
   BF16_LOSS_RTOL: ``scripts/export_torch_train_ref.py --recipe
   rb2d_bf16_pde`` prints how far the port's plain twins on the CPU sit
   from JAX bf16 there); the bf16 jets launched and the f32 ones not;
N. both train CLIs with ``--use_bf16 true --pde_bf16 true`` (phase J's
   runs): finite losses, s/step, the path's jets ``jet_*_bf16`` alone;

and last, one JSON line of the eight kernels (the four f32 kernels and
the four bf16 instantiations; ``path``: eval, train or off_path;
``math``: tf32x3 for the f32 kernels (3xTF32 on the tensor cores), bf16
for the bf16 ones; launches per path and per D; times, plain times and
bounds at D = 4, and at D = 3 under ``d3``: ``bound_ms`` against the
kernel's own arithmetic, ``bound_f32_ms`` against f32 FFMA), then the
status line.

Imports nothing of JAX or of the JAX package.
"""

import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(ROOT, "space_time_pde_torch", "assets")
ASSET = os.path.join(ASSETS, "r5_rb2d_4x_e900_230400.npz")
STEP_REF = os.path.join(ASSETS, "rb2d_train_step_ref.npz")
TURB3D_ASSET = os.path.join(ASSETS, "r5_turb3d_200x_big_76800.npz")
TURB3D_STEP_REF = os.path.join(ASSETS, "turb3d_train_step_ref.npz")
TURB3D_LOG = os.path.join(ASSETS, "r5_turb3d_200x_big_76800_eval_cpu.log")
WINDOWS_REF = os.path.join(ASSETS, "r5_rb2d_4x_e900_230400_rb2d_windows.npz")
BN_STEP_REF = os.path.join(ASSETS, "rb2d_bn_train_step_ref.npz")
OPT_ASSET = os.path.join(ASSETS, "r5_rb2d_4x_e900_230400_opt.npz")
RESUME_REF = os.path.join(ASSETS, "rb2d_resume_step_ref.npz")
WINDOWS_BF16_REF = os.path.join(
    ASSETS, "r5_rb2d_4x_e900_230400_rb2d_windows_bf16.npz")
BF16_STEP_REF = os.path.join(ASSETS, "rb2d_bf16_train_step_ref.npz")
BF16_PDE_STEP_REF = os.path.join(ASSETS, "rb2d_bf16_pde_train_step_ref.npz")
RESUME_EPOCHS = 1800            # the resumed flagship run's --epochs
N_CHECK = 65536                 # points per decode kernel-vs-plain call
N_JET = 8192                    # the flagship step: 8 crops x 1,024 points
N_JET4 = 4096                   # the turb3d step: 4 crops x 1,024 points
RTOL = ATOL = 1e-4              # decode kernel vs plain, f32 both
DECODE_SLACK = 2.0              # decode vs float64: x the f32 twin's need
# Port vs the JAX-CPU reference points, per point:
#   |err| <= REF_RTOL * |ref| + REF_ATOL * max |ref|.
# On this input the RB2D model's latents reach ~5e6 and its outputs
# ~3e5, so f32 rounding leaves an error floor set by the largest
# magnitudes, not by each point's own. Measured on the 4,096 points: at
# rtol 1e-4, JAX's f32 result needs atol 2.51e-6 of max |ref| to cover
# its distance from its float64 recomputation, and the port's CPU path
# 1.46e-6 against JAX f32 and 1.73e-6 against float64. The limit is
# twice JAX's own floor.
REF_RTOL, REF_ATOL = 1e-4, 5e-6
# Jet kernels vs the float64 plain twin: at most twice the f32 twin's own
# distance. A pre-activation within f32 rounding of 0 takes the other
# mask in f32 than in f64, which moves that point's Jacobian and Hessian
# by a finite step; both f32 paths see such flips, so their distance is
# a scale-relative floor, never below JET_FLOOR of max |ref|. Where the
# kernel flipped a branch the f32 twin did not, the quantity passes only
# if every branch on which the kernel and float64 differ has a float64
# pre-activation within FLIP_REL of its layer's max |pre| (a flip, not a
# fault), and on the kernel's own branches (read from its workspace) the
# kernel meets the same rule against the float64 twin on those branches.
JET_RTOL, JET_SLACK, JET_FLOOR, FLIP_REL = 1e-4, 2.0, 1e-6, 1e-5
# Training step vs the JAX reference: loss terms against JAX float32;
# every gradient leaf against float64, point by point, with atol (a
# fraction of the leaf's max |g64|) twice the largest that JAX float32
# itself needs over all leaves (read from the reference file). Not per
# leaf: the f32 gradient's error comes mostly from mask flips, so any
# one leaf's error is a draw of a few discrete events.
LOSS_RTOL = 1e-4
STEP_SLACK = 2.0
# turb3d eval: each per-window rel-L2 against the JAX-CPU log's printed
# value (5 decimals). Summation order differs; 1e-5 is ~0.2% of the
# ~6e-3 rel-L2 and one unit in the printed last digit.
TURB3D_REL_TOL = 1e-5
REF_SLACK = 2.0                 # turb3d reference points: x JAX's own
# BatchNorm's new running statistics vs float64 (phase B).
STATS_RTOL = 1e-4
# The resumed step (phase C): per parameter, the norms of the changes of
# the parameter, mu and nu against JAX f32's, relative; the ImNet's
# parameter changes point by point at rtol DP_RTOL plus STEP_SLACK times
# JAX f32's own atol against float64 Adam.
DNORM_RTOL = DP_RTOL = 1e-3
# The bf16 policy (phases G-J). Direct: per point within BF16_DIRECT of
# max |ref| of the bf16 yardstick (four bf16 steps; two paths that both
# sum bf16 products in f32 still round a value to the other side of a
# step now and then). Distance from the float64 reference: at most
# BF16_KERNEL_SLACK times the bf16 twin's own (phase G, the decode rule)
# or BF16_SLACK times JAX bf16's (phase H). Phase I: the loss terms
# within BF16_LOSS_RTOL of JAX bf16's, every gradient leaf within
# STEP_SLACK times JAX bf16's worst distance from float64 (phase 8's
# rule).
BF16_DIRECT = 4 * 2.0 ** -8
BF16_KERNEL_SLACK = 2.0
BF16_SLACK = 1.5
BF16_LOSS_RTOL = 1e-3
# The bf16 jets (phase K) against their bf16 twins: a skip term summed in
# another order can round to the other bf16 step (2^-8 of it) and move a
# pre-activation near 0 to the other LeakyReLU branch. Such a flip is
# accepted where the twin's pre-activation lies within BF16_FLIP_REL (four
# bf16 steps) of its layer's max |pre|, and the kernel meets both rules on
# its own branches (the twins and the float64 function run on them).
BF16_FLIP_REL = 4 * 2.0 ** -8
# The card's peaks (NVIDIA's H100 SXM data sheet, 700 W): f32 outside the
# tensor cores, dense TF32 in them, and HBM3.
F32_FLOPS, TF32_FLOPS, HBM_BYTES = 67e12, 495e12, 3.35e12
BF16_FLOPS = 989e12             # dense bf16 on the tensor cores
# How each kernel does its products: the four f32 kernels in 3xTF32 on
# the tensor cores (three TF32 products each), the bf16 instantiations in
# bf16 (one product).
MATH = {"decode_blend_gather": "tf32x3", "decode_blend": "tf32x3",
        "jet_fwd": "tf32x3", "jet_bwd": "tf32x3",
        "decode_blend_gather_bf16": "bf16", "decode_blend_bf16": "bf16",
        "jet_fwd_bf16": "bf16", "jet_bwd_bf16": "bf16"}
REPLACES = {
    "decode_blend_gather": "space_time_pde_tpu/ops/fused_query.py:244",
    "decode_blend_gather_bf16": "space_time_pde_tpu/ops/fused_query.py:244",
    "decode_blend": "space_time_pde_tpu/ops/fused_query.py:400",
    "decode_blend_bf16": "space_time_pde_tpu/ops/fused_query.py:400",
    "jet_fwd": "space_time_pde_tpu/ops/fused_jet.py:175",
    "jet_bwd": "space_time_pde_tpu/ops/fused_jet.py:219",
    "jet_fwd_bf16": "space_time_pde_tpu/ops/fused_jet.py:175",
    "jet_bwd_bf16": "space_time_pde_tpu/ops/fused_jet.py:219",
}
SOURCES = {
    "decode_blend_gather": "space_time_pde_torch/csrc/fused_query.cu",
    "decode_blend_gather_bf16": "space_time_pde_torch/csrc/fused_query.cu",
    "decode_blend": "space_time_pde_torch/csrc/fused_query.cu",
    "decode_blend_bf16": "space_time_pde_torch/csrc/fused_query.cu",
    "jet_fwd": "space_time_pde_torch/csrc/fused_jet.cu",
    "jet_bwd": "space_time_pde_torch/csrc/fused_jet.cu",
    "jet_fwd_bf16": "space_time_pde_torch/csrc/fused_jet_bf16.cu",
    "jet_bwd_bf16": "space_time_pde_torch/csrc/fused_jet_bf16.cu",
}
PATHS = {"decode_blend_gather": "eval", "decode_blend": "off_path",
         "jet_fwd": "train", "jet_bwd": "train",
         "decode_blend_gather_bf16": "eval", "decode_blend_bf16": "off_path",
         "jet_fwd_bf16": "train", "jet_bwd_bf16": "train"}
T0 = time.perf_counter()


def say(msg):
    print(f"[{time.perf_counter() - T0:6.1f}s] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` launches."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_points(rng, spatial, n):
    """n query points in [0, 1]^D coordinates: uniform ones that
    overshoot the domain, points on the domain faces, and points on
    lattice nodes (cell edges and corners)."""
    dim = len(spatial)
    n4 = n // 4
    uniform = rng.uniform(-0.05, 1.05, (n - 2 * n4, dim))
    faces = rng.rand(n4, dim)
    axis = rng.randint(0, dim, n4)
    faces[np.arange(n4), axis] = rng.randint(0, 2, n4)
    nodes = np.stack([rng.randint(0, s, n4) / (s - 1.0) for s in spatial],
                     -1)
    return np.concatenate([uniform, faces, nodes]).astype(np.float32)


def atol_needed(got, want, scale, rtol=REF_RTOL):
    """Smallest atol (a fraction of ``scale``) at which
    ``|got - want| <= rtol |want| + atol * scale`` holds everywhere."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if scale == 0.0:
        return 0.0 if np.array_equal(got, want) else float("inf")
    return max(0.0, float(np.max(np.abs(got - want)
                                 - rtol * np.abs(want))) / scale)


def ptxas_summary(log: str):
    """``kernel<template args>: registers, spills`` per entry function of
    a ptxas ``-v`` log."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(
                r"\d+((?:[a-z]+_)+(?:[a-z]+\d+_)*kernel)"
                r"(I(?:L[ib]\d+E|f|13__nv_bfloat16)+E)?", m.group(1))
            args = [a.group(1) or ("float" if a.group(0) == "f" else "bf16")
                    for a in re.finditer(r"L[ib](\d+)E|f|13__nv_bfloat16",
                                         k.group(2) or "")]
            name = k.group(1) + (f"<{', '.join(args)}>" if args else "")
            spills = "spill not reported"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = f"spill {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spills}")
            name = None
    return out


def bound(kind, *, n, c, dim, nf, out, n_cells=0, math="ffma"):
    """(bound_ms, bound_by) of one call: the larger of the operations it
    needs over the peak of ``math`` (f32 operations over F32_FLOPS for
    "ffma"; three TF32 operations for each over TF32_FLOPS for
    "tf32x3"; bf16 operations over BF16_FLOPS for "bf16", whose latent
    rows, weights and stored chains are 2 bytes a value, except the f32
    ``corner_bias`` of the pre-gathered decode and the jets, the jets'
    layer-4 chains and every kernel output) and of the bytes it must move
    (each input read once, each output written once) over HBM_BYTES.
    Per corner row the decode needs (C + D) 31nf multiply-adds for the
    skip terms and 170 nf^2 for the hidden layers; the jet runs the
    hidden layers on D + 1 chains, the skip terms on the primal only,
    and blends 1 + D + D(D+1)/2 blocks; its backward needs two products
    per layer (the weight gradient and the back-propagated chain) and
    reads the forward's stored chains and masks. The head and blend are
    counted at the same peak as the products (the kernels run them in
    f32 FFMA; they are under 1% of the operations)."""
    k, s = 2 ** dim, 31 * nf
    hidden = 170 * nf * nf
    rows = n * k
    wb = 2 if math == "bf16" else 4
    cbb = wb if kind == "decode_blend_gather" else 4    # corner_bias
    weights = wb * ((c + dim) * s + hidden + nf * out) + cbb * k * s \
        + 4 * out
    weights32 = 4 * ((c + dim + k) * s + hidden + nf * out + out)
    chains = dim + 1
    blocks = 1 + dim + dim * (dim + 1) // 2
    head = 2 * n * blocks * (k * chains * nf + nf * out)
    if kind == "decode_blend_gather":
        flop = 2 * rows * ((c + dim) * s + hidden + nf) + 2 * n * nf * out
        byts = wb * n_cells * k * c + 4 * n + 4 * n * dim + weights \
            + 4 * n * out
    elif kind == "decode_blend":
        flop = 2 * rows * ((c + dim) * s + hidden + nf) + 2 * n * nf * out
        byts = wb * rows * c + 4 * n * dim + weights + 4 * n * out
    elif kind == "jet_fwd":
        flop = 2 * rows * (chains * hidden + (c + dim) * s) + head
        byts = wb * rows * c + 4 * n * dim + weights + 4 * n * blocks * out
    else:
        flop = 2 * rows * (2 * chains * hidden + 2 * c * s) + 2 * head
        # The chains of layers 0-3 in the compute type, layer 4's in f32,
        # and the masks; d feats2 and the gradients written in f32.
        saved = rows * chains * (wb * (s - nf) + 4 * nf) + rows * s
        byts = (wb + 4) * rows * c + 4 * n * dim + weights + weights32 \
            + saved + 4 * n * blocks * out
    t_op = (3 * flop / TF32_FLOPS if math == "tf32x3"
            else flop / (BF16_FLOPS if math == "bf16" else F32_FLOPS)) * 1e3
    t_mem = byts / HBM_BYTES * 1e3
    return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")


def load_imnet(asset, dim, device):
    """The committed export's ImNet on ``device``, in eval mode."""
    from space_time_pde_torch.bridge import load_exported, load_flax_params
    from space_time_pde_torch.models import ImNet

    exported = load_exported(asset)
    m = exported["config"]["model"]
    lat, nf = m["lat_dims"], m["imnet_nf"]
    if dim == 4:
        targs = exported["meta"]["turb3d_args"]
        lat, nf = targs["lat_dims"], targs["imnet_nf"]
    imnet = ImNet(dim=dim, in_features=lat, out_features=m["out_channels"],
                  nf=nf, activation=m["activation"],
                  negative_slope=m["negative_slope"])
    load_flax_params(imnet, exported["params"]["imnet"])
    return imnet.to(device).eval()


def decode_inputs(imnet, device, spatial):
    """The decode checks' inputs: N_CHECK seeded points on a seeded latent
    grid of ``spatial`` as (cell_flat, frac, f32 table, packed weights,
    the wrappers' keywords), the f32 function's float64 value there (the
    plain twin in float64), and the grid and the points themselves."""
    from space_time_pde_torch.ops import fused_query as fq
    from space_time_pde_torch.ops.grid_interp import _locate

    rng = np.random.RandomState(0)
    grid = torch.from_numpy(
        rng.randn(*spatial, imnet.in_features).astype(np.float32)).to(device)
    pts = torch.from_numpy(check_points(rng, spatial, N_CHECK)).to(device)
    cell, frac = _locate(pts, spatial, 0.0, 1.0)
    cell_flat = fq._flat_cells(cell, spatial)
    table = fq.cell_major_features(grid).contiguous()
    packed = fq.pack_imnet_params(imnet)
    kw = dict(nf=imnet.nf, activation=imnet.activation,
              negative_slope=imnet.negative_slope)
    want64 = fq.decode_blend_gather_plain(
        table.double(), cell_flat, frac.double(),
        {k: v.double() for k, v in packed.items()}, **kw)
    return (cell_flat, frac, table, packed, kw, want64.cpu().numpy(), grid,
            pts)


def kernel_vs_plain(imnet, device, spatial):
    """Phases 3 and 10: both decode entry points against their plain
    twins on N_CHECK points of a seeded latent grid of ``spatial``."""
    from space_time_pde_torch.ops import fused_query as fq

    dim = len(spatial)
    cell_flat, frac, table, packed, kw, want64, _, _ = decode_inputs(
        imnet, device, spatial)
    feats2 = table[cell_flat.long()].reshape(
        -1, imnet.in_features).contiguous()
    calls = {
        "decode_blend_gather": (
            lambda: fq.decode_blend_gather(table, cell_flat, frac, packed,
                                           **kw),
            lambda: fq.decode_blend_gather_plain(table, cell_flat, frac,
                                                 packed, **kw)),
        "decode_blend": (
            lambda: fq.decode_blend(feats2, frac, packed,
                                    n_corners=2 ** dim, **kw),
            lambda: fq.decode_blend_plain(feats2, frac, packed,
                                          n_corners=2 ** dim, **kw)),
    }
    # Both entries compute the same function: one float64 twin.
    scale = float(np.abs(want64).max())
    rows = {}
    for name, (kernel, plain) in calls.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs()
        max_abs = float(err.max())
        max_rel = float((err / want.abs().clamp_min(1e-6)).max())
        ok = bool((err <= ATOL + RTOL * want.abs()).all())
        need_k = atol_needed(got.cpu().numpy(), want64, scale, RTOL)
        need_p = atol_needed(want.cpu().numpy(), want64, scale, RTOL)
        ok64 = need_k <= DECODE_SLACK * need_p
        # Plain, kernel, kernel, plain: both see the same card state.
        p1, k1, k2, p2 = (cuda_ms(f, 5) for f in (plain, kernel, kernel,
                                                   plain))
        shape = dict(n=N_CHECK, c=imnet.in_features, dim=dim, nf=imnet.nf,
                     out=imnet.out_features, n_cells=table.shape[0])
        b_ms, b_by = bound(name, math=MATH[name], **shape)
        b32, _ = bound(name, **shape)
        rows[name] = {"max_abs_err": max_abs, "ms": (k1 + k2) / 2,
                      "plain_ms": (p1 + p2) / 2, "bound_ms": b_ms,
                      "bound_by": b_by, "bound_f32_ms": b32,
                      "atol_vs_f64": need_k, "plain_atol_vs_f64": need_p}
        say(f"{name}: {N_CHECK} pts at D={dim} C={imnet.in_features} "
            f"nf={imnet.nf}: max abs err {max_abs:.3e}, max rel err "
            f"{max_rel:.3e} (tolerance rtol=atol={RTOL:g}); vs the "
            f"float64 twin (max|ref| {scale:.4e}, rtol {RTOL:g}) the kernel "
            f"needs atol {need_k:.3e}, the f32 twin {need_p:.3e}, limit "
            f"{DECODE_SLACK * need_p:.3e}; kernel {k1:.3f}/{k2:.3f} ms, "
            f"plain {p1:.3f}/{p2:.3f} ms, bound {b_ms:.3f} ms ({b_by}, "
            f"{MATH[name]}; f32 FFMA {b32:.3f} ms)")
        if not ok or not ok64 or not torch.isfinite(got).all():
            raise SystemExit(f"{name}: kernel disagrees with its plain "
                             f"twin (max abs err {max_abs:.3e}; vs float64 "
                             f"atol {need_k:.3e}, f32 twin {need_p:.3e})")
    del want64
    return rows


def _held(what, got, plain32, plain64, masked, flips_ok):
    """(kernel's atol need, f32 twin's, limit) against the float64 twin,
    per quantity; raises when the kernel exceeds the limit and the
    excess is not a branch flip (``masked``: the f32 and float64 twins
    on the kernel's own branches)."""
    def needs(g, p, r):
        g, p, r = (t.detach().double().cpu().numpy() for t in (g, p, r))
        scale = float(np.abs(r).max())
        need_k = atol_needed(g, r, scale, JET_RTOL)
        need_p = atol_needed(p, r, scale, JET_RTOL)
        return scale, need_k, need_p, max(JET_SLACK * need_p, JET_FLOOR)

    scale, need_k, need_p, limit = needs(got, plain32, plain64)
    ok = need_k <= limit and bool(torch.isfinite(got).all())
    note = "ok" if ok else "FAIL"
    if not ok and flips_ok and bool(torch.isfinite(got).all()):
        _, mk, mp, ml = needs(got, *masked)
        ok = mk <= ml
        note = (f"branch flips near 0; on the kernel's branches needs "
                f"{mk:.3e}, f32 twin {mp:.3e}, limit {ml:.3e} "
                + ("ok" if ok else "FAIL"))
    print(f"  {what:12s} max|ref| {scale:.4e}: kernel needs atol "
          f"{need_k:.3e}, f32 twin {need_p:.3e}; limit {limit:.3e} {note}",
          flush=True)
    if not ok:
        raise SystemExit(f"{what}: jet kernel disagrees with its plain twin")
    return float((got.double() - plain32.double()).abs().max())


def _flips_near_zero(kmasks, pres, rel=FLIP_REL, what="kernel vs float64"):
    """Whether every branch where the kernel and the reference whose
    pre-activations are ``pres`` differ lies within ``rel`` of 0 (of its
    layer's max |pre|); prints the flip count."""
    flips, ok = 0, True
    for m, pre in zip(kmasks, pres):
        pre = pre.reshape(m.shape)
        flip = m != (pre >= 0)
        flips += int(flip.sum())
        if flip.any():
            ok &= float(pre[flip].abs().max()) <= \
                rel * float(pre.abs().max())
    print(f"  {what} branches: {flips} flips, all within {rel:g} of their "
          f"layer's max |pre|: {ok}", flush=True)
    return ok


def jet_inputs(imnet, device, spatial, n):
    """The jet kernels' seeded inputs on n points of a latent grid of
    ``spatial``: (feats2, frac, packed, ybar, kwargs of the wrappers)."""
    from space_time_pde_torch.ops import fused_jet as fj
    from space_time_pde_torch.ops import fused_query as fq
    from space_time_pde_torch.ops.grid_interp import _locate

    rng = np.random.RandomState(1)
    dim = len(spatial)
    grid = torch.from_numpy(
        rng.randn(*spatial, imnet.in_features).astype(np.float32)).to(device)
    pts = torch.from_numpy(check_points(rng, spatial, n)).to(device)
    cell, frac = _locate(pts, spatial, 0.0, 1.0)
    table = fq.cell_major_features(grid)
    feats2 = table[fq._flat_cells(cell, spatial).long()].reshape(
        -1, grid.shape[-1]).contiguous()
    with torch.no_grad():
        packed = fq.pack_imnet_params(imnet)
    blocks = 1 + dim + dim * (dim + 1) // 2
    ybar = torch.from_numpy(rng.randn(n, blocks, imnet.out_features).astype(
        np.float32)).to(device)
    kw = dict(nf=imnet.nf,
              slope=fj.jet_slope(imnet.activation, imnet.negative_slope))
    return feats2, frac.contiguous(), packed, ybar, kw


def jet_vs_plain(imnet, device, spatial, n):
    """Phases 4 and 11: both jet kernels against their plain twins on n
    points of a seeded latent grid of ``spatial``."""
    from space_time_pde_torch.ops import _build
    from space_time_pde_torch.ops import fused_jet as fj

    dim = len(spatial)
    feats2, frac, packed, ybar, kw = jet_inputs(imnet, device, spatial, n)
    p64 = {k: v.double() for k, v in packed.items()}
    f64, fr64 = feats2.double(), frac.double()

    out, ws = fj.jet_fwd(feats2, frac, packed, **kw)
    torch.cuda.synchronize()
    km = fj.workspace_masks(ws, n, dim, imnet.nf)
    want = fj.jet_fwd_plain(feats2, frac, packed, **kw)
    want64, pres64 = fj.jet_fwd_plain(f64, fr64, p64, return_pre=True, **kw)
    names = (["value"] + [f"jac_{a}" for a in range(dim)]
             + [f"hess_{a}{b}" for a, b in fj.tri_pairs(dim)])
    print(f"jet_fwd: {n} pts at D={dim} C={imnet.in_features} "
          f"nf={imnet.nf} vs the f32 / float64 plain twin (rtol "
          f"{JET_RTOL:g}):", flush=True)
    flips_ok = _flips_near_zero(km, pres64)
    del pres64
    want_m = fj.jet_fwd_plain(feats2, frac, packed, masks=km, **kw)
    want64_m = fj.jet_fwd_plain(f64, fr64, p64, masks=km, **kw)
    fwd_err = max(_held(nm, out[:, i], want[:, i], want64[:, i],
                        (want_m[:, i], want64_m[:, i]), flips_ok)
                  for i, nm in enumerate(names))
    del want64, want_m, want64_m

    y64 = ybar.double()
    dfeats, grads = fj.jet_bwd(feats2, frac, packed, ws, ybar, **kw)
    torch.cuda.synchronize()
    d32, g32 = fj.jet_bwd_plain(feats2, frac, packed, ybar, **kw)
    d64, g64 = fj.jet_bwd_plain(f64, fr64, p64, y64, **kw)
    d32m, g32m = fj.jet_bwd_plain(feats2, frac, packed, ybar, masks=km, **kw)
    d64m, g64m = fj.jet_bwd_plain(f64, fr64, p64, y64, masks=km, **kw)
    print("jet_bwd: d feats2 and the packed-parameter gradients for a "
          "seeded cotangent:", flush=True)
    bwd_err = _held("dfeats2", dfeats, d32, d64, (d32m, d64m), flips_ok)
    for name in grads:
        bwd_err = max(bwd_err, _held(name, grads[name], g32[name],
                                     g64[name], (g32m[name], g64m[name]),
                                     flips_ok))
    del d64, g64, d32m, g32m, d64m, g64m, km

    lib = _build.load("fused_jet")
    shape = (n, feats2.shape[-1], dim, imnet.nf, packed["w5"].shape[-1])
    say(f"jet workspace at D={dim}, {n} pts: forward (every layer's chains "
        f"and masks, read by the backward) "
        f"{lib.stpde_jet_fwd_workspace(*shape)} bytes, backward scratch "
        f"{lib.stpde_jet_bwd_workspace(*shape)} bytes")
    fwd_k = lambda: fj.jet_fwd(feats2, frac, packed, **kw)
    fwd_p = lambda: fj.jet_fwd_plain(feats2, frac, packed, **kw)
    bwd_k = lambda: fj.jet_bwd(feats2, frac, packed, ws, ybar, **kw)
    bwd_p = lambda: fj.jet_bwd_plain(feats2, frac, packed, ybar, **kw)
    rows = {}
    for name, kernel, plain, err in (("jet_fwd", fwd_k, fwd_p, fwd_err),
                                     ("jet_bwd", bwd_k, bwd_p, bwd_err)):
        p1, k1, k2, p2 = (cuda_ms(f, 3) for f in (plain, kernel, kernel,
                                                   plain))
        shape = dict(n=n, c=imnet.in_features, dim=dim, nf=imnet.nf,
                     out=imnet.out_features)
        b_ms, b_by = bound(name, math=MATH[name], **shape)
        b32, _ = bound(name, **shape)
        ms = (k1 + k2) / 2
        rows[name] = {"max_abs_err": err, "ms": ms,
                      "plain_ms": (p1 + p2) / 2, "bound_ms": b_ms,
                      "bound_by": b_by, "bound_f32_ms": b32}
        say(f"{name} (D={dim}, {n} pts): max abs err vs f32 twin "
            f"{err:.3e}; kernel {k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/"
            f"{p2:.3f} ms, bound {b_ms:.3f} ms ({b_by}, {MATH[name]}; "
            f"{100 * b_ms / ms:.1f}% of it), f32 FFMA {b32:.3f} ms")
    return rows


def buffers_as_flax(module):
    """The module's BatchNorm statistics as a flax ``batch_stats`` tree
    (None without BatchNorm)."""
    from space_time_pde_torch.bridge import unflatten_tree

    leaves = {"running_mean": "mean", "running_var": "var"}
    flat = {}
    for name, b in module.named_buffers():
        layer, leaf = name.rsplit(".", 1)
        if leaf in leaves:
            flat[f"{layer.replace('.', '/')}/{leaves[leaf]}"] = \
                b.cpu().numpy()
    return unflatten_tree(flat) or None


def reference_step(step_ref, device, use_bf16=False, pde_bf16=False):
    """The training step of a ``scripts/export_torch_train_ref.py`` file
    on ``device``: (cfg, pde layer, optimizer, state, batch, ref arrays,
    spec), with the seeded weights loaded into the state's models;
    ``use_bf16``: the models under the bf16 compute policy, with
    ``pde_bf16`` the jet too."""
    from space_time_pde_torch.bridge import (
        load_flax_params, seeded_flax_params)
    from space_time_pde_torch.physics import get_pde_layer
    from space_time_pde_torch.train import (
        build_models, init_state, make_optimizer)
    from space_time_pde_torch.utils.config import Config

    with np.load(step_ref, allow_pickle=False) as z:
        ref = {k: z[k] for k in z.files}
    spec = json.loads(str(ref["spec"]))
    cfg = Config.from_dict(spec["config"])
    cfg.model.use_bf16, cfg.train.pde_bf16 = use_bf16, pde_bf16
    lres_shape = ref["lres"].shape[1:-1]
    unet, imnet = build_models(cfg, lres_shape, device)
    opt = make_optimizer(cfg)
    state = init_state(cfg.train.seed, unet, imnet, opt)
    params = seeded_flax_params(spec["shapes"], spec["weight_seed"])
    # BatchNorm starts from the statistics it was built with (flax's).
    load_flax_params(unet, params["unet"], buffers_as_flax(unet))
    load_flax_params(imnet, params["imnet"])
    ext = [float(e) for e in ref["coord_extents"]]
    ph = cfg.physics
    if len(lres_shape) == 4:
        kw = dict(t_crop=ext[0], z_crop=ext[1], y_crop=ext[2],
                  x_crop=ext[3], viscosity=ph.viscosity)
    else:
        kw = dict(t_crop=ext[0], z_crop=ext[1], x_crop=ext[2],
                  rayleigh=ph.rayleigh, prandtl=ph.prandtl)
    pde = get_pde_layer(ph.pde_system, mean=ref["channel_mean"],
                        std=ref["channel_std"], **kw)
    batch = {k: torch.from_numpy(ref[k]).to(device)
             for k in ("lres", "point_coord", "point_value")}
    return cfg, pde, opt, state, batch, ref, spec


def train_step_vs_jax(device, step_ref):
    """Phases 8, 14 and B: one training step against the JAX reference."""
    from space_time_pde_torch.ops import fused_jet as fj
    from space_time_pde_torch.train import make_loss_fn, make_train_step

    cfg, pde, opt, state, batch, ref, spec = reference_step(step_ref, device)
    step_fn = make_train_step(
        make_loss_fn(cfg, state.unet, state.imnet, pde), opt)
    fj.reset_launches()
    # One optimizer step; its gradients stay in the parameters' .grad.
    state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    if fj.LAUNCHES["jet_fwd"] < 1 or fj.LAUNCHES["jet_bwd"] < 1:
        raise SystemExit(f"the training step did not run the jet kernels: "
                         f"{fj.LAUNCHES}")
    bad = check_step(state, metrics, ref, spec, f"jet launches "
                     f"{dict(fj.LAUNCHES)}")
    if bad:
        raise SystemExit(f"training step disagrees with JAX: {bad}")


def check_step(state, metrics, ref, spec, note, verbose=True, grad64=None,
               loss_rtol=LOSS_RTOL, label="JAX f32", leaf_norms=False,
               term_slack=None):
    """Phase 8's rule on a step's loss terms, gradients (the parameters'
    ``.grad``) and, with BatchNorm, new running statistics: the names
    that fail it (printed when ``verbose``). ``grad64``: {leaf: float64
    gradient} to hold the gradients to in place of the reference's.
    ``label`` names the reference's own step (``spec["terms32"]``,
    ``ref["need/..."]``), held at ``loss_rtol`` (phase I: JAX bf16).
    ``leaf_norms``: also fail a leaf whose rel-L2 distance from float64
    is more than STEP_SLACK times the reference's (``ref["relnorm/..."]``)
    for the same leaf (phase I, where the reference's worst leaf is
    0.416 of its scale: a zeroed leaf reads rel-L2 1), except a leaf
    that is 0 up to rounding, held in units of the model's largest
    gradient (its rel-L2 is noise over noise). ``term_slack``: a loss
    term outside ``loss_rtol`` still passes if it is no farther from the
    float64 term than ``term_slack`` times the reference's own distance
    (phase M, whose bf16 jet puts the PDE terms' rounding noise at the
    size of ``loss_rtol``)."""
    log = print if verbose else (lambda *a, **k: None)
    unet, imnet = state.unet, state.imnet
    terms32, terms64 = spec["terms32"], spec["terms64"]
    bad = []
    for k, v in metrics.items():
        if k not in terms32:
            continue
        got = float(v)
        rel = abs(got - terms32[k]) / max(abs(terms32[k]), 1e-30)
        own = abs(terms32[k] - terms64[k])
        ratio = abs(got - terms64[k]) / own if own else float("inf")
        log(f"  {k:18s} port {got:.8g}  {label} {terms32[k]:.8g}  "
            f"float64 {terms64[k]:.8g}  rel diff vs JAX {rel:.2e}"
            + (f"; distance from float64 {ratio:.2f}x {label}'s"
               if term_slack else ""), flush=True)
        # The temperature residual is ~1e-17 (b == 0 on Taylor-Green):
        # read it against the total loss.
        if abs(got - terms32[k]) > loss_rtol * max(abs(terms32[k]),
                                                   1e-6 * terms32["loss"]) \
                and not (term_slack and ratio <= term_slack):
            bad.append(k)
    rtol = spec["grad_rtol"]
    jax_need = max(float(ref[k]) for k in ref if k.startswith("need/"))
    limit = STEP_SLACK * jax_need
    needs, norms, held = {}, {}, {}
    for name, module in (("unet", unet), ("imnet", imnet)):
        for k, p in module.named_parameters():
            key = f"{name}.{k}"
            g = p.grad.double().cpu().numpy()
            g64 = (grad64[key] if grad64 is not None
                   else ref[f"grad64/{key}"].astype(np.float64))
            needs[key] = atol_needed(g, g64, float(ref[f"scale/{key}"]),
                                     rtol)
            norms[key] = (np.linalg.norm(g - g64) / np.linalg.norm(g64),
                          float(ref[f"relnorm/{key}"]))
            if np.abs(g64).max() > 0.5 * float(ref[f"scale/{key}"]):
                held[key] = norms[key][0] / norms[key][1]
            if needs[key] > limit or (
                    leaf_norms and held.get(key, 0.0) > STEP_SLACK):
                bad.append(key)
    for key in sorted(needs, key=needs.get)[-5:]:
        log(f"  {key:34s} needs atol {needs[key]:.3e} x max|g64| ("
            f"{label} {float(ref[f'need/{key}']):.3e}); rel L2 vs float64 "
            f"{norms[key][0]:.2e} ({label} {norms[key][1]:.2e})",
            flush=True)
    ratio = [a / b for a, b in norms.values() if b > 0]
    if verbose:
        say(f"train step vs JAX: {len(needs)} gradient leaves vs float64 "
            f"at rtol {rtol:g}: worst atol {max(needs.values()):.3e} x "
            f"max|g64| (limit {limit:.3e} = {STEP_SLACK:g} x {label}'s "
            f"worst {jax_need:.3e}); rel L2 error / JAX's: median "
            f"{np.median(ratio):.2f}, max {max(ratio):.2f}"
            + (f"; over the {len(held)} leaves held to it, max "
               f"{max(held.values()):.2f} (limit {STEP_SLACK:g})"
               if leaf_norms else "")
            + f"; {note}")
    stats = sorted(k[len("stats64/"):] for k in ref
                   if k.startswith("stats64/"))
    if stats:
        # BatchNorm's new running statistics against float64.
        buffers = {f"unet.{k}": b for k, b in unet.named_buffers()}
        scale = {k: float(np.abs(ref[f"stats64/{k}"]).max()) for k in stats}
        jax_s = max(atol_needed(ref[f"stats32/{k}"], ref[f"stats64/{k}"],
                                scale[k], STATS_RTOL) for k in stats)
        got_s = {k: atol_needed(buffers[k].double().cpu().numpy(),
                                ref[f"stats64/{k}"], scale[k], STATS_RTOL)
                 for k in stats}
        worst = max(got_s, key=got_s.get)
        if verbose:
            say(f"BatchNorm running statistics: {len(stats)} vs float64 at "
                f"rtol {STATS_RTOL:g}: worst atol {got_s[worst]:.3e} x max "
                f"({worst}; limit {STEP_SLACK * jax_s:.3e} = "
                f"{STEP_SLACK:g} x JAX f32's worst {jax_s:.3e})")
        bad += [k for k, v in got_s.items() if v > STEP_SLACK * jax_s]
    return bad


def load_driver(*parts):
    spec = importlib.util.spec_from_file_location(
        parts[-1][:-3], os.path.join(ROOT, "experiments", *parts))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_path(card, driver, flags, log_dir, batch_points, what,
               buffers=False):
    """Phases 9, 15 and B: ``driver.main`` trains 2 epochs x 8 steps,
    then resumes to epoch 3; returns the launch counts of the first run.
    ``buffers``: between the two, a resume that trains no epoch must
    restore the first run's BatchNorm statistics bit for bit."""
    from space_time_pde_torch.ops import fused_jet as fj
    from space_time_pde_torch.ops import fused_query as fq

    fj.reset_launches()
    fq.reset_launches()
    first = driver.main(flags + ["--epochs", "2"])
    torch.cuda.synchronize()
    launches = {**fj.LAUNCHES, **fq.LAUNCHES}
    if buffers:
        held = driver.main(flags + [
            "--epochs", "2", "--resume", os.path.join(log_dir,
                                                      "checkpoints")])
        want = first["state"].buffers()
        got = held["state"].buffers()
        same = sorted(got) == sorted(want) and all(
            torch.equal(got[k], want[k]) for k in want)
        say(f"{what}: {len(want)} buffers restored at step {held['step']}"
            f" bit for bit: {same}")
        if not same or held["step"] != first["step"] or not want:
            raise SystemExit(f"{what}: the resume did not restore the "
                             "BatchNorm statistics")
    resumed = driver.main(flags + [
        "--epochs", "3", "--resume", os.path.join(log_dir, "checkpoints")])
    torch.cuda.synchronize()
    say(f"{what} train path launches (2 epochs x 8 steps): {launches}")
    for name in ("jet_fwd", "jet_bwd"):
        if launches[name] < 1:
            raise SystemExit(f"{name} was not launched by the {what} train "
                             "path")
    epochs = first["epochs"] + resumed["epochs"]
    if len(epochs) != 3 or not all(
            np.isfinite([e[k] for k in e if k.endswith("loss")]).all()
            for e in epochs):
        raise SystemExit(f"training lost an epoch or went non-finite: "
                         f"{epochs}")
    if resumed["start_epoch"] != 2 or first["step"] != 16 or \
            resumed["step"] != 24:
        raise SystemExit(f"resume is not step-exact: first run ended at "
                         f"step {first['step']}, the resume started at "
                         f"epoch {resumed['start_epoch']} and ended at "
                         f"step {resumed['step']}")
    # Epoch 0 includes the first launches; epochs 1 and 2 are steady.
    sps = [e["sec_per_step"] for e in epochs[1:]]
    rate = batch_points / np.mean(sps)
    say(f"{what} train step: {np.mean(sps):.4f} s/step "
        f"({', '.join(f'{s:.4f}' for s in sps)} in epochs 1-2), "
        f"{rate:.0f} points/s ({batch_points} points a step, recipe "
        f"widths, jet + jet backward kernels) on {card}; losses "
        + ", ".join(f"{e['loss']:.5f}" for e in epochs))
    return launches


def rb2d_flags(tmp, log_dir):
    """The rb2d flagship's model and loss flags on a Taylor–Green field
    in ``tmp``, 8 steps an epoch."""
    return [
        "--device", "cuda", "--data_folder", tmp, "--train_data",
        "tg.npz", "--eval_data", "tg.npz", "--nt", "16", "--nz", "128",
        "--nx", "128", "--downsamp_t", "4", "--downsamp_xz", "8",
        "--lat_dims", "64", "--unet_nf", "32", "--imnet_nf", "64",
        "--n_samp_pts_per_crop", "1024", "--batch_size_per_gpu", "8",
        "--inner_steps", "8", "--pseudo_epoch_size", "64",
        "--alpha_pde", "0.1", "--lr", "5e-3", "--lr_schedule", "cosine",
        "--pde_loss_type", "huber", "--seed", "42",
        "--log_dir", log_dir]


def taylor_green_folder(tmp):
    from space_time_pde_torch.data import save_npz, taylor_green_fields

    save_npz(os.path.join(tmp, "tg.npz"),
             taylor_green_fields(nt=32, nz=128, nx=256))


def rb2d_train_path(card, *extra, what="rb2d"):
    """Phase 9 (and B with ``--norm batch``)."""
    with tempfile.TemporaryDirectory() as tmp:
        taylor_green_folder(tmp)
        log_dir = os.path.join(tmp, "log")
        return train_path(card, load_driver("rb2d", "train_torch.py"),
                          rb2d_flags(tmp, log_dir) + list(extra), log_dir,
                          8 * 1024, what, buffers="batch" in extra)


def rb2d_serving(device, card):
    """Phases 5-7: the rb2d eval path, the scattered request and the
    JAX-CPU reference points."""
    from space_time_pde_torch.data import save_npz, taylor_green_fields
    from space_time_pde_torch.inference import lattice_points
    from space_time_pde_torch.ops import fused_query as fq

    evaluation_torch = load_driver("rb2d", "evaluation_torch.py")
    ref_path = os.path.splitext(ASSET)[0] + "_ref.npz"
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    out_shape = tuple(int(s) for s in ref["out_shape"])
    with tempfile.TemporaryDirectory() as tmp:
        save_npz(os.path.join(tmp, "tg.npz"), taylor_green_fields(
            nt=int(ref["tg_nt"]), nz=out_shape[1], nx=out_shape[2]))
        fq.reset_launches()
        res = evaluation_torch.main([
            "--params", ASSET, "--data_folder", tmp, "--eval_data", "tg.npz",
            "--eval_windows", "3", "--device", "cuda",
            "--save_path", os.path.join(tmp, "pred.npz")])
        torch.cuda.synchronize()
        launches = dict(fq.LAUNCHES)
        with np.load(os.path.join(tmp, "pred.npz")) as saved:
            if not all(np.isfinite(saved[c]).all() for c in "pbuw"):
                raise SystemExit("non-finite values in the saved prediction")
    say(f"rb2d eval path launches: {launches}")
    if launches["decode_blend_gather"] < 1:
        raise SystemExit("decode_blend_gather was not launched by the eval "
                         "path")
    window0 = res["window0"]
    if tuple(window0.shape) != out_shape + (4,):
        raise SystemExit(f"window 0 decoded to {tuple(window0.shape)}")
    if not all(np.isfinite(res["rel_l2"])) or not torch.isfinite(
            window0).all():
        raise SystemExit("non-finite output on the eval path")

    # Phase 6: the pre-gathered entry, off the main path.
    unet, imnet_main = res["models"]
    idx = torch.from_numpy(ref["index"]).to(device)
    pts = torch.from_numpy(lattice_points(out_shape)[ref["index"]])
    fq.reset_launches()
    with torch.no_grad():
        latent = unet(torch.as_tensor(res["lres0"], device=device)[None])
        point_out = fq.fused_query_local_implicit_grid(
            imnet_main, latent, pts.to(device)[None], gather="pregather")[0]
    torch.cuda.synchronize()
    off_path = dict(fq.LAUNCHES)
    say(f"scattered-point request ({len(idx)} points, gather='pregather', "
        f"off the main paths) launches: {off_path}")
    if off_path["decode_blend"] < 1 or not torch.isfinite(point_out).all():
        raise SystemExit("the scattered-point request failed")

    # Phase 7: both against the JAX-CPU reference, point by point.
    ref32, ref64 = ref["values"].astype(np.float64), ref["values_f64"]
    scale = float(np.abs(ref64).max())
    print(f"JAX-CPU reference: {len(idx)} lattice points of window 0, max "
          f"|ref| {scale:.6g}; JAX f32 vs float64 needs atol "
          f"{atol_needed(ref32, ref64, scale):.3e} x max|ref| at rtol "
          f"{REF_RTOL:g}", flush=True)
    worst = 0.0
    for what, got in (("dense decode", window0.reshape(-1, 4)[idx]),
                      ("scattered request", point_out)):
        got = got.double().cpu().numpy()
        need32 = atol_needed(got, ref32, scale)
        need64 = atol_needed(got, ref64, scale)
        worst = max(worst, need32, need64)
        print(f"{what} vs JAX-CPU reference: max abs err "
              f"{np.abs(got - ref32).max():.4g} vs f32, "
              f"{np.abs(got - ref64).max():.4g} vs float64; needs atol "
              f"{need32:.3e} (vs f32) / {need64:.3e} (vs float64) x "
              f"max|ref| at rtol {REF_RTOL:g}; limit {REF_ATOL:g}",
              flush=True)
    if worst > REF_ATOL:
        raise SystemExit("port disagrees with the JAX-CPU reference")
    rate = res.get("steady_pts_per_s")
    say(f"dense decode: {rate / 1e6:.3f}M pts/s (UNet encode + "
        f"{out_shape} lattice decode per window, windows 2-3) on "
        f"{card}; rel-L2 vs Taylor-Green "
        + ", ".join(f"{r:.4f}" for r in res["rel_l2"])
        + " is a smoke number for an RB2D-trained model, not a quality "
          "claim")
    return launches, off_path


def jax_cpu_rel_l2(path):
    """{split: [per-window rel-L2]} printed by the committed JAX-CPU
    log."""
    out, split = {}, None
    with open(path) as f:
        for line in f:
            m = re.match(r"=== split (\w+) ===", line)
            if m:
                split = m.group(1)
                out[split] = []
            m = re.match(r"window t0=\d+: rel_l2 = ([0-9.]+)", line)
            if m:
                out[split].append(float(m.group(1)))
    return out


def beltrami_files(folder, seeds, ref=None):
    """Write the Beltrami realizations of ``seeds`` with the port's
    generator; with ``ref``, check each against
    ``data/SHA256SUMS.beltrami`` or, where the zip bytes differ (another
    numpy or zlib), its raw arrays against the digest stored in the
    reference file."""
    from space_time_pde_torch.data import beltrami_fields, save_npz

    sums = {}
    with open(os.path.join(ROOT, "data", "SHA256SUMS.beltrami")) as f:
        for line in f:
            digest, name = line.split()
            sums[os.path.basename(name)] = digest
    for seed in seeds:
        name = f"beltrami_s{seed}.npz"
        fields = beltrami_fields(seed)
        path = os.path.join(folder, name)
        save_npz(path, fields)
        if ref is None:
            continue
        with open(path, "rb") as f:
            zip_ok = hashlib.sha256(f.read()).hexdigest() == sums[name]
        h = hashlib.sha256()
        for k in "puvw":
            h.update(np.ascontiguousarray(fields[k]).tobytes())
        arrays_ok = h.hexdigest() == str(ref[f"digest_beltrami_s{seed}"])
        print(f"{name}: zip sha256 {'matches' if zip_ok else 'differs from'}"
              f" data/SHA256SUMS.beltrami; raw-array digest "
              f"{'matches' if arrays_ok else 'DIFFERS'}", flush=True)
        if not arrays_ok:
            raise SystemExit(f"{name}: the generated realization is not the "
                             "committed one")


def turb3d_serving(device, card):
    """Phases 12-13: the turb3d eval path on both splits and the JAX-CPU
    reference points."""
    from space_time_pde_torch.inference import lattice_points
    from space_time_pde_torch.ops import fused_query as fq

    evaluation_torch = load_driver("turb3d", "evaluation_torch.py")
    ref_path = os.path.splitext(TURB3D_ASSET)[0] + "_ref.npz"
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    want = jax_cpu_rel_l2(TURB3D_LOG)
    launches, results = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        beltrami_files(tmp, (7, 123), ref)
        for split in ("val", "test"):
            fq.reset_launches()
            res = evaluation_torch.main([
                "--params", TURB3D_ASSET, "--data_folder", tmp, "--split",
                split, "--eval_windows", "4", "--device", "cuda",
                "--save_path", os.path.join(tmp, f"pred_{split}.npz")])
            torch.cuda.synchronize()
            launches[split] = dict(fq.LAUNCHES)
            results[split] = res
    bad = []
    for split, res in results.items():
        got = res["rel_l2"]
        diffs = [abs(g - w) for g, w in zip(got, want[split])]
        say(f"turb3d {split} (windows {res['t0s']}): rel-L2 "
            + ", ".join(f"{g:.7f}" for g in got) + " vs JAX-CPU "
            + ", ".join(f"{w:.5f}" for w in want[split])
            + f"; max |diff| {max(diffs):.2e} (limit {TURB3D_REL_TOL:g}); "
              f"{res['steady_pts_per_s'] / 1e6:.3f}M pts/s over windows "
              f"2-4 on {card}; launches {launches[split]}")
        if len(got) != len(want[split]) or max(diffs) > TURB3D_REL_TOL:
            bad.append(split)
        if launches[split]["decode_blend_gather"] < 1:
            raise SystemExit(f"decode_blend_gather was not launched by the "
                             f"turb3d {split} eval")
    if bad:
        raise SystemExit(f"turb3d rel-L2 disagrees with the JAX-CPU log: "
                         f"{bad}")

    # Phase 13: val window 0 at the reference points, and a scattered
    # request encoded with cuDNN on and off.
    res = results["val"]
    out_shape = tuple(int(s) for s in ref["out_shape"])
    window0 = res["window0"]
    if tuple(window0.shape) != out_shape + (4,) or \
            not torch.isfinite(window0).all():
        raise SystemExit(f"turb3d window 0: {tuple(window0.shape)}")
    ref32, ref64 = ref["values"].astype(np.float64), ref["values_f64"]
    scale = float(np.abs(ref64).max())
    jax_need = atol_needed(ref32, ref64, scale)
    limit = REF_SLACK * jax_need
    idx = torch.from_numpy(ref["index"]).to(device)
    pts = torch.from_numpy(lattice_points(out_shape)[ref["index"]])
    unet, imnet = res["models"]
    lres0 = torch.as_tensor(res["lres0"], device=device)[None]
    cudnn = res["provenance"]["cudnn"]
    got = {"dense decode": window0.reshape(-1, 4)[idx]}
    fq.reset_launches()
    enabled = torch.backends.cudnn.enabled
    try:
        for on in (True, False):
            torch.backends.cudnn.enabled = on
            with torch.no_grad():
                got[f"scattered, cuDNN {'on' if on else 'off'}"] = \
                    fq.fused_query_local_implicit_grid(
                        imnet, unet(lres0), pts.to(device)[None],
                        gather="pregather")[0]
    finally:
        torch.backends.cudnn.enabled = enabled
    torch.cuda.synchronize()
    off_path = dict(fq.LAUNCHES)
    print(f"turb3d JAX-CPU reference: {len(idx)} lattice points of val "
          f"window 0, max |ref| {scale:.6g}; JAX f32 vs float64 needs atol "
          f"{jax_need:.3e} x max|ref| at rtol {REF_RTOL:g}; limit "
          f"{limit:.3e}; the eval ran with cuDNN {cudnn}", flush=True)
    failed = []
    for what, g in got.items():
        g = g.double().cpu().numpy()
        need32, need64 = atol_needed(g, ref32, scale), \
            atol_needed(g, ref64, scale)
        main = what == "dense decode" or what.endswith(
            "on" if cudnn else "off")
        print(f"  {what:20s} needs atol {need32:.3e} (vs f32) / "
              f"{need64:.3e} (vs float64)"
              + ("" if main else " (not the eval's setting)"), flush=True)
        if main and max(need32, need64) > limit:
            failed.append(what)
    say(f"turb3d scattered requests (gather='pregather', D=4) launches: "
        f"{off_path}")
    if off_path["decode_blend"] < 1 or failed:
        raise SystemExit(f"turb3d disagrees with the JAX-CPU reference: "
                         f"{failed}")
    return {"val": launches["val"], "test": launches["test"]}, off_path


def turb3d_train_path(card):
    with tempfile.TemporaryDirectory() as tmp:
        beltrami_files(tmp, (42, 100, 101, 7))
        log_dir = os.path.join(tmp, "log")
        flags = [
            "--device", "cuda", "--data_folder", tmp, "--train_data",
            "beltrami_s42.npz,beltrami_s100.npz,beltrami_s101.npz",
            "--eval_data", "beltrami_s7.npz", "--nt", "8", "--nz", "32",
            "--ny", "32", "--nx", "32", "--downsamp_t", "2",
            "--downsamp_xyz", "4", "--lat_dims", "64", "--unet_nf", "32",
            "--imnet_nf", "64", "--n_samp_pts_per_crop", "1024",
            "--batch_size_per_gpu", "4", "--inner_steps", "8",
            "--pseudo_epoch_size", "32", "--alpha_pde", "0.1",
            "--lr", "5e-3", "--lr_schedule", "cosine",
            "--pde_loss_type", "huber", "--seed", "42", "--log_dir", log_dir]
        return train_path(card, load_driver("turb3d", "train_torch.py"),
                          flags, log_dir, 4 * 1024, "turb3d")


def rb2d_real_windows(device, card):
    """Phase A: the port's rb2d eval path on the 8 exported real RB2D
    windows, point by point against JAX."""
    from space_time_pde_torch.bridge import load_exported
    from space_time_pde_torch.inference import make_dense_decoder
    from space_time_pde_torch.ops import fused_query as fq
    from space_time_pde_torch.utils.config import Config

    evaluation_torch = load_driver("rb2d", "evaluation_torch.py")
    with np.load(WINDOWS_REF) as z:
        ref = {k: z[k] for k in z.files}
    exported = load_exported(ASSET)
    out_shape = tuple(int(s) for s in ref["out_shape"])
    unet, imnet = evaluation_torch.build_models(
        Config.from_dict(exported["config"]), ref["lres"].shape[1:4],
        exported, device)
    decoder = make_dense_decoder(unet, imnet, out_shape)
    mean, std = ref["channel_mean"], ref["channel_std"]
    ref32 = ref["values"].astype(np.float64)
    ref64 = ref["values_f64"]
    scales = [float(np.abs(r).max()) for r in ref64]
    jax_need = max(atol_needed(a, b, s)
                   for a, b, s in zip(ref32, ref64, scales))
    limit = REF_SLACK * jax_need
    print(f"real RB2D windows: {len(ref['t0'])} x {ref['index'].shape[1]} "
          f"lattice points of {out_shape}; JAX f32 vs float64 needs atol "
          f"{jax_need:.3e} x max|ref| at rtol {REF_RTOL:g} (worst window); "
          f"limit {limit:.3e}", flush=True)
    fq.reset_launches()
    t0 = time.perf_counter()
    got = []
    for lres, idx in zip(ref["lres"], ref["index"]):
        got.append(decoder(lres).reshape(-1, 4)[torch.from_numpy(
            idx.astype(np.int64)).to(device)].double().cpu().numpy())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(fq.LAUNCHES)
    worst = 0.0
    rel = lambda v, truth: float(np.linalg.norm(v * std + mean - truth)
                                 / np.linalg.norm(truth))
    for w, g in enumerate(got):
        need32 = atol_needed(g, ref32[w], scales[w])
        need64 = atol_needed(g, ref64[w], scales[w])
        worst = max(worst, need32, need64)
        print(f"  {str(ref['split'][w]):4s} t0={int(ref['t0'][w]):3d}: "
              f"needs atol {need32:.3e} (vs JAX f32) / {need64:.3e} (vs "
              f"float64); pointwise rel-L2 vs truth: port "
              f"{rel(g, ref['truth'][w]):.6f}, JAX f32 "
              f"{rel(ref32[w], ref['truth'][w]):.6f}", flush=True)
    say(f"real RB2D windows through the eval path: worst atol {worst:.3e}"
        f" (limit {limit:.3e}); {len(got)} dense decodes in {secs:.2f} s "
        f"on {card}; launches {launches}")
    if launches["decode_blend_gather"] < 1:
        raise SystemExit("decode_blend_gather was not launched by the real-"
                         "window eval path")
    if worst > limit or not all(np.isfinite(g).all() for g in got):
        raise SystemExit("the port disagrees with JAX on real RB2D windows")
    return launches


def bf16_decode_vs_twin(name, kernel, plain, want64, bound_kw):
    """Phases G and L: a bf16 decode kernel (``kernel()``) against its
    bf16 twin (``plain()``) on N_CHECK points, per point within
    BF16_DIRECT of max |twin|, and against the f32 function in float64
    (``want64``) at most BF16_KERNEL_SLACK times as far as the twin;
    CUDA-event times against the bf16 bound (``bound_kw``: its kind and
    shape). Returns (the kernel's row, its output)."""
    scale = float(np.abs(want64).max())
    got, twin = kernel(), plain()
    torch.cuda.synchronize()
    max_abs = float((got - twin).abs().max())
    direct = max_abs / (BF16_DIRECT * float(twin.abs().max()))
    need_k = atol_needed(got.cpu().numpy(), want64, scale, RTOL)
    need_p = atol_needed(twin.cpu().numpy(), want64, scale, RTOL)
    p1, k1, k2, p2 = (cuda_ms(f, 5) for f in (plain, kernel, kernel, plain))
    b_ms, b_by = bound(math="bf16", **bound_kw)
    b32, _ = bound(**bound_kw)
    say(f"{name}: {N_CHECK} pts at D={bound_kw['dim']} C={bound_kw['c']} "
        f"nf={bound_kw['nf']}: vs its bf16 twin max abs err "
        f"{max_abs:.3e} = {direct:.3f} of the limit ({BF16_DIRECT:g} x "
        f"max|twin|); vs the float64 f32 function (max|ref| {scale:.4e}, "
        f"rtol {RTOL:g}) the kernel needs atol {need_k:.3e}, the bf16 twin "
        f"{need_p:.3e}, limit {BF16_KERNEL_SLACK * need_p:.3e}; kernel "
        f"{k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms, bound "
        f"{b_ms:.3f} ms ({b_by}, bf16 at {BF16_FLOPS / 1e12:g} TFLOP/s; "
        f"{100 * b_ms / ((k1 + k2) / 2):.1f}% of it)")
    if direct > 1.0 or need_k > BF16_KERNEL_SLACK * need_p or \
            not torch.isfinite(got).all():
        raise SystemExit(f"{name} disagrees with its twin (direct "
                         f"{direct:.3f} of the limit; vs float64 atol "
                         f"{need_k:.3e}, twin {need_p:.3e})")
    return ({"max_abs_err": max_abs, "ms": (k1 + k2) / 2,
             "plain_ms": (p1 + p2) / 2, "bound_ms": b_ms, "bound_by": b_by,
             "bound_f32_ms": b32, "atol_vs_f64": need_k,
             "plain_atol_vs_f64": need_p, "direct_share": direct}, got)


def bf16_kernel_vs_plain(imnet, device, spatial):
    """Phase G: the gather decode's bf16 instantiation against its bf16
    twin on phase 3's (10's) N_CHECK points and latent grid, the table
    rounded to bf16, by :func:`bf16_decode_vs_twin`."""
    from space_time_pde_torch.ops import fused_query as fq

    cell_flat, frac, table, packed, kw, want64, _, _ = decode_inputs(
        imnet, device, spatial)
    table16 = table.to(torch.bfloat16)
    kw["compute_dtype"] = torch.bfloat16
    return bf16_decode_vs_twin(
        "decode_blend_gather_bf16",
        lambda: fq.decode_blend_gather(table16, cell_flat, frac, packed,
                                       **kw),
        lambda: fq.decode_blend_gather_plain(table16, cell_flat, frac,
                                             packed, **kw),
        want64, dict(kind="decode_blend_gather", n=N_CHECK,
                     c=imnet.in_features, dim=len(spatial), nf=imnet.nf,
                     out=imnet.out_features, n_cells=table.shape[0]))[0]


def rb2d_real_windows_bf16(device, card):
    """Phase H: the 8 real RB2D windows of phase A decoded as the eval CLI
    does with ``--decode_dtype bf16``, point by point against JAX-CPU
    bf16 (``WINDOWS_BF16_REF``)."""
    from space_time_pde_torch.bridge import load_exported
    from space_time_pde_torch.inference import decode_dtype, \
        make_dense_decoder
    from space_time_pde_torch.ops import fused_query as fq
    from space_time_pde_torch.utils.config import Config

    evaluation_torch = load_driver("rb2d", "evaluation_torch.py")
    with np.load(WINDOWS_REF) as z:
        ref = {k: z[k] for k in z.files}
    with np.load(WINDOWS_BF16_REF) as z:
        ref16 = z["values_bf16"].astype(np.float64)
    exported = load_exported(ASSET)
    cfg = Config.from_dict(exported["config"])
    out_shape = tuple(int(s) for s in ref["out_shape"])
    unet, imnet = evaluation_torch.build_models(
        cfg, ref["lres"].shape[1:4], exported, device)
    decoder = make_dense_decoder(
        unet, imnet, out_shape,
        compute_dtype=decode_dtype("bf16", cfg.model.use_bf16))
    mean, std = ref["channel_mean"], ref["channel_std"]
    ref32, ref64 = ref["values"].astype(np.float64), ref["values_f64"]
    scales = [float(np.abs(r).max()) for r in ref64]
    jax_need = max(atol_needed(a, b, s, REF_RTOL)
                   for a, b, s in zip(ref16, ref64, scales))
    limit = BF16_SLACK * jax_need
    fq.reset_launches()
    t0 = time.perf_counter()
    got = []
    for lres, idx in zip(ref["lres"], ref["index"]):
        got.append(decoder(lres).reshape(-1, 4)[torch.from_numpy(
            idx.astype(np.int64)).to(device)].double().cpu().numpy())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(fq.LAUNCHES)
    rel = lambda v, truth: float(np.linalg.norm(v * std + mean - truth)
                                 / np.linalg.norm(truth))
    worst_direct = worst = 0.0
    for w, g in enumerate(got):
        direct = float(np.abs(g - ref16[w]).max()) / (
            BF16_DIRECT * float(np.abs(ref16[w]).max()))
        need = atol_needed(g, ref64[w], scales[w], REF_RTOL)
        worst_direct, worst = max(worst_direct, direct), max(worst, need)
        truth = ref["truth"][w]
        print(f"  {str(ref['split'][w]):4s} t0={int(ref['t0'][w]):3d}: vs "
              f"JAX bf16 {direct:.3f} of the direct limit; vs float64 needs "
              f"atol {need:.3e} (JAX bf16 "
              f"{atol_needed(ref16[w], ref64[w], scales[w], REF_RTOL):.3e})"
              f"; pointwise rel-L2 vs truth: port bf16 "
              f"{rel(g, truth):.6f}, JAX bf16 {rel(ref16[w], truth):.6f}, "
              f"JAX f32 {rel(ref32[w], truth):.6f}", flush=True)
    say(f"real RB2D windows, --decode_dtype bf16: worst {worst_direct:.3f} "
        f"of the direct limit ({BF16_DIRECT:g} x max|JAX bf16|), worst atol "
        f"vs float64 {worst:.3e} (limit {limit:.3e} = {BF16_SLACK:g} x JAX "
        f"bf16's worst {jax_need:.3e}); {len(got)} dense decodes in "
        f"{secs:.2f} s on {card}; launches {launches}")
    if launches["decode_blend_gather_bf16"] < 1:
        raise SystemExit("decode_blend_gather_bf16 was not launched by the "
                         "bf16 real-window eval path")
    if worst_direct > 1.0 or worst > limit or not all(
            np.isfinite(g).all() for g in got):
        raise SystemExit("the port's bf16 eval disagrees with JAX bf16 on "
                         "real RB2D windows")
    return launches


def bf16_step_vs_jax(device, pde_bf16=False):
    """Phase I (M): phase 8's flagship step under the bf16 policy (with
    ``pde_bf16``, the bf16 jet kernels too), held by phase 8's rule
    (``check_step``) to JAX-CPU bf16 (``BF16_STEP_REF``;
    ``BF16_PDE_STEP_REF``: its loss terms at BF16_LOSS_RTOL, its
    distances from phase 8's float64 leaves), and every leaf's rel-L2
    distance from float64 within STEP_SLACK times JAX bf16's for that
    leaf."""
    from space_time_pde_torch.ops import fused_jet as fj
    from space_time_pde_torch.ops import fused_query as fq
    from space_time_pde_torch.train import make_loss_fn, make_train_step

    cfg, pde, opt, state, batch, ref, _ = reference_step(
        STEP_REF, device, use_bf16=True, pde_bf16=pde_bf16)
    with np.load(BF16_PDE_STEP_REF if pde_bf16 else BF16_STEP_REF,
                 allow_pickle=False) as z:
        ref16 = {k: z[k] for k in z.files}
    spec16 = json.loads(str(ref16["spec"]))
    step_fn = make_train_step(
        make_loss_fn(cfg, state.unet, state.imnet, pde), opt)
    fj.reset_launches()
    fq.reset_launches()
    state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    launches = {**fj.LAUNCHES, **fq.LAUNCHES}
    jets, other = ("jet_fwd", "jet_bwd"), ("jet_fwd_bf16", "jet_bwd_bf16")
    if pde_bf16:
        jets, other = other, jets
    if min(launches[k] for k in jets) < 1 or max(launches[k]
                                                 for k in other):
        raise SystemExit(f"the bf16 step did not run the {jets} kernels "
                         f"alone: {launches}")
    # Phase 8's float64 leaves and scales, JAX bf16's terms and needs.
    held = {k: v for k, v in ref.items()
            if not k.startswith(("need/", "relnorm/"))}
    held.update({k: v for k, v in ref16.items() if k != "spec"})
    bad = check_step(
        state, metrics, held, dict(spec16, terms32=spec16["terms_bf16"]),
        f"convolutions without cuDNN, bf16{', jet bf16' * pde_bf16}; "
        f"launches {launches}",
        loss_rtol=BF16_LOSS_RTOL, label="JAX bf16", leaf_norms=True,
        term_slack=STEP_SLACK if pde_bf16 else None)
    if bad:
        raise SystemExit(f"the bf16 training step disagrees with JAX: {bad}")


def bf16_train_clis(card, pde_bf16=False):
    """Both train CLIs with ``--use_bf16 true`` (phase J; with
    ``pde_bf16`` also ``--pde_bf16 true``, phase N), phases 9's and 15's
    flags, 2 epochs x 8 steps: finite losses, s/step of epoch 1, and the
    path's launches of each, which must take one jet instantiation alone
    (f32 under ``--use_bf16`` alone, bf16 with ``--pde_bf16``) and the
    bf16 gather decode (the epoch eval)."""
    from space_time_pde_torch.ops import fused_jet as fj
    from space_time_pde_torch.ops import fused_query as fq

    paths = {}
    extra = ["--use_bf16", "true"] + ["--pde_bf16", "true"] * pde_bf16
    jets, other = ("jet_fwd", "jet_bwd"), ("jet_fwd_bf16", "jet_bwd_bf16")
    if pde_bf16:
        jets, other = other, jets
    policy = f"policy=bf16 (jet {'bf16' if pde_bf16 else 'f32'})"

    def train(name, driver, flags, points):
        fj.reset_launches()
        fq.reset_launches()
        res = driver.main(flags + extra + ["--epochs", "2"])
        torch.cuda.synchronize()
        paths[name] = {**fj.LAUNCHES, **fq.LAUNCHES}
        losses = [e[k] for e in res["epochs"] for k in e
                  if k.endswith("loss")]
        sps = res["epochs"][1]["sec_per_step"]
        say(f"{name}: {' '.join(extra)}, {res['step']} steps, "
            f"{sps:.4f} s/step in epoch 1 ({points / sps:.0f} points/s) on "
            f"{card}; losses " + ", ".join(
                f"{e['loss']:.5f}" for e in res["epochs"])
            + f"; launches {paths[name]}")
        if res["step"] != 16 or not np.isfinite(losses).all() or \
                policy not in res["provenance"]:
            raise SystemExit(f"{name}: the bf16 training run failed")
        for k in jets + ("decode_blend_gather_bf16",):
            if paths[name][k] < 1:
                raise SystemExit(f"{k} was not launched by {name}")
        for k in other:
            if paths[name][k]:
                raise SystemExit(f"{name} launched {k}")

    tag = "pde_bf16" if pde_bf16 else "bf16"
    with tempfile.TemporaryDirectory() as tmp:
        taylor_green_folder(tmp)
        train(f"rb2d_{tag}_train", load_driver("rb2d", "train_torch.py"),
              rb2d_flags(tmp, os.path.join(tmp, "log")), 8 * 1024)
    with tempfile.TemporaryDirectory() as tmp:
        beltrami_files(tmp, (42, 100, 101, 7))
        train(f"turb3d_{tag}_train", load_driver("turb3d", "train_torch.py"),
              turb3d_flags(tmp, os.path.join(tmp, "log")), 4 * 1024)
    return paths


def bf16_clis(card):
    """Phase J: both train CLIs with ``--use_bf16 true`` (2 epochs x 8
    steps; finite, s/step of epoch 1) and both eval CLIs with
    ``--decode_dtype bf16`` at full width (points/s); each path's launch
    counts."""
    from space_time_pde_torch.data import save_npz, taylor_green_fields
    from space_time_pde_torch.ops import fused_query as fq

    paths = bf16_train_clis(card)

    def evaluate(name, driver, flags):
        fq.reset_launches()
        res = driver.main(flags + ["--decode_dtype", "bf16", "--device",
                                   "cuda"])
        torch.cuda.synchronize()
        paths[name] = dict(fq.LAUNCHES)
        say(f"{name}: --decode_dtype bf16, "
            f"{res['steady_pts_per_s'] / 1e6:.3f}M pts/s over windows 2+ "
            f"on {card}; rel-L2 " + ", ".join(f"{r:.5f}" for r in
                                              res["rel_l2"])
            + f"; provenance dtype {res['provenance']['compute_dtype']}; "
              f"launches {paths[name]}")
        if paths[name]["decode_blend_gather_bf16"] < 1 or \
                paths[name]["decode_blend_gather"] or \
                not np.isfinite(res["rel_l2"]).all():
            raise SystemExit(f"{name}: the bf16 eval did not decode through "
                             "the bf16 kernel alone")
        return res

    with tempfile.TemporaryDirectory() as tmp:
        save_npz(os.path.join(tmp, "tg.npz"),
                 taylor_green_fields(nt=32, nz=128, nx=512))
        evaluate("rb2d_eval_bf16", load_driver("rb2d", "evaluation_torch.py"),
                 ["--params", ASSET, "--data_folder", tmp, "--eval_data",
                  "tg.npz", "--eval_windows", "3",
                  "--save_path", os.path.join(tmp, "pred.npz")])
    with tempfile.TemporaryDirectory() as tmp:
        beltrami_files(tmp, (7,))
        evaluate("turb3d_eval_bf16",
                 load_driver("turb3d", "evaluation_torch.py"),
                 ["--params", TURB3D_ASSET, "--data_folder", tmp, "--split",
                  "val", "--eval_windows", "4",
                  "--save_path", os.path.join(tmp, "pred.npz")])
    return paths


def _bf16_held(what, got, twin, ref64, masked, flips_ok):
    """Phase K's rules on one quantity: direct, within BF16_DIRECT of max
    |twin| of the bf16 twin; distance, the atol it needs against the f32
    function in float64 (rtol JET_RTOL) at most BF16_KERNEL_SLACK times
    the twin's (floor JET_FLOOR). Where the kernel took a branch near 0
    that the twin did not (``flips_ok``), both on the kernel's own
    branches (``masked``: the twin and the float64 function run on them).
    Prints the readings; raises when neither holds; returns the max abs
    error against the twin."""
    def readings(t, r64):
        g, t, r64 = (a.detach().double().cpu().numpy()
                     for a in (got, t, r64))
        scale = float(np.abs(r64).max())
        need_k = atol_needed(g, r64, scale, JET_RTOL)
        need_t = atol_needed(t, r64, scale, JET_RTOL)
        direct = float(np.abs(g - t).max()) / (
            BF16_DIRECT * float(np.abs(t).max()))
        limit = max(BF16_KERNEL_SLACK * need_t, JET_FLOOR)
        return direct, need_k, need_t, limit, direct <= 1.0 and \
            need_k <= limit

    finite = bool(torch.isfinite(got).all())
    direct, need_k, need_t, limit, ok = readings(twin, ref64)
    ok &= finite
    note = "ok" if ok else "FAIL"
    if not ok and flips_ok and finite:
        dm, km, tm, lm, ok = readings(*masked)
        note = (f"branch flips near 0; on the kernel's branches direct "
                f"{dm:.3f}, needs {km:.3e}, twin {tm:.3e}, limit {lm:.3e} "
                + ("ok" if ok else "FAIL"))
    print(f"  {what:12s} direct {direct:.3f} of the limit; vs float64 the "
          f"kernel needs atol {need_k:.3e}, bf16 twin {need_t:.3e}; limit "
          f"{limit:.3e} {note}", flush=True)
    if not ok:
        raise SystemExit(f"{what}: bf16 jet kernel disagrees with its twin")
    return float((got.double() - twin.double()).abs().max())


def bf16_jet_vs_plain(imnet, device, spatial, n):
    """Phase K: both bf16 jet kernels against their bf16 twins on phase 4's
    (11's) n points and latent grid, the rows rounded to bf16 and the
    weights packed at bf16: the forward's blocks (against
    ``jet_fwd_plain`` at bf16) and the backward's d feats2 and 9 gradients
    for phase 4's cotangent (against ``jet_bwd_bf16_plain``), by
    :func:`_bf16_held`; the reference is the f32 function (phase 4's
    twin) in float64. CUDA-event times against the bf16 bound."""
    from space_time_pde_torch.ops import _build
    from space_time_pde_torch.ops import fused_jet as fj
    from space_time_pde_torch.ops import fused_query as fq

    dim, bf = len(spatial), torch.bfloat16
    feats2, frac, packed, ybar, kw = jet_inputs(imnet, device, spatial, n)
    with torch.no_grad():
        p16 = fq.pack_imnet_params(imnet, dtype=bf)
    f16 = feats2.to(bf)
    kw16 = dict(kw, compute_dtype=bf)
    p64 = {k: v.double() for k, v in packed.items()}
    f64, fr64 = feats2.double(), frac.double()

    out, ws = fj.jet_fwd(f16, frac, p16, **kw16)
    torch.cuda.synchronize()
    km = fj.workspace_masks(ws, n, dim, imnet.nf, compute_dtype=bf)
    twin, pres = fj.jet_fwd_plain(f16, frac, p16, return_pre=True, **kw16)
    names = (["value"] + [f"jac_{a}" for a in range(dim)]
             + [f"hess_{a}{b}" for a, b in fj.tri_pairs(dim)])
    print(f"jet_fwd_bf16: {n} pts at D={dim} C={imnet.in_features} "
          f"nf={imnet.nf} vs the bf16 twin (direct {BF16_DIRECT:g} of "
          f"max|twin|) and the f32 function in float64 (rtol "
          f"{JET_RTOL:g}, {BF16_KERNEL_SLACK:g}x the twin's atol):",
          flush=True)
    flips_ok = _flips_near_zero(km, pres, BF16_FLIP_REL,
                                "bf16 kernel vs bf16 twin")
    del pres
    want64 = fj.jet_fwd_plain(f64, fr64, p64, **kw)
    twin_m = fj.jet_fwd_plain(f16, frac, p16, masks=km, **kw16)
    want64_m = fj.jet_fwd_plain(f64, fr64, p64, masks=km, **kw)
    fwd_err = max(_bf16_held(nm, out[:, i], twin[:, i], want64[:, i],
                             (twin_m[:, i], want64_m[:, i]), flips_ok)
                  for i, nm in enumerate(names))
    del want64, twin_m, want64_m

    y64 = ybar.double()
    dfeats, grads = fj.jet_bwd(f16, frac, p16, ws, ybar, **kw16)
    torch.cuda.synchronize()
    d16, g16 = fj.jet_bwd_bf16_plain(f16, frac, p16, ybar, **kw)
    d64, g64 = fj.jet_bwd_plain(f64, fr64, p64, y64, **kw)
    d16m, g16m = fj.jet_bwd_bf16_plain(f16, frac, p16, ybar, masks=km, **kw)
    d64m, g64m = fj.jet_bwd_plain(f64, fr64, p64, y64, masks=km, **kw)
    print("jet_bwd_bf16: d feats2 and the packed-parameter gradients (f32 "
          "sums) for phase 4's cotangent:", flush=True)
    bwd_err = _bf16_held("dfeats2", dfeats, d16, d64, (d16m, d64m),
                         flips_ok)
    for name in grads:
        bwd_err = max(bwd_err, _bf16_held(
            name, grads[name], g16[name], g64[name],
            (g16m[name], g64m[name]), flips_ok))
    del d64, g64, d16m, g16m, d64m, g64m, km

    lib = _build.load("fused_jet_bf16")
    shape = (n, feats2.shape[-1], dim, imnet.nf, packed["w5"].shape[-1])
    say(f"bf16 jet workspace at D={dim}, {n} pts: forward "
        f"{lib.stpde_jet_fwd_bf16_workspace(*shape)} bytes, backward "
        f"scratch {lib.stpde_jet_bwd_bf16_workspace(*shape)} bytes")
    fwd_k = lambda: fj.jet_fwd(f16, frac, p16, **kw16)
    fwd_p = lambda: fj.jet_fwd_plain(f16, frac, p16, **kw16)
    bwd_k = lambda: fj.jet_bwd(f16, frac, p16, ws, ybar, **kw16)
    bwd_p = lambda: fj.jet_bwd_bf16_plain(f16, frac, p16, ybar, **kw)
    rows = {}
    for kind, kernel, plain, err in (("jet_fwd", fwd_k, fwd_p, fwd_err),
                                     ("jet_bwd", bwd_k, bwd_p, bwd_err)):
        p1, k1, k2, p2 = (cuda_ms(f, 3) for f in (plain, kernel, kernel,
                                                   plain))
        shape = dict(n=n, c=imnet.in_features, dim=dim, nf=imnet.nf,
                     out=imnet.out_features)
        b_ms, b_by = bound(kind, math="bf16", **shape)
        b32, _ = bound(kind, **shape)
        ms = (k1 + k2) / 2
        rows[kind + "_bf16"] = {
            "max_abs_err": err, "ms": ms, "plain_ms": (p1 + p2) / 2,
            "bound_ms": b_ms, "bound_by": b_by, "bound_f32_ms": b32}
        say(f"{kind}_bf16 (D={dim}, {n} pts): max abs err vs bf16 twin "
            f"{err:.3e}; kernel {k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/"
            f"{p2:.3f} ms, bound {b_ms:.3f} ms ({b_by}, bf16 at "
            f"{BF16_FLOPS / 1e12:g} TFLOP/s; {100 * b_ms / ms:.1f}% of it), "
            f"f32 FFMA {b32:.3f} ms")
    return rows


def bf16_pregather_vs_plain(imnet, device, spatial):
    """Phase L: the pre-gathered decode's bf16 instantiation
    (``decode_blend`` at bf16, ``stpde_decode_blend_bf16``) against its
    bf16 twin on phase 3's (10's) N_CHECK points and latent grid by phase
    G's rule, then one scattered-point request through
    ``fused_query_local_implicit_grid(gather="pregather")`` at bf16 on
    the same grid and points (counted alone; it must launch that kernel
    once and give its result bit for bit). Returns (row, launches)."""
    from space_time_pde_torch.ops import fused_query as fq

    dim, bf = len(spatial), torch.bfloat16
    cell_flat, frac, table, packed, kw, want64, grid, pts = decode_inputs(
        imnet, device, spatial)
    feats2 = table.to(bf)[cell_flat.long()].reshape(
        -1, imnet.in_features).contiguous()
    kw = dict(kw, n_corners=2 ** dim, compute_dtype=bf)
    row, got = bf16_decode_vs_twin(
        "decode_blend_bf16",
        lambda: fq.decode_blend(feats2, frac, packed, **kw),
        lambda: fq.decode_blend_plain(feats2, frac, packed, **kw), want64,
        dict(kind="decode_blend", n=N_CHECK, c=imnet.in_features, dim=dim,
             nf=imnet.nf, out=imnet.out_features))
    fq.reset_launches()
    req = fq.fused_query_local_implicit_grid(
        imnet, grid[None], pts[None], gather="pregather",
        compute_dtype=bf)[0]
    torch.cuda.synchronize()
    launches = dict(fq.LAUNCHES)
    same = torch.equal(req, got)
    say(f"scattered-point request at bf16 ({N_CHECK} points, D={dim}, "
        f"gather='pregather', off the main paths): launches {launches}; "
        f"equal to the kernel's result bit for bit: {same}")
    if launches["decode_blend_bf16"] != 1 or sum(launches.values()) != 1 \
            or not same:
        raise SystemExit("the bf16 scattered-point request did not run "
                         "through decode_blend_bf16")
    return row, launches


def resume_from_jax(device, card):
    """Phase C: the flagship's exported JAX state restored bit for bit,
    one resumed step against JAX's, then the train CLI resumed from the
    export."""
    from space_time_pde_torch.bridge import (
        OPT_COUNTERS, load_exported, optimizer_state_from_flax,
        state_dict_from_flax)
    from space_time_pde_torch.ops import fused_jet as fj
    from space_time_pde_torch.ops import fused_query as fq
    from space_time_pde_torch.physics import get_pde_layer
    from space_time_pde_torch.train import (
        build_models, init_state, make_loss_fn, make_optimizer,
        make_train_step)
    from space_time_pde_torch.utils.checkpoint import restore_exported
    from space_time_pde_torch.utils.config import Config

    exported = load_exported(OPT_ASSET)
    with np.load(RESUME_REF, allow_pickle=False) as z:
        ref = {k: z[k] for k in z.files}
    spec = json.loads(str(ref["spec"]))
    cfg = Config.from_dict(exported["config"])
    cfg.train.epochs = RESUME_EPOCHS
    spe = cfg.train.pseudo_epoch_size // cfg.train.batch_size_per_gpu
    unet, imnet = build_models(cfg, ref["lres"].shape[1:4], device)
    opt = make_optimizer(cfg, spe)
    state, _ = restore_exported(init_state(cfg.train.seed, unet, imnet, opt),
                                OPT_ASSET)
    # Bit for bit: every restored tensor and counter.
    modules = {"unet": unet, "imnet": imnet}
    want_opt = optimizer_state_from_flax(exported["opt_state"], modules)
    mismatched = [k for k in OPT_COUNTERS
                  if state.opt_state[k] != want_opt[k]]
    n_tensors = 0
    for name, module in modules.items():
        sd = state_dict_from_flax(module, exported["params"][name],
                                  exported["batch_stats"])
        for k, t in module.state_dict().items():
            n_tensors += 1
            if not torch.equal(t.cpu(), sd[k]):
                mismatched.append(f"{name}.{k}")
    for m in ("mu", "nu"):
        for k, v in state.opt_state[m].items():
            n_tensors += 1
            if not torch.equal(v.cpu(), want_opt[m][k]):
                mismatched.append(f"{m} {k}")
    counters = {k: state.opt_state[k] for k in OPT_COUNTERS}
    say(f"resumed the exported JAX run at step {state.step}: {n_tensors} "
        f"tensors and the counters {counters} equal the export bit for "
        f"bit: {not mismatched}; lr at count "
        f"{state.opt_state['count']} with --epochs {RESUME_EPOCHS}: "
        f"{float(opt.learning_rate(state.opt_state['count'])):.6g} (JAX "
        f"{spec['lr']:.6g})")
    if mismatched or state.step != spec["step"]:
        raise SystemExit(f"the restored JAX state differs: {mismatched[:5]}")

    ext = [float(e) for e in ref["coord_extents"]]
    pde = get_pde_layer(cfg.physics.pde_system, mean=ref["channel_mean"],
                        std=ref["channel_std"], t_crop=ext[0],
                        z_crop=ext[1], x_crop=ext[2],
                        rayleigh=cfg.physics.rayleigh,
                        prandtl=cfg.physics.prandtl)
    batch = {k: torch.from_numpy(ref[k]).to(device)
             for k in ("lres", "point_coord", "point_value")}
    before = {"p": {k: p.detach().clone() for k, p in state.params().items()},
              "mu": {k: v.clone() for k, v in state.opt_state["mu"].items()},
              "nu": {k: v.clone() for k, v in state.opt_state["nu"].items()}}
    state, metrics = make_train_step(make_loss_fn(cfg, unet, imnet, pde),
                                     opt)(state, batch)
    torch.cuda.synchronize()
    after = {"p": {k: p.detach() for k, p in state.params().items()},
             "mu": state.opt_state["mu"], "nu": state.opt_state["nu"]}
    terms32, bad, margins = spec["terms32"], [], {}
    for k, want in terms32.items():
        got = float(metrics[k])
        rel = abs(got - want) / max(abs(want), 1e-30)
        margins[k] = rel / LOSS_RTOL
        print(f"  {k:18s} port {got:.8g}  JAX f32 {want:.8g}  float64 "
              f"{spec['terms64'][k]:.8g}  rel diff vs JAX {rel:.2e}",
              flush=True)
        if abs(got - want) > LOSS_RTOL * max(abs(want),
                                             1e-6 * terms32["loss"]):
            bad.append(k)
    worst_norm = {}
    for what, q in (("dp", "p"), ("dmu", "mu"), ("dnu", "nu")):
        for k in after[q]:
            want = float(ref[f"norm/{what}/{k}"])
            got = float(torch.linalg.vector_norm(
                (after[q][k] - before[q][k]).double()))
            r = abs(got - want) / max(want, 1e-30)
            if r > worst_norm.get(what, (0.0, ""))[0]:
                worst_norm[what] = (r, k)
            if r > DNORM_RTOL:
                bad.append(f"{what} {k}")
    dp_need = max(float(ref[k]) for k in ref if k.startswith("dp_need/"))
    dp_limit = STEP_SLACK * dp_need
    dp_worst = (0.0, "")
    for k in (k[3:] for k in ref if k.startswith("dp/")):
        want = ref[f"dp/{k}"].astype(np.float64)
        got = (after["p"][k] - before["p"][k]).double().cpu().numpy()
        need = atol_needed(got, want, float(np.abs(want).max()), DP_RTOL)
        dp_worst = max(dp_worst, (need, k))
        if need > dp_limit:
            bad.append(f"dp {k}")
    say("resumed step vs JAX: loss terms and grad norm within "
        + ", ".join(f"{k} {v:.2f}" for k, v in margins.items())
        + f" of LOSS_RTOL {LOSS_RTOL:g}; worst relative norm difference "
        + ", ".join(f"{w} {r:.2e} ({k})" for w, (r, k) in worst_norm.items())
        + f" (limit {DNORM_RTOL:g}); ImNet dp worst atol {dp_worst[0]:.3e}"
        f" ({dp_worst[1]}) at rtol {DP_RTOL:g} (limit {dp_limit:.3e} = "
        f"{STEP_SLACK:g} x JAX f32's own {dp_need:.3e})")
    if bad:
        raise SystemExit(f"the resumed step disagrees with JAX: {bad[:8]}")
    del before, after, state
    torch.cuda.empty_cache()

    # The train CLI resumed from the export, one epoch. The RB2D-trained
    # model is far off its data on Taylor–Green (a loss near 1.7e6, past
    # the cliff detector's absolute threshold of 1e6), so the detector
    # is off for this run.
    train_torch = load_driver("rb2d", "train_torch.py")
    with tempfile.TemporaryDirectory() as tmp:
        taylor_green_folder(tmp)
        fj.reset_launches()
        fq.reset_launches()
        res = train_torch.main(rb2d_flags(tmp, os.path.join(tmp, "log")) + [
            "--resume", OPT_ASSET, "--epochs", str(RESUME_EPOCHS),
            "--run_epochs", "1", "--cliff_recovery", "false"])
        torch.cuda.synchronize()
        launches = {**fj.LAUNCHES, **fq.LAUNCHES}
    epochs = res["epochs"]
    say(f"train CLI resumed from the export: started at step "
        f"{spec['step']} (epoch {res['start_epoch']}), ended at step "
        f"{res['step']}; losses "
        + ", ".join(f"{e['loss']:.5f}" for e in epochs)
        + f"; {epochs[-1]['sec_per_step']:.4f} s/step on {card}; launches "
        f"{launches}")
    if res["step"] != spec["step"] + 8 or len(epochs) != 1 or not all(
            np.isfinite(e["loss"]) for e in epochs):
        raise SystemExit("the train CLI did not resume the JAX run")
    for name in ("jet_fwd", "jet_bwd"):
        if launches[name] < 1:
            raise SystemExit(f"{name} was not launched by the resumed run")
    return launches


# ------------------------------------------------------------------------
# Phases D-F: the parallel paths. Their ranks are processes of this
# script (``--worker``), started as torchrun starts ranks (RANK,
# WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, a localhost rendezvous); with
# more ranks than cards they share the cards over gloo.

PARALLEL_TIMEOUT = 420          # seconds a world may take


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(world, tmp, phases, what):
    """Run ``phases`` on ``world`` ranks of this script; returns each
    rank's results. Echoes rank 0's output; a failed or late rank stops
    every rank and exits non-zero."""
    job = os.path.join(tmp, f"job_{what}")
    os.makedirs(job, exist_ok=True)
    with open(os.path.join(job, "phases.json"), "w") as f:
        json.dump(phases, f)
    port = free_port()
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 8)
                                           // world)))
        logs.append(os.path.join(job, f"rank{r}.log"))
        with open(logs[-1], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-u", os.path.abspath(__file__),
                 "--worker", job], env=env, stdout=out,
                stderr=subprocess.STDOUT, cwd=ROOT))
    deadline = time.time() + PARALLEL_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.time() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(logs[0]) as f:
        print(f.read(), end="", flush=True)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad[:2]:
            with open(logs[r]) as f:
                print(f"--- rank {r} ---\n{f.read()[-4000:]}", flush=True)
        raise SystemExit(f"{what}: rank(s) {bad} of {world} failed or "
                         f"outlived {PARALLEL_TIMEOUT} s")
    out = []
    for r in range(world):
        with open(os.path.join(job, f"result{r}.json")) as f:
            out.append(json.load(f))
    return out


def worker(job):
    """One rank of :func:`spawn_world`: join, run the phases, write the
    results (launch counts are this rank's)."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from space_time_pde_torch.parallel.dp import init_multihost, rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = "cuda" if torch.cuda.is_available() else "cpu"
    rank, world = init_multihost(kind)
    device = rank_device(kind)
    with open(os.path.join(job, "phases.json")) as f:
        phases = json.load(f)
    results = {}
    for ph in phases:
        t0 = time.perf_counter()
        run = {"step": sharded_step_vs_jax, "cli": cli_runs}[ph["kind"]]
        results[ph["name"]] = run(device, rank, ph)
        results[ph["name"]]["seconds"] = time.perf_counter() - t0
    with open(os.path.join(job, f"result{rank}.json"), "w") as f:
        json.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


def _launches():
    from space_time_pde_torch.ops import fused_jet as fj
    from space_time_pde_torch.ops import fused_query as fq

    return {**fj.LAUNCHES, **fq.LAUNCHES}


def _reset_launches():
    from space_time_pde_torch.ops import fused_jet as fj
    from space_time_pde_torch.ops import fused_query as fq

    fj.reset_launches()
    fq.reset_launches()


def sharded_step_vs_jax(device, rank, ph):
    """Phases D and E, one rank: a reference file's step laid out over
    the world (``layout``: "dp" on the 2 x 2 mesh's data groups, or
    "dp_sp"), its all-reduced gradients held to phase 8's rule."""
    import torch.distributed as dist

    from space_time_pde_torch.models.unet3d import UNet3d, set_norm_group
    from space_time_pde_torch.parallel.dp import (
        batch_block, make_dp_train_step, make_mesh)
    from space_time_pde_torch.parallel.dp_sp import (
        dp_sp_block, make_dp_sp_batch, make_dp_sp_loss_fn,
        make_dp_sp_train_step)
    from space_time_pde_torch.train import make_loss_fn

    cfg, pde, opt, state, batch, ref, spec = reference_step(
        os.path.join(ROOT, ph["ref"]), device)
    unet, imnet = state.unet, state.imnet
    world = dist.get_world_size()
    mesh = make_mesh(world // ph["n_space"], ph["n_space"])
    keys = ("lres", "point_coord", "point_value")
    enc = unet
    if ph["layout"] == "dp":
        if cfg.model.norm == "batch":
            set_norm_group(unet, mesh.data_group)
        step = make_dp_train_step(make_loss_fn(cfg, unet, imnet, pde), opt,
                                  mesh)
        block = batch_block(batch, mesh.data_index, mesh.n_data)
    else:
        if ph["sharded"]:
            from space_time_pde_torch.parallel.sharded_unet import (
                ShardedUNet3d)
            from space_time_pde_torch.parallel.sharded_unet4d import (
                ShardedUNet4d)
            cls = ShardedUNet3d if isinstance(unet, UNet3d) else ShardedUNet4d
            enc = cls.from_plain(unet, mesh)
        step = make_dp_sp_train_step(
            make_dp_sp_loss_fn(cfg, enc, imnet, pde, mesh, ph["sharded"]),
            opt, mesh)
        host = make_dp_sp_batch({k: ref[k] for k in keys}, mesh.n_space,
                                ref["lres"].shape[-2])
        block = {k: torch.from_numpy(v).to(device) for k, v in
                 dp_sp_block(host, mesh, ph["sharded"]).items()}
    masks = []
    record_branches(enc, masks, cfg.model.negative_slope)
    # The weights the step starts from (it updates them in place).
    start = {name: {k: v.detach().clone() for k, v in m.state_dict().items()}
             for name, m in (("unet", unet), ("imnet", imnet))}
    _reset_launches()
    state, metrics = step(state, block)
    torch.cuda.synchronize()
    launches = _launches()
    if rank == 0:
        say(f"{ph['name']}: {ph['what']} (world {world}, data "
            f"{mesh.n_data} x space {mesh.n_space}); the all-reduced "
            f"gradients vs the JAX-CPU reference ({ph['ref']}):")
    bad = check_step(state, metrics, ref, spec,
                     f"rank 0's launches {launches}", verbose=rank == 0)
    terms = [k for k in bad if "." not in k]
    if bad and not terms:
        bad = flip_clause(state, metrics, ref, spec, cfg, pde, batch, mesh,
                          ph, masks, rank, start)
    if bad or launches["jet_fwd"] < 1 or launches["jet_bwd"] < 1:
        raise SystemExit(f"{ph['name']}: the step disagrees with JAX or "
                         f"ran no jet kernel: {bad[:8]}; {launches}")
    coll = collective_ms(state, enc, mesh, ph, cfg, block)
    if rank == 0:
        say(f"{ph['name']}: collectives a step: " + ", ".join(
            f"{k} {n} x {ms:.3f} ms" for k, (n, ms) in coll.items())
            + f" = {sum(n * ms for n, ms in coll.values()):.1f} ms (host "
              "clock to a synchronize, mean of 5; gloo, a shared card)")
    return {"launches": launches, "collectives": coll}


def collective_ms(state, enc, mesh, ph, cfg, block, reps=5):
    """{collective: (calls a step, ms a call)} of the step's layout: the
    gradients' all-reduce (one flat buffer), the latent's halo exchange
    (forward and backward), the halo convs' exchanges and the sharded
    GroupNorms' / synced BatchNorms' all-reduces (forward and backward);
    each timed on a tensor of its size."""
    import torch.distributed as dist

    from space_time_pde_torch.models.unet3d import BatchNorm
    from space_time_pde_torch.parallel.collectives import exchange
    from space_time_pde_torch.parallel.halo_conv import (
        HaloConv3d, ShardedGroupNorm)

    def sync():
        if block["lres"].is_cuda:
            torch.cuda.synchronize()

    def timed(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) / reps * 1e3

    flat = torch.cat([p.grad.reshape(-1) for p in state.params().values()])
    group = mesh.world_group if ph["layout"] == "dp_sp" else mesh.data_group
    out = {"gradient all-reduce": (1, timed(
        lambda: dist.all_reduce(flat.clone(), group=group)))}
    if ph["layout"] == "dp_sp":
        lres = block["lres"]
        plane = torch.zeros(*lres.shape[:-2], 1, cfg.model.lat_dims,
                            device=lres.device)
        ms = timed(lambda: exchange(plane, None, mesh.space_ranks,
                                    mesh.space_index, mesh.space_group))
        out["latent halo"] = (2, ms)
        halo = [m for m in enc.modules() if isinstance(m, HaloConv3d)]
        if halo:
            x = torch.zeros(*lres.shape[:-2], 1, cfg.model.unet_nf,
                            device=lres.device)
            out["conv halos"] = (2 * len(halo), timed(
                lambda: exchange(x, x, mesh.space_ranks, mesh.space_index,
                                 mesh.space_group)))
    norms = [m for m in enc.modules()
             if isinstance(m, ShardedGroupNorm)
             or (isinstance(m, BatchNorm) and m.group is not None)]
    if norms:
        stats = torch.zeros(2, 8, 8, device=flat.device)
        g = mesh.space_group if isinstance(norms[0], ShardedGroupNorm) \
            else norms[0].group
        out["norm all-reduces"] = (2 * len(norms), timed(
            lambda: dist.all_reduce(stats.clone(), group=g)))
    return out


def record_branches(encoder, store, slope):
    """Record every LeakyReLU branch the encoder takes (``x > 0``, the
    branch of its backward), in call order, on the CPU."""
    import torch.nn.functional as F

    for m in encoder.modules():
        if callable(getattr(m, "act", None)):
            m.act = lambda x: (store.append((x > 0).detach().cpu()),
                               F.leaky_relu(x, slope))[1]


def float64_step(cfg, weights, pde, batch, masks=None):
    """The step's gradients recomputed in float64 on the card with the
    plain modules (``weights``: their state dicts, ``{"unet", "imnet"}``)
    and the plain analytic jet (``pde_derivs = jet_jnp``), on the whole
    batch: ({leaf: gradient}, the encoder's pre-activations in call
    order). ``masks``: the encoder's LeakyReLU branches to take (in call
    order) in place of float64's own."""
    import torch.nn.functional as F

    from space_time_pde_torch.train import build_models, make_loss_fn
    from space_time_pde_torch.utils.config import Config

    c64 = Config.from_dict(cfg.to_dict())
    c64.train.pde_derivs = "jet_jnp"
    device = batch["lres"].device
    unet, imnet = build_models(c64, tuple(batch["lres"].shape[1:-1]), device)
    unet.load_state_dict(weights["unet"])
    imnet.load_state_dict(weights["imnet"])
    unet.double(), imnet.double()
    slope = cfg.model.negative_slope
    pres, it = [], iter(masks or ())

    def act(x):
        pres.append(x.detach().cpu())
        if masks is None:
            return F.leaky_relu(x, slope)
        return torch.where(next(it).to(x.device), x, slope * x)

    for m in unet.modules():
        if callable(getattr(m, "act", None)):
            m.act = act
    loss, _ = make_loss_fn(c64, unet, imnet, pde)(
        {k: v.double() for k, v in batch.items()})
    loss.backward()
    grads = {f"{name}.{k}": p.grad.cpu().numpy()
             for name, mod in (("unet", unet), ("imnet", imnet))
             for k, p in mod.named_parameters()}
    return grads, pres


def flip_clause(state, metrics, ref, spec, cfg, pde, batch, mesh, ph, masks,
                rank, start):
    """A step outside phase 8's rule passes if its encoder's LeakyReLU
    branches differ from float64's only where the float64 pre-activation
    lies within FLIP_REL of its layer's max |pre| (a branch taken within
    rounding of 0, as the jet checks allow), and, with float64 recomputed
    on the card on the run's own branches, every gradient leaf meets
    phase 8's rule. The recomputation on float64's own branches must
    reproduce the reference's float64 gradients first. Returns the
    names that fail (the same on every rank)."""
    import torch.distributed as dist

    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, (mesh.data_index, mesh.space_index,
                                      ph["sharded"], masks))
    bad = ["flip clause"]
    if rank == 0:
        # The run's branches on the whole batch: data blocks along the
        # batch, x shards (sharded encoder) along x, the last axis.
        rows = {}
        for d, sp, sharded, m in gathered:
            if sharded or sp == 0:
                rows.setdefault(d, {})[sp] = m
        full = []
        for i in range(len(masks)):
            full.append(torch.cat([
                torch.cat([rows[d][sp][i] for sp in sorted(rows[d])], -1)
                for d in sorted(rows)], 0))
        g_own, pres = float64_step(cfg, start, pde, batch)
        self_err = max(float(np.abs(g_own[k] - ref[f"grad64/{k}"]).max())
                       / float(ref[f"scale/{k}"]) for k in g_own)
        flips, worst = 0, 0.0
        for f, p in zip(full, pres):
            diff = f != (p > 0)
            flips += int(diff.sum())
            if diff.any():
                worst = max(worst, float(p[diff].abs().max())
                            / float(p.abs().max()))
        say(f"{ph['name']}: outside the rule; the encoder took {flips} "
            f"LeakyReLU branch(es) other than float64's, the farthest at "
            f"{worst:.2e} of its layer's max |pre| (FLIP_REL {FLIP_REL:g}); "
            f"the card's float64 recomputation reproduces the reference "
            f"to {self_err:.1e} of each leaf's scale")
        if flips and worst <= FLIP_REL and self_err <= 1e-6:
            g_run, _ = float64_step(cfg, start, pde, batch, full)
            say(f"{ph['name']}: against float64 on the run's own branches:")
            bad = check_step(state, metrics, ref, spec,
                             "on the run's own branches", grad64=g_run)
    out = [bad]
    dist.broadcast_object_list(out, 0)
    return out[0]


def cli_runs(device, rank, ph):
    """Phase F, one rank: ``main`` of a train CLI for each flag list of
    ``ph["runs"]``; each run's launches and epochs."""
    driver = load_driver(ph["driver"], "train_torch.py")
    out = []
    for flags in ph["runs"]:
        _reset_launches()
        res = driver.main(flags)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out.append({"launches": _launches(), "step": res["step"],
                    "start_epoch": res["start_epoch"],
                    "provenance": res["provenance"],
                    "epochs": [{k: v for k, v in e.items()
                                if isinstance(v, (int, float))}
                               for e in res["epochs"]]})
    return {"runs": out}


def parallel_flags(base, log_dir, per_rank_batch, n_data, steps=8):
    """A train CLI's flags with ``steps`` steps an epoch at ``n_data``
    data ranks (the epoch's crops scale with the global batch)."""
    flags = list(base)
    i = flags.index("--pseudo_epoch_size")
    flags[i + 1] = str(steps * per_rank_batch * n_data)
    i = flags.index("--log_dir")
    flags[i + 1] = log_dir
    return flags


def turb3d_flags(tmp, log_dir):
    """The turb3d recipe's model and loss flags (phase 15)."""
    return [
        "--device", "cuda", "--data_folder", tmp, "--train_data",
        "beltrami_s42.npz,beltrami_s100.npz,beltrami_s101.npz",
        "--eval_data", "beltrami_s7.npz", "--nt", "8", "--nz", "32",
        "--ny", "32", "--nx", "32", "--downsamp_t", "2",
        "--downsamp_xyz", "4", "--lat_dims", "64", "--unet_nf", "32",
        "--imnet_nf", "64", "--n_samp_pts_per_crop", "1024",
        "--batch_size_per_gpu", "4", "--inner_steps", "8",
        "--pseudo_epoch_size", "32", "--alpha_pde", "0.1",
        "--lr", "5e-3", "--lr_schedule", "cosine",
        "--pde_loss_type", "huber", "--seed", "42", "--log_dir", log_dir]


def report_cli(card, what, ranks, points, run=0):
    """Sum a phase-F CLI run over the ranks; print and check it."""
    runs = [r[what]["runs"][run] for r in ranks]
    launches = {k: sum(r["launches"][k] for r in runs)
                for k in runs[0]["launches"]}
    epochs = runs[0]["epochs"]
    sps = [e["sec_per_step"] for e in epochs]
    losses = [e["loss"] for e in epochs]
    if not epochs or not all(np.isfinite(
            [e[k] for e in epochs for k in e if k.endswith("loss")])):
        raise SystemExit(f"{what}: lost an epoch or went non-finite: "
                         f"{epochs}")
    if len({r["step"] for r in runs}) != 1:
        raise SystemExit(f"{what}: the ranks ended at different steps")
    prov = runs[0]["provenance"]
    layout = prov[prov.index("world="):]
    say(f"{what}: {len(ranks)} rank(s), {layout}; started at epoch "
        f"{runs[0]['start_epoch']}, ended at step {runs[0]['step']}; "
        f"losses {', '.join(f'{v:.5f}' for v in losses)};"
        f" {', '.join(f'{s:.4f}' for s in sps)} s/step, "
        f"{points / np.mean(sps):.0f} points/s ({points} a step, all "
        f"ranks) on {card}; launches summed over the ranks {launches}")
    for name in ("jet_fwd", "jet_bwd"):
        if launches[name] < 1:
            raise SystemExit(f"{name} was not launched by {what}")
    return runs[0], launches


def parallel_phases(card, tmp):
    """Phases D-F; returns the launch counts of the new paths."""
    from space_time_pde_torch.ops import fused_query as fq

    data = os.path.join(tmp, "data")
    os.makedirs(data)
    taylor_green_folder(data)
    beltrami_files(data, (42, 100, 101, 7))
    rb2d_base = rb2d_flags(data, "")
    world = 4
    log = lambda name: os.path.join(tmp, f"log_{name}")
    phases = [
        dict(kind="step", name="D1", ref=os.path.relpath(STEP_REF, ROOT),
             layout="dp", n_space=2, sharded=False,
             what="the flagship step data-parallel over 2 data ranks (each "
                  "data group of the 2 x 2 world)"),
        dict(kind="step", name="D2", ref=os.path.relpath(STEP_REF, ROOT),
             layout="dp_sp", n_space=2, sharded=False,
             what="the flagship step on 2 x 2, replicated encoder"),
        dict(kind="step", name="D3", ref=os.path.relpath(STEP_REF, ROOT),
             layout="dp_sp", n_space=2, sharded=True,
             what="the flagship step on 2 x 2, ShardedUNet3d (local x 8 -> "
                  "4 -> 2)"),
        dict(kind="step", name="D4", ref=os.path.relpath(BN_STEP_REF, ROOT),
             layout="dp", n_space=2, sharded=False,
             what="the BatchNorm step over 2 data ranks, statistics "
                  "synced"),
        dict(kind="step", name="E",
             ref=os.path.relpath(TURB3D_STEP_REF, ROOT), layout="dp_sp",
             n_space=2, sharded=True,
             what="the turb3d step on 2 x 2, ShardedUNet4d (local x 4 -> "
                  "2 -> 1), the jets at D = 4"),
        dict(kind="cli", name="rb2d_dp_sp_sharded_train", driver="rb2d",
             runs=[parallel_flags(rb2d_base, log("f1"), 8, 2)
                   + ["--space_devices", "2", "--sharded_encoder",
                      "--epochs", "1"],
                   parallel_flags(rb2d_base, log("f1"), 8, 2)
                   + ["--space_devices", "2", "--sharded_encoder",
                      "--epochs", "2", "--resume",
                      os.path.join(log("f1"), "checkpoints")]]),
        dict(kind="cli", name="rb2d_dp_sp_train", driver="rb2d",
             runs=[parallel_flags(rb2d_base, log("f1r"), 8, 2)
                   + ["--space_devices", "2", "--epochs", "1"]]),
        dict(kind="cli", name="turb3d_dp_sp_sharded_train", driver="turb3d",
             runs=[parallel_flags(turb3d_flags(data, ""), log("f4"), 4, 2)
                   + ["--space_devices", "2", "--sharded_encoder",
                      "--epochs", "1"]]),
    ]
    say(f"phases D-F: {world} ranks on {torch.cuda.device_count()} card(s) "
        f"({card}); ranks that share a card run over gloo, so their "
        "times measure no scaling")
    ranks = spawn_world(world, tmp, phases, "d_e_f")
    steps = {ph["name"]: {k: sum(r[ph["name"]]["launches"][k] for r in ranks)
                          for k in ranks[0][ph["name"]]["launches"]}
             for ph in phases if ph["kind"] == "step"}
    say("phases D-E launches summed over the ranks: " + "; ".join(
        f"{k} {v}" for k, v in steps.items()) + "; seconds (rank 0): "
        + ", ".join(f"{ph['name']} {ranks[0][ph['name']]['seconds']:.1f}"
                    for ph in phases))
    by_path = {}
    first, by_path["rb2d_dp_sp_sharded_train"] = report_cli(
        card, "rb2d_dp_sp_sharded_train", ranks, 16 * 1024)
    resumed = ranks[0]["rb2d_dp_sp_sharded_train"]["runs"][1]
    say(f"rb2d_dp_sp_sharded_train resumed at epoch "
        f"{resumed['start_epoch']}, ended at step {resumed['step']}; "
        f"losses {[round(e['loss'], 5) for e in resumed['epochs']]}")
    if first["step"] != 8 or resumed["start_epoch"] != 1 or \
            resumed["step"] != 16 or not np.isfinite(
                [e["loss"] for e in resumed["epochs"]]).all():
        raise SystemExit("the sharded CLI's resume is not step-exact")
    _, by_path["rb2d_dp_sp_train"] = report_cli(
        card, "rb2d_dp_sp_train", ranks, 16 * 1024)
    _, by_path["turb3d_dp_sp_sharded_train"] = report_cli(
        card, "turb3d_dp_sp_sharded_train", ranks, 8 * 1024)

    # F: data parallelism on 2 ranks.
    dp = [dict(kind="cli", name="rb2d_dp_train", driver="rb2d",
               runs=[parallel_flags(rb2d_base, log("f2"), 8, 2)
                     + ["--epochs", "1"]])]
    _, by_path["rb2d_dp_train"] = report_cli(
        card, "rb2d_dp_train", spawn_world(2, tmp, dp, "f2"), 16 * 1024)

    # F: world 1 on NCCL, in this process.
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    os.environ.update(env)
    import torch.distributed as dist
    try:
        _reset_launches()
        res = load_driver("rb2d", "train_torch.py").main(
            parallel_flags(rb2d_base, log("f3"), 8, 1) + ["--epochs", "1"])
        torch.cuda.synchronize()
        nccl = {"launches": _launches(), "step": res["step"],
                "start_epoch": res["start_epoch"],
                "provenance": res["provenance"],
                "epochs": [{k: v for k, v in e.items()
                            if isinstance(v, (int, float))}
                           for e in res["epochs"]]}
        if "backend=nccl" not in res["provenance"]:
            raise SystemExit(f"world 1 did not run on NCCL: "
                             f"{res['provenance']}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    _, by_path["rb2d_nccl_train"] = report_cli(
        card, "rb2d_nccl_train", [{"rb2d_nccl_train": {"runs": [nccl]}}],
        8 * 1024)
    if torch.cuda.device_count() >= 2:
        n = torch.cuda.device_count()
        multi = [dict(kind="cli", name="rb2d_dp_nccl_cards", driver="rb2d",
                      runs=[parallel_flags(rb2d_base, log("f5"), 8, n)
                            + ["--epochs", "1"]])]
        _, by_path["rb2d_dp_nccl_cards"] = report_cli(
            card, "rb2d_dp_nccl_cards", spawn_world(n, tmp, multi, "f5"),
            n * 8 * 1024)
    for path, counts in by_path.items():
        if path.startswith("rb2d") and counts["decode_blend_gather"] < 1:
            raise SystemExit(f"decode_blend_gather was not launched by "
                             f"{path}'s epoch eval")
    fq.reset_launches()
    return by_path


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); this needs an NVIDIA "
                         "GPU")
    sys.path.insert(0, ROOT)
    import sympy

    from space_time_pde_torch.ops import _build

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} sympy "
          f"{sympy.__version__} device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    # Phase 2: build.
    t0 = time.perf_counter()
    _build.load()
    log = _build.build_log()
    for src in ("fused_query", "fused_jet", "fused_jet_bf16"):
        for line in ptxas_summary(log.get(src, "")):
            print(f"{src}.cu {line}", flush=True)
    lib = _build.load()
    print("fused_query.cu decode block: "
          f"{lib.stpde_block_rows()} corner rows, dynamic shared memory "
          f"{lib.stpde_decode_smem_bytes(64, 3, 64)} bytes at C = 64, "
          "nf = 64 (the bf16 instantiation "
          f"{lib.stpde_decode_bf16_smem_bytes(64, 3, 64)})", flush=True)
    say(f"kernels loaded in {time.perf_counter() - t0:.1f}s ("
        + (f"nvcc {log['seconds']:.1f}s, all sources in parallel" if log
           else "already built") + ")")

    # Phases 3-4: kernels vs plain twins at the rb2d flagship widths.
    imnet3 = load_imnet(ASSET, 3, device)
    with torch.no_grad():
        d3 = kernel_vs_plain(imnet3, device, (4, 16, 64))
    d3.update(jet_vs_plain(imnet3, device, (4, 16, 16), N_JET))
    torch.cuda.empty_cache()

    # Phases 5-7: the rb2d serving path.
    rb2d_eval, rb2d_off = rb2d_serving(device, card)
    torch.cuda.empty_cache()

    # Phases 8-9: the rb2d training step against JAX, then the train path.
    say(f"rb2d flagship training step vs the JAX-CPU reference "
        f"({os.path.relpath(STEP_REF, ROOT)}):")
    train_step_vs_jax(device, STEP_REF)
    torch.cuda.empty_cache()
    rb2d_train = rb2d_train_path(card)
    torch.cuda.empty_cache()

    # Phases 10-11: kernels vs plain twins at D = 4 (turb3d widths).
    imnet4 = load_imnet(TURB3D_ASSET, 4, device)
    with torch.no_grad():
        d4 = kernel_vs_plain(imnet4, device, (4, 8, 8, 8))
    d4.update(jet_vs_plain(imnet4, device, (4, 8, 8, 8), N_JET4))
    torch.cuda.empty_cache()

    # Phases 12-13: the turb3d serving path.
    turb3d_eval, turb3d_off = turb3d_serving(device, card)
    torch.cuda.empty_cache()

    # Phases 14-15: the turb3d training step against JAX, then training.
    say(f"turb3d training step vs the JAX-CPU reference "
        f"({os.path.relpath(TURB3D_STEP_REF, ROOT)}):")
    train_step_vs_jax(device, TURB3D_STEP_REF)
    torch.cuda.empty_cache()
    turb3d_train = turb3d_train_path(card)
    torch.cuda.empty_cache()

    # Phase A: the rb2d eval path on real RB2D windows.
    rb2d_eval_real = rb2d_real_windows(device, card)
    torch.cuda.empty_cache()

    # Phase B: a BatchNorm step against JAX, then BatchNorm training.
    say(f"rb2d BatchNorm training step vs the JAX-CPU reference "
        f"({os.path.relpath(BN_STEP_REF, ROOT)}):")
    train_step_vs_jax(device, BN_STEP_REF)
    torch.cuda.empty_cache()
    rb2d_bn_train = rb2d_train_path(card, "--norm", "batch",
                                    what="rb2d BatchNorm")
    torch.cuda.empty_cache()

    # Phase C: a JAX run resumed in the port.
    rb2d_resume = resume_from_jax(device, card)
    torch.cuda.empty_cache()

    # Phases D-F: the parallel paths (ranks in processes of their own).
    with tempfile.TemporaryDirectory() as tmp:
        parallel = parallel_phases(card, tmp)

    # Phase G: the bf16 decode kernel against its twin at D = 3 and 4.
    name16 = "decode_blend_gather_bf16"
    with torch.no_grad():
        d3[name16] = bf16_kernel_vs_plain(imnet3, device, (4, 16, 64))
        d4[name16] = bf16_kernel_vs_plain(imnet4, device, (4, 8, 8, 8))
    torch.cuda.empty_cache()

    # Phases H-J: the bf16 policy's eval on real windows, its training
    # step against JAX, and the CLIs.
    bf16_paths = {"rb2d_eval_real_bf16": rb2d_real_windows_bf16(device,
                                                                card)}
    torch.cuda.empty_cache()
    say(f"rb2d flagship training step under use_bf16 vs the JAX-CPU bf16 "
        f"reference ({os.path.relpath(BF16_STEP_REF, ROOT)}):")
    bf16_step_vs_jax(device)
    torch.cuda.empty_cache()
    bf16_paths.update(bf16_clis(card))
    torch.cuda.empty_cache()

    # Phases K-L: the bf16 jets and the bf16 pre-gathered decode against
    # their twins at D = 3 and 4; L's scattered requests off the paths.
    t_kn = time.perf_counter()
    d3.update(bf16_jet_vs_plain(imnet3, device, (4, 16, 16), N_JET))
    torch.cuda.empty_cache()
    d4.update(bf16_jet_vs_plain(imnet4, device, (4, 8, 8, 8), N_JET4))
    torch.cuda.empty_cache()
    with torch.no_grad():
        d3["decode_blend_bf16"], rb2d_off16 = bf16_pregather_vs_plain(
            imnet3, device, (4, 16, 64))
        d4["decode_blend_bf16"], turb3d_off16 = bf16_pregather_vs_plain(
            imnet4, device, (4, 8, 8, 8))
    torch.cuda.empty_cache()

    # Phases M-N: the flagship step under --use_bf16 --pde_bf16 against
    # JAX, and both train CLIs so.
    say(f"rb2d flagship training step under use_bf16 + pde_bf16 vs the "
        f"JAX-CPU bf16 reference "
        f"({os.path.relpath(BF16_PDE_STEP_REF, ROOT)}):")
    bf16_step_vs_jax(device, pde_bf16=True)
    torch.cuda.empty_cache()
    bf16_paths.update(bf16_train_clis(card, pde_bf16=True))
    torch.cuda.empty_cache()
    say(f"phases K-N took {time.perf_counter() - t_kn:.1f} s")

    by_path = {"rb2d_eval": rb2d_eval, "rb2d_train": rb2d_train,
               "turb3d_eval_val": turb3d_eval["val"],
               "turb3d_eval_test": turb3d_eval["test"],
               "turb3d_train": turb3d_train,
               "rb2d_eval_real": rb2d_eval_real,
               "rb2d_bn_train": rb2d_bn_train, "rb2d_resume": rb2d_resume,
               **parallel, **bf16_paths}
    off = {"rb2d_scattered": rb2d_off, "turb3d_scattered": turb3d_off,
           "rb2d_scattered_bf16": rb2d_off16,
           "turb3d_scattered_bf16": turb3d_off16}
    kernels = []
    for name in REPLACES:
        # The eval paths count only the decode kernels, the train paths
        # the jets and the epoch eval's decode.
        paths = {p: c[name] for p, c in {**by_path, **off}.items()
                 if c.get(name)}
        main_path = sum(c.get(name, 0) for c in by_path.values())
        entry = {"name": name, "route": "cuda", "math": MATH[name],
                 "source": SOURCES[name],
                 "replaces": REPLACES[name], "path": PATHS[name],
                 "launches": main_path, "launches_by_path": paths,
                 "launches_by_dim": {
                     str(d): sum(n for p, n in paths.items()
                                 if p.startswith(fam))
                     for d, fam in ((3, "rb2d"), (4, "turb3d"))},
                 **d4[name], "library_ms": None,
                 "d3": dict(d3[name], library_ms=None)}
        if PATHS[name] == "off_path":
            # Counted in its own scattered-point requests; the eval and
            # train paths never launch it.
            entry["launches"] = sum(c[name] for c in off.values())
            entry["main_path_launches"] = main_path
        elif main_path < 1:
            raise SystemExit(f"{name} was not launched on its main paths")
        kernels.append(entry)
    say("done")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
    else:
        main()
