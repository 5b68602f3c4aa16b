"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases (any failure raises and exits non-zero):

1. require a CUDA device; print the card (``nvidia-smi`` name and power
   limit), the torch / CUDA / sympy versions and both TF32 flags
   (switched off);
2. build every kernel from ``space_time_pde_torch/csrc`` (one nvcc per
   source, in parallel); print each kernel's registers and spills from
   ptxas, both D instantiations of the jet kernels apart, both decodes'
   plans at the flagship widths (shared memory, ring stages, cluster
   size, rows a tile; the f32 one's widths' base), both jets' rings (the
   f32 ones' at each D and product), and, where the toolkit has
   ``cuobjdump``, the count of the wgmma (``HGMMA``), ``mma.sync``
   (``HMMA``), bulk-copy (``UBLKCP``), TMA (``UTMALDG``) and mbarrier
   (``SYNCS``) instructions in the SASS of both decodes and both jets,
   and how many times ptxas noted that it serialized the wgmmas of any
   (C7520); the f32 decode and the f32 jets must show HGMMA, no HMMA and
   no C7520;
3. both decode kernels against their plain PyTorch twins on the card,
   at the rb2d flagship widths (C = 64, nf = 64, D = 3, out = 4) on
   65,536 seeded points that include lattice faces, cell edges and
   points outside the domain; tolerance rtol = atol = 1e-4 against the
   f32 twin (the kernel's 3xTF32 products are f32-grade; the summation
   order and the order of the blend-before-head rounding differ); and
   against the twin run in float64 on the card, at most DECODE_SLACK
   times as far from it as the f32 twin, ``|err| <= 1e-4 |ref| + atol
   max|ref|`` (both distances printed); CUDA-event times of both, the
   f32 kernel's weight image built once (``decode_tiles``), and the
   weight bytes a call streams from L2 as its plan gives them;
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
   batch), run as the train CLIs run it on a card: through the CUDA
   graph of ``CapturedStep`` (its eager warm-up dispatch, the state put
   back, then the capture's replay under a device trace, which must show
   each jet kernel launched once; ``captured_step_once``, as phases 14,
   B, I and M): the loss terms within LOSS_RTOL of JAX's float32, and
   every gradient leaf against the float64 recomputation, point by
   point, at most STEP_SLACK times as far as JAX's own float32 gradients
   (below);
9. the training path end to end: ``train_torch.main`` with the flagship's
   model and loss flags on a Taylor–Green field made here, 2 epochs x
   8 steps (``--inner_steps 8``; the captured step, its first dispatch
   the eager warm-up), then a resume that continues at epoch 2; the
   launch counts of the first run alone, from a device trace of it
   (``traced_path``: the wrappers count the launches made from Python,
   and a graph replay makes none), finite losses, the resumed step
   count, s/step and points/s (traced);

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
    ``assets/turb3d_train_step_ref.npz``, by phase 8's rule, and the
    median over its leaves of the ratio of each leaf's rel-L2 distance
    from float64 to JAX f32's at most STEP_MEDIAN;
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

G. the gather decode's bf16 kernel (``decode_blend_gather`` with
   ``compute_dtype=bfloat16``, ``stpde_decode_blend_gather_bf16``,
   ``csrc/fused_query_bf16.cu``; its weights tiled once by
   ``decode_tiles``) against its bf16 plain twin on phase 3's and 10's
   65,536 points and grids (D = 3 and 4, C = 64, nf = 64), the table
   rounded to bf16: per point within BF16_DIRECT of max |twin|, and
   against the f32 function in float64 at most BF16_KERNEL_SLACK times
   as far as the twin; CUDA-event times against the bf16 bound;
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
   ``csrc/fused_jet_bf16.cu``: every product on one persistent wgmma
   kernel fed by TMA through an mbarrier ring) against their bf16 twins
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
O. the eval CLIs on checkpoint directories (``--ckpt``), each run's
   source, step, decode dtype and kernel, rel-L2, steady points/s and
   launches printed (the gather decode of its dtype alone, no jet). O1:
   port checkpoints holding the committed exports' weights, ``--ckpt``
   beside ``--params`` on phase 5's Taylor–Green windows and phase 12's
   val windows, window 0, the per-window rel-L2 and the saved
   predictions equal bit for bit. O2 (inside phases 9, B, 15, F and N,
   while their directories live): 2 windows of each run's directory,
   window 0 bit for bit against ``make_dense_decoder`` over models built
   at the eval grid and given the run's weights (the live state; phase
   F's rank 0 file through a plain ``torch.load``);
P. the captured step (``CapturedStep``: one CUDA graph a dispatch, the
   train CLIs' step on a card) against the eager step, for rb2d and
   turb3d under f32 and ``--use_bf16 --pde_bf16``, at 1 and 8 steps a
   dispatch: 4 dispatches (3 at 8 steps) from the same seeded state on
   the same seeded batches; two eager runs agree bit for bit (checked at
   1 step a dispatch), so every parameter, moment, counter and metric
   must too; one dispatch of non-finite batches leaves the parameters
   and moments untouched and advances ``notfinite_count`` on the device;
   s/step of both, untraced; then one traced dispatch of each (of the
   captured step alone at 8 steps a dispatch): its jet launches (graph
   replays included) and the idle share, 1 - the device's busy time /
   the wall time, both of that traced dispatch;

and the RB2D data generator (``data/rb2_solver.py``: the float64
Boussinesq solver, its Helmholtz solves on ``csrc/tridiag.cu``):

S. (a) the tridiag kernel against ``thomas_plain`` on the card, both
   boundary kinds, at 128 x 257 and a ragged 16 x 45, within TRIDIAG_TOL
   of max |x|, CUDA-event times; (b) the card solver against the port's
   numpy copy, 200 steps from seed 42 at 512 x 128, Ra 1e6, every field
   within SEEDED_TOL of its max; (c) the same from a developed state
   (the numpy copy run to t = 10 at 64 x 32, Ra 1e5, seed 0) within
   DEVELOPED_TOL; (d) two card runs of (b), and a snapshot interval's
   CUDA graph replayed twice against the same steps run eagerly, bit for
   bit, and one replay traced; (e) ``generate_data_torch.main`` with
   ``data/regen_rb2d.sh``'s flags (seed 42): s per seed, the tridiag
   launches (the wrapper's from Python plus those it recorded into the
   graph times the replays ``simulate_rb2d`` counted, which must be the
   transient's and the snapshots'), the file's schema, its statistics
   against the numpy seeds' (``assets/rb2d_ra1e6_stats.npz``,
   STATS_SLACK, STATS_FLOOR); (f)
   ``train_torch.main`` with the flagship's flags, 2 epochs x 8 steps on
   that file; the readings on a ``{"solver": ...}`` line;

and the turb3d data CLI and a from-scratch training run:

T. (a) ``experiments/turb3d/generate_data_torch.py`` on the card for the
   Beltrami seeds 7 and 123 at its default flags: every field within
   BELTRAMI_TOL (2^-22) of its max |value| from the port's numpy copy,
   the schema and scalars equal, s a seed; (b)
   ``scripts/train_from_scratch.py --smoke`` in this process: the rb2d
   flagship's ``log/r5_rb2d_4x_e900/command.sh`` flags under f32, 2
   epochs of its 256 steps on phase S's seed as train and val data,
   ``scripts/train_curve.py --keys_only`` on its metrics; its launches
   (path ``rb2d_from_scratch``) the wrappers' from Python plus those the
   captured step's graph replays ran, each jet once a step; the readings
   on a ``{"phase_t": ...}`` line;

and last, one JSON line of the nine kernels (the four f32 kernels, the
four bf16 instantiations and ``tridiag``; ``path``: eval, train,
off_path or rb2d_data; ``math``: tf32x3 for the f32 kernels (3xTF32 on
the tensor cores), bf16 for the bf16 ones, fp64 for tridiag; launches
per path and per D (on the train paths, the device trace's count);
times, plain times and bounds at D = 4, and at D = 3 under ``d3``:
``bound_ms`` against the kernel's own arithmetic, ``bound_f32_ms``
against f32 FFMA; tridiag's at 128 x 257), then the status line.

Imports nothing of JAX or of the JAX package.
"""

import ctypes
import hashlib
import importlib.util
import json
import math
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
# Phase 14 also holds the median over the turb3d step's leaves of each
# leaf's rel-L2 distance from float64 over JAX f32's: 1.73 before UNet4d's
# temporal product summed in float64 (0.63 with it alone in float64 on
# an H100; rb2d's step, phase 8, reads 0.44).
STEP_MEDIAN = 1.0
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
    "decode_blend_gather_bf16":
        "space_time_pde_torch/csrc/fused_query_bf16.cu",
    "decode_blend": "space_time_pde_torch/csrc/fused_query.cu",
    "decode_blend_bf16": "space_time_pde_torch/csrc/fused_query_bf16.cu",
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


# The kernel that each wrapper launches once a call, as a device trace
# names it: the jets' head kernels; the decodes' one kernel, whose
# template argument tells the entries apart (the f32 one's first, the
# widths' base, does not).
TRACE_MARKERS = {
    "jet_fwd": r"jet_head_fwd_kernel<\d, float>",
    "jet_bwd": r"jet_head_bwd_kernel<\d, float>",
    "jet_fwd_bf16": r"jet_head_fwd_kernel<\d, __nv_bfloat16>",
    "jet_bwd_bf16": r"jet_head_bwd_kernel<\d, __nv_bfloat16>",
    "decode_blend_gather": r"decode_blend_kernel<\d+, true>",
    "decode_blend": r"decode_blend_kernel<\d+, false>",
    "decode_blend_gather_bf16": r"decode_bf16_kernel<false>",
    "decode_blend_bf16": r"decode_bf16_kernel<true>",
    "tridiag": r"tridiag_kernel",
}
_MARKED = (r"jet_head_(fwd|bwd)_kernel|decode_(blend|bf16)_kernel"
           r"|tridiag_kernel")


def traced(fn):
    """``fn()`` under a device trace (``torch.profiler``, device activity
    alone), ended by a synchronise: (its result, the launches of each
    wrapper's kernel that the card ran, graph replays included, by
    ``LAUNCHES`` key, the device's busy ms (the union of the intervals
    of its kernels, copies and fills), the host's wall ms of the traced
    call). A graph replay launches nothing from Python, so the wrappers'
    own counts miss it; the trace does not."""
    import warnings

    acts = [torch.profiler.ProfilerActivity.CUDA]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    # The raw events: building the profiler's Python events for the
    # ~10^5 launches of a train CLI's run costs tens of seconds.
    cuda = torch.autograd.DeviceType.CUDA
    counts = dict.fromkeys(TRACE_MARKERS, 0)
    spans, names = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        spans.append((e.start_ns(), e.end_ns()))
        name = e.name()
        names[name] = names.get(name, 0) + 1
    for name, n in names.items():
        hits = [k for k, pat in TRACE_MARKERS.items() if re.search(pat, name)]
        if not hits and re.search(_MARKED, name):
            raise SystemExit(f"the device trace names a wrapper's kernel "
                             f"{name[:160]!r} that no marker reads")
        for k in hits:
            counts[k] += n
    if not spans:
        raise SystemExit("the device trace saw no kernel")
    busy, end = 0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return out, counts, busy / 1e6, wall


def traced_path(fn, what, keys):
    """A main path's run under :func:`traced`: (its result, its launches
    as the trace counts them). The wrappers' counts, set to 0 first, must
    show every kernel of ``keys`` launched from Python at least once, and
    the trace at least as many launches of each kernel as the wrappers
    count."""
    from space_time_pde_torch.ops import fused_jet as fj
    from space_time_pde_torch.ops import fused_query as fq

    fj.reset_launches()
    fq.reset_launches()
    out, counts, _, _ = traced(fn)
    wrapped = {**fj.LAUNCHES, **fq.LAUNCHES}
    short = sorted(k for k in wrapped if counts[k] < wrapped[k])
    unlaunched = sorted(k for k in keys if wrapped[k] < 1)
    say(f"{what}: launches in the device trace {counts}; from Python "
        f"(the wrappers' counts, no graph replay) {wrapped}")
    if short or unlaunched:
        raise SystemExit(f"{what}: the trace counts fewer launches than the "
                         f"wrappers of {short}, or no wrapper launched "
                         f"{unlaunched}")
    return out, counts


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
        if m and "gemm_kernel" in m.group(1):
            # The bf16 jets' product kernel, named by its problem type.
            g = re.search(r"gemm_kernelINS_\d+([A-Za-z]+)I((?:L[ib]\d+E)+)E",
                          m.group(1))
            args = re.findall(r"L[ib](\d+)E", g.group(2)) if g else []
            name = (f"gemm_kernel<{g.group(1)}<{', '.join(args)}>>" if g
                    else "gemm_kernel")
            spills = "spill not reported"
            continue
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


def bf16_plan(dim, pregathered):
    """The bf16 decode's plan (``stpde_decode_bf16_plan``) at the flagship
    widths (C = 64, nf = 64)."""
    from space_time_pde_torch.ops import _build

    buf = (ctypes.c_longlong * 6)()
    _build.load("fused_query_bf16").stpde_decode_bf16_plan(
        64, dim, 64, pregathered, buf)
    return dict(zip(("smem", "stages", "kx", "image", "cluster", "rows"),
                    list(buf)))


def f32_plan(dim):
    """The f32 decode's plan (``stpde_decode_plan``) at the flagship widths
    (C = 64, nf = 64)."""
    from space_time_pde_torch.ops import _build

    buf = (ctypes.c_longlong * 8)()
    _build.load().stpde_decode_plan(64, dim, 64, buf)
    return dict(zip(("smem", "stages", "kx", "image", "cluster", "rows",
                     "base", "slot"), list(buf)))


def sass_counts(source="fused_query_bf16"):
    """Counts of the wgmma, mma.sync, bulk-copy, TMA and mbarrier
    instructions in the SASS of ``csrc/<source>.cu`` (``cuobjdump
    -sass``), or why there are none."""
    import shutil

    from space_time_pde_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "cuobjdump not found"
    sass = subprocess.run(
        [tool, "-sass", str(_build.library_path(source))],
        capture_output=True, text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HGMMA", "HMMA", "UBLKCP", "UTMALDG", "SYNCS")}


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
    # The f32 kernel's weight image, built once as a decoder builds it;
    # each cluster of CTAs streams it from L2 once per group of tiles.
    tiles = fq.decode_tiles(packed, nf=imnet.nf, dim=dim,
                            compute_dtype=torch.float32)
    # The ring streams the image's weight segments (not the rel / cb rows
    # after them, which the consumers read per tile): the L2 bytes below
    # follow from the plan, no counter measures them.
    plan = f32_plan(dim)
    segments = plan["image"] - (dim + 2 ** dim) * 31 * plan["base"]
    tiles_a_call = -(-N_CHECK // (plan["rows"] >> dim))
    l2_bytes = 4 * segments * -(-tiles_a_call // plan["cluster"])
    say(f"f32 decode at D={dim}: each k8 step's products promoted "
        f"(interval 1), weight segments {4 * segments} bytes, "
        f"{tiles_a_call} tiles a call in clusters of {plan['cluster']}: "
        f"{l2_bytes / 1e9:.3f} GB of weights from L2 a call (derived from "
        f"the plan, not measured)")
    calls = {
        "decode_blend_gather": (
            lambda: fq.decode_blend_gather(table, cell_flat, frac, packed,
                                           tiles=tiles, **kw),
            lambda: fq.decode_blend_gather_plain(table, cell_flat, frac,
                                                 packed, **kw)),
        "decode_blend": (
            lambda: fq.decode_blend(feats2, frac, packed, tiles=tiles,
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
          f"{need_k:.3e}, f32 twin {need_p:.3e}; limit {limit:.3e} "
          f"({need_k / limit:.3f} of it) {note}", flush=True)
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


def written_tensors(state):
    """{name: tensor} of everything a training step writes in place: the
    parameters, the buffers, Adam's moments and the counters."""
    from space_time_pde_torch.train import COUNTERS

    out = {f"param/{k}": p.data for k, p in state.params().items()}
    out.update({f"buffer/{k}": b for k, b in state.buffers().items()})
    for m in ("mu", "nu"):
        out.update({f"{m}/{k}": v for k, v in state.opt_state[m].items()})
    out.update({f"counter/{k}": state.opt_state[k] for k in COUNTERS})
    return out


def captured_step_once(cfg, pde, opt, state, batch):
    """One step of ``state`` on ``batch`` through the CUDA graph of the
    train CLIs' step (``CapturedStep``): its first dispatch (the eager
    warm-up) runs, the state is put back in place, and the next dispatch
    captures and replays, under a device trace. Returns (state, metrics,
    the replay's launches as the trace counts them); the gradients are
    the replay's (``.grad``, in the graph's pool)."""
    from space_time_pde_torch.train import CapturedStep, make_loss_fn

    before = {k: t.clone() for k, t in written_tensors(state).items()}
    step = CapturedStep(make_loss_fn(cfg, state.unet, state.imnet, pde),
                        opt, 1, batch["lres"].device)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    with torch.no_grad():
        for k, t in written_tensors(state).items():
            t.copy_(before[k])
    state.step -= 1
    (state, metrics), launches, _, _ = traced(lambda: step(state, batch))
    if step.graph is None:
        raise SystemExit("the reference step was not captured")
    return state, metrics, {k: n for k, n in launches.items() if n}


def train_step_vs_jax(device, step_ref, median_limit=None):
    """Phases 8, 14 and B: one training step against the JAX reference,
    through the captured step (the train CLIs' on a card);
    ``median_limit``: check_step's."""
    cfg, pde, opt, state, batch, ref, spec = reference_step(step_ref, device)
    # One optimizer step; its gradients stay in the parameters' .grad.
    state, metrics, launches = captured_step_once(cfg, pde, opt, state,
                                                  batch)
    if launches != {"jet_fwd": 1, "jet_bwd": 1}:
        raise SystemExit(f"the replayed training step did not run the jet "
                         f"kernels once each: {launches}")
    bad = check_step(state, metrics, ref, spec, f"jet launches in the "
                     f"replay's device trace {launches}",
                     median_limit=median_limit)
    if bad:
        raise SystemExit(f"training step disagrees with JAX: {bad}")


def check_step(state, metrics, ref, spec, note, verbose=True, grad64=None,
               loss_rtol=LOSS_RTOL, label="JAX f32", leaf_norms=False,
               term_slack=None, median_limit=None):
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
    size of ``loss_rtol``). ``median_limit``: fail the step (as
    ``"median"``) if the median over the leaves of the ratio of each
    leaf's rel-L2 distance from float64 to the reference's is above it
    (phase 14: STEP_MEDIAN)."""
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
    if median_limit is not None and np.median(ratio) > median_limit:
        bad.append("median")
    if verbose:
        say(f"train step vs JAX: {len(needs)} gradient leaves vs float64 "
            f"at rtol {rtol:g}: worst atol {max(needs.values()):.3e} x "
            f"max|g64| (limit {limit:.3e} = {STEP_SLACK:g} x {label}'s "
            f"worst {jax_need:.3e}); rel L2 error / JAX's: median "
            f"{np.median(ratio):.2f}"
            + (f" (limit {median_limit:g})" if median_limit is not None
               else "")
            + f", max {max(ratio):.2f}"
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


def load_module(*parts):
    spec = importlib.util.spec_from_file_location(
        parts[-1][:-3], os.path.join(ROOT, *parts))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(*parts):
    return load_module("experiments", *parts)


def train_path(card, driver, flags, log_dir, batch_points, what,
               buffers=False):
    """Phases 9, 15 and B: ``driver.main`` trains 2 epochs x 8 steps,
    then resumes to epoch 3; returns the launch counts of the first run
    and each run's final ``TrainState`` by its step (phase O2 evaluates
    the checkpoints against them). ``buffers``: between the two, a
    resume that trains no epoch must restore the first run's BatchNorm
    statistics bit for bit."""
    first, launches = traced_path(
        lambda: driver.main(flags + ["--epochs", "2"]),
        f"{what} train path (2 epochs x 8 steps)", ("jet_fwd", "jet_bwd"))
    runs = [first]
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
    runs.append(resumed)
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
    return launches, {r["step"]: r["state"] for r in runs}


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


def rb2d_train_path(card, *extra, what="rb2d", ckpt_path="rb2d_ckpt_eval"):
    """Phase 9 (and B with ``--norm batch``), then phase O2 on the run's
    checkpoints; returns the train path's launches and {``ckpt_path``:
    the eval's}."""
    with tempfile.TemporaryDirectory() as tmp:
        taylor_green_folder(tmp)
        log_dir = os.path.join(tmp, "log")
        launches, states = train_path(
            card, load_driver("rb2d", "train_torch.py"),
            rb2d_flags(tmp, log_dir) + list(extra), log_dir, 8 * 1024, what,
            buffers="batch" in extra)
        return launches, own_run_eval(card, ckpt_path, "rb2d", log_dir,
                                      live_weights(states))


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
    """Phase 15, then phase O2 on the run's checkpoints (as
    :func:`rb2d_train_path`)."""
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
        launches, states = train_path(
            card, load_driver("turb3d", "train_torch.py"), flags, log_dir,
            4 * 1024, "turb3d")
        return launches, own_run_eval(card, "turb3d_ckpt_eval", "turb3d",
                                      log_dir, live_weights(states))


def rb2d_real_windows(device, card):
    """Phase A: the port's rb2d eval path on the 8 exported real RB2D
    windows, point by point against JAX."""
    from space_time_pde_torch.bridge import load_exported
    from space_time_pde_torch.inference import make_dense_decoder
    from space_time_pde_torch.ops import fused_query as fq
    from space_time_pde_torch.utils.checkpoint import eval_weights
    from space_time_pde_torch.utils.config import Config

    evaluation_torch = load_driver("rb2d", "evaluation_torch.py")
    with np.load(WINDOWS_REF) as z:
        ref = {k: z[k] for k in z.files}
    exported = load_exported(ASSET)
    out_shape = tuple(int(s) for s in ref["out_shape"])
    unet, imnet = evaluation_torch.build_models(
        Config.from_dict(exported["config"]), ref["lres"].shape[1:4],
        eval_weights(params=ASSET), device)
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
    tiles = fq.decode_tiles(packed, nf=imnet.nf, dim=len(spatial))
    return bf16_decode_vs_twin(
        "decode_blend_gather_bf16",
        lambda: fq.decode_blend_gather(table16, cell_flat, frac, packed,
                                       tiles=tiles, **kw),
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
    from space_time_pde_torch.utils.checkpoint import eval_weights
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
        cfg, ref["lres"].shape[1:4], eval_weights(params=ASSET), device)
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
    cfg, pde, opt, state, batch, ref, _ = reference_step(
        STEP_REF, device, use_bf16=True, pde_bf16=pde_bf16)
    with np.load(BF16_PDE_STEP_REF if pde_bf16 else BF16_STEP_REF,
                 allow_pickle=False) as z:
        ref16 = {k: z[k] for k in z.files}
    spec16 = json.loads(str(ref16["spec"]))
    state, metrics, launches = captured_step_once(cfg, pde, opt, state,
                                                  batch)
    jets = (("jet_fwd_bf16", "jet_bwd_bf16") if pde_bf16
            else ("jet_fwd", "jet_bwd"))
    if launches != dict.fromkeys(jets, 1):
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


def bf16_train_clis(card, pde_bf16=False, evaluate=False):
    """Both train CLIs with ``--use_bf16 true`` (phase J; with
    ``pde_bf16`` also ``--pde_bf16 true``, phase N), phases 9's and 15's
    flags, 2 epochs x 8 steps: finite losses, s/step of epoch 1, and the
    path's launches of each, which must take one jet instantiation alone
    (f32 under ``--use_bf16`` alone, bf16 with ``--pde_bf16``) and the
    bf16 gather decode (the epoch eval). ``evaluate``: phase O2 on each
    run's checkpoints, its launches under ``<family>_<tag>_ckpt_eval``."""
    paths = {}
    extra = ["--use_bf16", "true"] + ["--pde_bf16", "true"] * pde_bf16
    jets, other = ("jet_fwd", "jet_bwd"), ("jet_fwd_bf16", "jet_bwd_bf16")
    if pde_bf16:
        jets, other = other, jets
    policy = f"policy=bf16 (jet {'bf16' if pde_bf16 else 'f32'})"

    def train(name, driver, flags, points):
        res, paths[name] = traced_path(
            lambda: driver.main(flags + extra + ["--epochs", "2"]), name,
            jets + ("decode_blend_gather_bf16",))
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
        return res

    tag = "pde_bf16" if pde_bf16 else "bf16"

    def own_eval(family, log_dir, res):
        if evaluate:
            paths.update(own_run_eval(
                card, f"{family}_{tag}_ckpt_eval", family, log_dir,
                live_weights({res["step"]: res["state"]}), dtype="bfloat16"))

    with tempfile.TemporaryDirectory() as tmp:
        taylor_green_folder(tmp)
        log_dir = os.path.join(tmp, "log")
        own_eval("rb2d", log_dir, train(
            f"rb2d_{tag}_train", load_driver("rb2d", "train_torch.py"),
            rb2d_flags(tmp, log_dir), 8 * 1024))
    with tempfile.TemporaryDirectory() as tmp:
        beltrami_files(tmp, (42, 100, 101, 7))
        log_dir = os.path.join(tmp, "log")
        own_eval("turb3d", log_dir, train(
            f"turb3d_{tag}_train", load_driver("turb3d", "train_torch.py"),
            turb3d_flags(tmp, log_dir), 4 * 1024))
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
    tiles = fq.decode_tiles(packed, nf=imnet.nf, dim=dim, pregathered=True)
    row, got = bf16_decode_vs_twin(
        "decode_blend_bf16",
        lambda: fq.decode_blend(feats2, frac, packed, tiles=tiles, **kw),
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
    from space_time_pde_torch.physics import get_pde_layer
    from space_time_pde_torch.train import (
        build_models, init_state, make_loss_fn, make_optimizer,
        make_train_step)
    from space_time_pde_torch.train.optim import counter_values
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
                  if counter_values(state.opt_state)[k] != want_opt[k]]
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
    counters = counter_values(state.opt_state)
    say(f"resumed the exported JAX run at step {state.step}: {n_tensors} "
        f"tensors and the counters {counters} equal the export bit for "
        f"bit: {not mismatched}; lr at count "
        f"{counters['count']} with --epochs {RESUME_EPOCHS}: "
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
        res, launches = traced_path(lambda: train_torch.main(
            rb2d_flags(tmp, os.path.join(tmp, "log")) + [
                "--resume", OPT_ASSET, "--epochs", str(RESUME_EPOCHS),
                "--run_epochs", "1", "--cliff_recovery", "false"]),
            "the train CLI resumed from the export", ("jet_fwd", "jet_bwd"))
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
# Phase P: the captured step (one CUDA graph a dispatch, the train CLIs'
# step on a card) against the eager step, from the same state on the same
# batches. Two eager runs agree bit for bit on the card (checked here at
# one step a dispatch), so the captured step must too.

def p_batches(batch, inner, n, seed):
    """``n`` dispatches of host batches (``inner`` steps each, stacked
    when ``inner`` > 1) around the reference batch: seeded points, the
    low-res input moved by a seeded 1% of its largest value."""
    rng = np.random.RandomState(seed)
    ref = {k: v.cpu().numpy() for k, v in batch.items()}
    scale = 0.01 * float(np.abs(ref["lres"]).max())
    out = []
    for _ in range(n):
        steps = [{"lres": (ref["lres"] + scale * rng.randn(
                      *ref["lres"].shape)).astype(np.float32),
                  "point_coord": rng.rand(
                      *ref["point_coord"].shape).astype(np.float32),
                  "point_value": ref["point_value"]} for _ in range(inner)]
        out.append(steps[0] if inner == 1 else
                   {k: np.stack([s[k] for s in steps]) for k in steps[0]})
    return out


def p_run(state, start, step, batches):
    """``step`` over ``batches`` from the state ``start`` (put back in
    place first): (the written tensors' copies, the last metrics, the
    wrappers' launch counts, the step count, the last dispatch's
    seconds)."""
    from space_time_pde_torch.ops import fused_jet as fj

    with torch.no_grad():
        for k, t in written_tensors(state).items():
            t.copy_(start[k])
    state.step = 0
    fj.reset_launches()
    for b in batches:
        t = time.perf_counter()
        state, metrics = step(state, b)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    return ({k: t.clone() for k, t in written_tensors(state).items()},
            {k: v.clone() for k, v in metrics.items()}, dict(fj.LAUNCHES),
            state.step, seconds)


def captured_vs_eager(device, card):
    """Phase P: for rb2d and turb3d, under f32 and ``--use_bf16
    --pde_bf16``, 1 and 8 steps a dispatch: ``CapturedStep`` (its first
    dispatch the eager warm-up, its second the capture) against the eager
    steps from the same seeded state on the same seeded batches (4
    dispatches at 1 step, 3 at 8), every parameter, buffer, moment,
    counter and metric bit for bit, with the same step count; at 1 step a
    dispatch two eager runs too. The jet wrappers count the eager steps'
    launches and the captured step's warm-up alone. One dispatch of
    non-finite batches leaves the parameters, buffers and moments
    untouched and advances ``notfinite_count`` on the device. s/step of
    the last dispatch of each (no trace); then one more dispatch of each
    (of the captured step alone at 8 steps a dispatch) under a device
    trace: its jet launches, graph replays included, and the idle share,
    1 - the device's busy time / the wall time of that traced dispatch
    (the tracer's own cost included), beside 1 - busy / the untraced
    s/step."""
    from space_time_pde_torch.train import (
        CapturedStep, make_loss_fn, make_multi_step, make_train_step)

    t_p = time.perf_counter()
    upload = lambda b: {k: torch.from_numpy(v).to(device)
                        for k, v in b.items()}
    for recipe, ref_path in (("rb2d", STEP_REF),
                             ("turb3d", TURB3D_STEP_REF)):
        for policy in ("f32", "bf16_pde"):
            bf16 = policy != "f32"
            jets = (("jet_fwd_bf16", "jet_bwd_bf16") if bf16
                    else ("jet_fwd", "jet_bwd"))
            cfg, pde, opt, state, batch, _, _ = reference_step(
                ref_path, device, use_bf16=bf16, pde_bf16=bf16)
            start = {k: t.clone() for k, t in
                     written_tensors(state).items()}
            loss_fn = make_loss_fn(cfg, state.unet, state.imnet, pde)
            for inner in (1, 8):
                what = f"{recipe} {policy} at {inner} step(s) a dispatch"
                host = p_batches(batch, inner, 4 if inner == 1 else 3,
                                 seed=inner)
                batches = [upload(b) for b in host]
                eager = (make_train_step(loss_fn, opt) if inner == 1
                         else make_multi_step(loss_fn, opt, inner))
                runs = {"eager": p_run(state, start, eager, batches)}
                if inner == 1:
                    runs["eager twin"] = p_run(state, start, eager,
                                               batches)
                step = CapturedStep(loss_fn, opt, inner, device)
                runs["captured"] = p_run(state, start, step, batches)
                want, wm, _, ws, _ = runs["eager"]
                for mode, (got, gm, gl, gs, _) in runs.items():
                    moved = [k for k in want
                             if not torch.equal(got[k], want[k])]
                    moved += [f"metric {k}" for k in wm
                              if not torch.equal(gm[k], wm[k])]
                    wrapped = inner * (1 if mode == "captured"
                                       else len(batches))
                    if moved or gs != ws or any(gl[k] != wrapped
                                                for k in jets):
                        raise SystemExit(
                            f"phase P, {what}: {mode} differs from eager: "
                            f"{len(moved)} moved {moved[:6]}; wrapper "
                            f"launches {gl} (want {wrapped} of {jets}); "
                            f"step {gs} vs {ws}")
                # One dispatch of non-finite batches through the graph.
                held = {k: t.clone() for k, t in
                        written_tensors(state).items()}
                bad = {k: v.copy() for k, v in host[0].items()}
                bad["lres"][...] = np.nan
                state, _ = step(state, upload(bad))
                torch.cuda.synchronize()
                after = written_tensors(state)
                changed = sorted(k for k in held
                                 if not torch.equal(after[k], held[k]))
                nf = int(after["counter/notfinite_count"]) - int(
                    held["counter/notfinite_count"])
                skipped = ["counter/last_finite", "counter/notfinite_count",
                           "counter/total_notfinite"]
                if not bool(held["counter/last_finite"]):
                    skipped = skipped[1:]
                if changed != skipped or nf != inner or \
                        bool(after["counter/last_finite"]):
                    raise SystemExit(
                        f"phase P, {what}: a non-finite dispatch changed "
                        f"{changed[:6]}, notfinite_count +{nf}")
                # One traced dispatch of each (eager at 1 step a dispatch
                # only: 8 eager steps under the tracer cost ~4 s): launches
                # and idle share.
                sec = {m: runs[m][4] / inner for m in ("eager", "captured")}
                idle = []
                for mode, fn in (("eager", eager), ("captured", step))[
                        inner > 1:]:
                    _, counts, busy, wall = traced(
                        lambda: fn(state, batches[-1]))
                    if [counts[k] for k in jets] != [inner] * 2:
                        raise SystemExit(
                            f"phase P, {what}: the {mode} dispatch's trace "
                            f"shows jet launches {counts}, not {inner} "
                            f"of {jets}")
                    idle.append(
                        f"{mode} {1 - busy / wall:.3f} (busy "
                        f"{busy / inner:.3f} ms a step; 1 - busy / untraced "
                        f"s/step {1 - busy / inner / (sec[mode] * 1e3):.3f})")
                say(f"phase P {what}: captured == eager bit for bit "
                    f"({len(want)} tensors, {len(wm)} metrics, step {ws}"
                    + (", two eager runs equal" if inner == 1 else "")
                    + f"; jet launches a dispatch in the device trace "
                    f"{inner} each); non-finite dispatch: notfinite_count "
                    f"+{nf}, the state otherwise untouched; s/step eager "
                    f"{sec['eager']:.6f}, captured {sec['captured']:.6f} "
                    f"(untraced); idle share of a traced dispatch "
                    + ", ".join(idle) + f"; {card}")
                del step, runs
            del state
            torch.cuda.empty_cache()
    say(f"phase P took {time.perf_counter() - t_p:.1f} s")


# ------------------------------------------------------------------------
# Phase O: the eval CLIs on checkpoint directories (``--ckpt``). O2 runs
# inside the train phases, while their temporary directories live.


def o_eval(card, name, family, flags, dtype):
    """One phase-O run of ``family``'s eval CLI with ``flags`` on the card:
    prints its source, step, decode dtype and kernel, rel-L2, steady
    points/s and launches; it must decode in ``dtype`` through that
    dtype's gather kernel alone (no jet, no other decode). Returns
    (results, launches)."""
    from space_time_pde_torch.ops import fused_jet as fj
    from space_time_pde_torch.ops import fused_query as fq

    fj.reset_launches()
    fq.reset_launches()
    res = load_driver(family, "evaluation_torch.py").main(
        flags + ["--device", "cuda"])
    torch.cuda.synchronize()
    launches = {**fj.LAUNCHES, **fq.LAUNCHES}
    prov = res["provenance"]
    kernel = ("decode_blend_gather_bf16" if dtype == "bfloat16"
              else "decode_blend_gather")
    rate = res.get("steady_pts_per_s")
    say(f"{name}: {res['source']} step {res['step']}; decode dtype "
        f"{prov['compute_dtype']} kernel {prov['kernel']}; windows "
        f"{res['t0s']} rel-L2 " + ", ".join(f"{r:.6g}" for r in
                                          res["rel_l2"])
        + (f"; {rate / 1e6:.3f}M pts/s over windows 2+ on {card}"
           if rate else "") + f"; launches {launches}")
    stray = sorted(k for k, n in launches.items() if n and k != kernel)
    if launches[kernel] < 1 or stray or prov["compute_dtype"] != dtype or \
            not np.isfinite(res["rel_l2"]).all() or \
            not torch.isfinite(res["window0"]).all():
        raise SystemExit(f"{name}: the eval did not decode {dtype} through "
                         f"{kernel} alone (also launched {stray}) to finite "
                         "values")
    return res, launches


def live_weights(states):
    """Phase O2's weights from the runs of this process: {step: the
    ``TrainState`` a run ended with} -> ``weights(step)``, the (UNet,
    ImNet) state dicts of the run that saved ``step``."""
    def weights(step):
        if step not in states:
            raise SystemExit(f"no run ended at the newest checkpoint's step "
                             f"{step} (the runs ended at {sorted(states)})")
        return states[step].unet.state_dict(), states[step].imnet.state_dict()
    return weights


def file_weights(ckpt_dir):
    """Phase O2's weights of a run in other processes: the newest
    ``ckpt_<step>.pt`` read with a plain ``torch.load``, its tensors
    split into the two state dicts."""
    newest = max((n for n in os.listdir(ckpt_dir)
                  if re.fullmatch(r"ckpt_\d+\.pt", n)),
                 key=lambda n: int(n[5:-3]))
    payload = torch.load(os.path.join(ckpt_dir, newest), map_location="cpu",
                         weights_only=True)
    tensors = {**payload["params"], **payload["buffers"]}

    def weights(step):
        if step != payload["step"]:
            raise SystemExit(f"{newest} holds step {payload['step']}, the "
                             f"eval read step {step}")
        return tuple({k.partition(".")[2]: v for k, v in tensors.items()
                      if k.startswith(f"{m}.")} for m in ("unet", "imnet"))
    return weights


def own_run_eval(card, name, family, log_dir, weights, dtype="float32"):
    """Phase O2: ``family``'s eval CLI with ``--ckpt <log_dir>/checkpoints``
    on 2 windows; window 0 must equal, bit for bit, the decode of
    ``inference.make_dense_decoder`` over models that the trainer builds
    at the eval grid (the saved config's), given ``weights(step)``.
    Returns {``name``: the eval's launches}."""
    from space_time_pde_torch.inference import decode_dtype, \
        make_dense_decoder
    from space_time_pde_torch.train import build_models
    from space_time_pde_torch.utils.checkpoint import latest_checkpoint
    from space_time_pde_torch.utils.config import Config

    t0 = time.perf_counter()
    ckpt_dir = os.path.join(log_dir, "checkpoints")
    res, launches = o_eval(card, name, family, [
        "--ckpt", ckpt_dir, "--eval_windows", "2",
        "--save_path", os.path.join(log_dir, "pred_ckpt.npz")], dtype)
    cfg = Config.from_dict(latest_checkpoint(ckpt_dir)["extra"]["config"])
    unet_sd, imnet_sd = weights(res["step"])
    igres = tuple(res["lres0"].shape[:-1])
    unet, imnet = build_models(cfg, igres, torch.device("cuda"))
    unet.load_state_dict(unet_sd)
    imnet.load_state_dict(imnet_sd)
    decoder = make_dense_decoder(
        unet.eval(), imnet.eval(), tuple(res["window0"].shape[:-1]),
        chunk=res["provenance"]["chunk"],
        compute_dtype=decode_dtype("auto", cfg.model.use_bf16))
    with torch.no_grad():
        want = decoder(res["lres0"])
    torch.cuda.synchronize()
    same = torch.equal(res["window0"], want)
    diff = "" if same else (f" (max |diff| "
                            f"{(res['window0'] - want).abs().max():.3e})")
    say(f"{name}: window 0 {tuple(want.shape)} equals the decode of models "
        f"built at the eval grid {igres} from the run's weights bit for "
        f"bit: {same}{diff}; phase O2 run {time.perf_counter() - t0:.1f} s")
    if not same:
        raise SystemExit(f"{name}: --ckpt decoded otherwise than the run's "
                         "own weights")
    return {name: launches}


def ckpt_vs_params(card):
    """Phase O1: port checkpoint directories holding the committed JAX
    exports' weights, evaluated with ``--ckpt`` and, beside, the exports
    with ``--params`` on phase 5's three Taylor–Green windows (rb2d) and
    phase 12's four val windows (turb3d): window 0, the per-window
    rel-L2 and the saved predictions equal bit for bit. Returns each
    run's launches."""
    from space_time_pde_torch.bridge import load_exported, load_flax_params
    from space_time_pde_torch.data import save_npz, taylor_green_fields
    from space_time_pde_torch.train import (
        build_models, init_state, make_optimizer)
    from space_time_pde_torch.utils.checkpoint import (
        CheckpointManager, restore_exported)
    from space_time_pde_torch.utils.config import Config

    device = torch.device("cuda")
    paths = {}

    def anchor(family, ckpt_dir, export, data_flags, tmp):
        runs = {}
        for flag, src in (("--ckpt", ckpt_dir), ("--params", export)):
            name = f"{family}_{flag[2:]}_anchor_eval"
            save = os.path.join(tmp, f"{name}.npz")
            runs[flag], paths[name] = o_eval(
                card, name, family, [flag, src, *data_flags, "--save_path",
                                     save], "float32")
            with np.load(save) as z:
                runs[flag]["saved"] = {k: z[k] for k in z.files}
        got, want = runs["--ckpt"], runs["--params"]
        same = {
            "window0": torch.equal(got["window0"], want["window0"]),
            "rel_l2": got["rel_l2"] == want["rel_l2"],
            "t0s": got["t0s"] == want["t0s"],
            "saved": sorted(got["saved"]) == sorted(want["saved"]) and all(
                np.array_equal(v, want["saved"][k])
                for k, v in got["saved"].items()),
            "step": got["step"] == want["step"]}
        say(f"{family}: --ckpt equals --params bit for bit: {same}")
        if not all(same.values()):
            raise SystemExit(f"{family}: --ckpt and --params disagree: "
                             f"{[k for k, v in same.items() if not v]}")

    with tempfile.TemporaryDirectory() as tmp:
        exported = load_exported(OPT_ASSET)
        cfg = Config.from_dict(exported["config"])
        d = cfg.data
        unet, imnet = build_models(cfg, (d.nt // d.downsamp_t,
                                         d.nz // d.downsamp_xz,
                                         d.nx // d.downsamp_xz), device)
        state, extra = restore_exported(
            init_state(cfg.train.seed, unet, imnet, make_optimizer(cfg)),
            OPT_ASSET)
        ckpt_dir = os.path.join(tmp, "rb2d_ckpt")
        CheckpointManager(ckpt_dir).save(state.step, state, extra=extra)
        del state, unet, imnet
        with np.load(os.path.splitext(ASSET)[0] + "_ref.npz") as z:
            tg_nt, out_shape = int(z["tg_nt"]), tuple(int(s) for s in
                                                      z["out_shape"])
        save_npz(os.path.join(tmp, "tg.npz"), taylor_green_fields(
            nt=tg_nt, nz=out_shape[1], nx=out_shape[2]))
        anchor("rb2d", ckpt_dir, ASSET, [
            "--data_folder", tmp, "--eval_data", "tg.npz",
            "--eval_windows", "3"], tmp)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        exported = load_exported(TURB3D_ASSET)
        cfg = Config.from_dict(exported["config"])
        targs = exported["meta"]["turb3d_args"]
        ds_xyz = targs["downsamp_xyz"]
        unet, imnet = build_models(
            cfg, (targs["nt"] // targs["downsamp_t"], targs["nz"] // ds_xyz,
                  targs["ny"] // ds_xyz, targs["nx"] // ds_xyz), device)
        state = init_state(cfg.train.seed, unet, imnet, make_optimizer(cfg))
        load_flax_params(state.unet, exported["params"]["unet"])
        load_flax_params(state.imnet, exported["params"]["imnet"])
        state.step = exported["step"]
        ckpt_dir = os.path.join(tmp, "turb3d_ckpt")
        CheckpointManager(ckpt_dir).save(state.step, state, extra={
            "config": exported["config"], "turb3d_args": targs,
            "channel_mean": exported["channel_mean"],
            "channel_std": exported["channel_std"]})
        del state, unet, imnet
        beltrami_files(tmp, (7,))
        anchor("turb3d", ckpt_dir, TURB3D_ASSET, [
            "--data_folder", tmp, "--split", "val", "--eval_windows", "4"],
            tmp)
    return paths


# ------------------------------------------------------------------------
# Phase S: the RB2D Boussinesq data generator on the card (the float64
# solver of data/rb2_solver.py, its Helmholtz solves on the tridiag
# kernel), held against the port's numpy copy of the solver.

STATS_ASSET = os.path.join(ASSETS, "rb2d_ra1e6_stats.npz")
# data/regen_rb2d.sh's flags, seed 42: 16,000 transient steps, then 200
# snapshots 80 steps apart.
REGEN_FLAGS = ["--nx", "512", "--nz", "128", "--rayleigh", "1e6",
               "--n_snapshots", "200", "--seed", "42"]
SOLVER_STEPS = 200
# The kernel against its plain twin, x max |x|: both do numpy's float64
# operations in numpy's order (no FMA), so they should agree exactly.
TRIDIAG_TOL = 1e-13
# The card solver against the numpy copy after SOLVER_STEPS steps, x max
# |numpy| of each field: cuFFT and pocketfft round differently, and the
# seeded start's first steps grow that rounding (the torch solver on the
# CPU reads ~2e-14 after 200 steps at 64 x 32, tests/
# test_torch_rb2_solver.py); from a developed state it stays at ~1e-15.
SEEDED_TOL, DEVELOPED_TOL = 1e-10, 1e-12
# A card seed's statistics against the numpy seed 42's
# (assets/rb2d_ra1e6_stats.npz): within STATS_SLACK times the distance
# between the numpy seeds 42 and 7 (a profile's distance is its max over
# z), never below STATS_FLOOR of the statistic's max |value|. The flow is
# chaotic: after 16,000 steps the card's trajectory is another sample of
# the same statistics, not the numpy one.
STATS_SLACK, STATS_FLOOR = 3.0, 1e-3
# float64 outside the tensor cores (NVIDIA's H100 SXM data sheet, 700 W).
FP64_FLOPS = 34e12


def _numpy_dt(s):
    """``simulate_rb2d``'s step for solver ``s``."""
    return min(0.2 * s.dx, 0.2 * s.dz, 0.2 * s.dz ** 2 / max(s.R, s.P))


def _solver_fields(s):
    """The state (``b, zeta, psi``) of solver ``s`` after its last step,
    then ``u, w`` (``velocities``) and ``p`` (``pressure``), as numpy
    float64 (card tensors copied)."""
    out = {k: getattr(s, k) for k in ("b", "zeta", "psi")}
    out = {k: v.clone() if torch.is_tensor(v) else v.copy()
           for k, v in out.items()}
    u, w = s.velocities()
    out.update(u=u, w=w, p=s.pressure(u, w, s.b))
    return {k: v.cpu().numpy() if torch.is_tensor(v) else v
            for k, v in out.items()}


def _fields_held(what, got, want, tol):
    """Each field's max |card - numpy| / max |numpy| beside ``tol``."""
    rel = {k: float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
           for k in want}
    say(f"phase S {what}: max |card - numpy| / max |numpy| "
        + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
        + f" (limit {tol:g})")
    bad = [k for k, v in rel.items() if not v <= tol]
    if bad:
        raise SystemExit(f"phase S {what}: {bad} beyond {tol:g} of max "
                         f"|numpy|: {rel}")
    return {"max_rel": max(rel.values()), "limit": tol, "fields": rel}


def tridiag_vs_plain(device):
    """Phase S (a): the kernel against ``thomas_plain`` on the card, both
    boundary kinds of the solver's operators (Dirichlet with the walls
    zeroed; Neumann with the kx = 0 mode pinned), at 128 x 257 (the
    512 x 128 grid) and at a ragged 16 x 45 (nx 88), seeded complex
    right-hand sides; CUDA-event times at 128 x 257, plain / kernel /
    kernel / plain."""
    from space_time_pde_torch.data.rb2_solver import RB2Solver
    from space_time_pde_torch.ops import tridiag as td

    rng = np.random.RandomState(0)
    row, worst = None, 0.0
    for nx, nz in ((512, 128), (88, 16)):
        s = RB2Solver(nx, nz, 4.0, 1.0, 1e6, 1.0, 0, device)
        nk = nx // 2 + 1
        rhs = torch.from_numpy(rng.randn(nz, nk)
                               + 1j * rng.randn(nz, nk)).to(device)
        for what, op in (("Dirichlet", s._psi_op),
                         ("Neumann, kx = 0 pinned", s._p_op)):
            kernel = lambda: td.tridiag(rhs, *op)
            plain = lambda: td.thomas_plain(rhs, *op)
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            worst = max(worst, err / scale)
            say(f"phase S (a) tridiag {nz} x {nk} {what}: max |kernel - "
                f"plain| {err:.3e} = {err / scale:.3e} of max |x| "
                f"{scale:.4e} (limit {TRIDIAG_TOL:g}); bit for bit: "
                f"{torch.equal(got, want)}")
            if not (err <= TRIDIAG_TOL * scale
                    and bool(torch.isfinite(got).all())):
                raise SystemExit(f"tridiag disagrees with thomas_plain at "
                                 f"{nz} x {nk} ({what}): {err:.3e}")
            if row is None:
                p1, k1, k2, p2 = (cuda_ms(f, r) for f, r in (
                    (plain, 3), (kernel, 200), (kernel, 200), (plain, 3)))
                n = nz * nk
                # rhs, c, inv read and x written once: 16 + 2 x 8 + 16
                # bytes an entry, and lower's nz float64 once; 10 float64
                # operations an entry.
                nbytes = 48 * n + 8 * nz
                t_mem = nbytes / HBM_BYTES * 1e3
                t_op = 10 * n / FP64_FLOPS * 1e3
                row = {"max_abs_err": err, "ms": (k1 + k2) / 2,
                       "plain_ms": (p1 + p2) / 2,
                       "bound_ms": max(t_mem, t_op),
                       "bound_by": "bytes" if t_mem >= t_op
                       else "operations", "library_ms": None,
                       "shape": [nz, nk]}
                say(f"phase S (a) tridiag {nz} x {nk}: kernel {k1:.4f}/"
                    f"{k2:.4f} ms, plain {p1:.3f}/{p2:.3f} ms, bound "
                    f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}: "
                    f"{nbytes} bytes, {10 * n} float64 operations)")
    row["max_rel_err"] = worst
    return row


def rb2d_generator(device, card, tmp):
    """Phase S: (a) the tridiag kernel against its twin; (b) the card
    solver against the numpy copy, 200 steps from seed 42 at 512 x 128,
    Ra 1e6, every field; (c) the same from a developed state (the numpy
    copy run to t = 10 at 64 x 32, Ra 1e5, seed 0), 200 steps both ways;
    (d) two card runs of (b) equal bit for bit, and the captured graph of
    one snapshot interval replayed twice equal to the same steps run
    eagerly, state and snapshot fields; one replay traced (the kernel
    runs in it; its device time); (e) ``generate_data_torch.main`` with
    ``data/regen_rb2d.sh``'s flags (seed 42) on the card, s per seed, its
    launches, the file's schema and its statistics against the numpy
    seeds' (``assets/rb2d_ra1e6_stats.npz``); (f) ``train_torch.main``
    with the flagship's flags for 2 epochs of 8 steps on that file. The
    seed's file stays in ``tmp`` (phase T trains on it). Returns
    ({"solver": readings}, the tridiag kernel's row)."""
    from space_time_pde_torch.data import generator as gen
    from space_time_pde_torch.data import rb2_solver as rb
    from space_time_pde_torch.data.rb2_solver import (RB2Solver,
                                                      flow_statistics)
    from space_time_pde_torch.ops import tridiag as td

    t_s = time.perf_counter()
    readings = {}
    row = tridiag_vs_plain(device)
    readings["a_tridiag_vs_plain"] = {"max_rel": row["max_rel_err"],
                                      "limit": TRIDIAG_TOL}

    # (b) and the first half of (d): two card runs of 200 steps.
    ref = gen._RB2Solver(512, 128, 4.0, 1.0, 1e6, 1.0, 42)
    dt = _numpy_dt(ref)
    runs = []
    for _ in range(2):
        s = RB2Solver(512, 128, 4.0, 1.0, 1e6, 1.0, 42, device)
        for _ in range(SOLVER_STEPS):
            s.step(dt)
        runs.append(_solver_fields(s))
    t0 = time.perf_counter()
    for _ in range(SOLVER_STEPS):
        ref.step(dt)
    numpy_s = time.perf_counter() - t0
    readings["b_seeded"] = _fields_held(
        f"(b) 512 x 128, Ra 1e6, seed 42, {SOLVER_STEPS} steps",
        runs[0], _solver_fields(ref), SEEDED_TOL)
    readings["b_seeded"]["numpy_ms_per_step_host"] = \
        numpy_s / SOLVER_STEPS * 1e3
    repeat = all(np.array_equal(runs[0][k], runs[1][k]) for k in runs[0])
    say(f"phase S (d) two card runs of (b): bit for bit {repeat}")

    # (c) from a developed state.
    ref = gen._RB2Solver(64, 32, 4.0, 1.0, 1e5, 1.0, 0)
    dt_c = _numpy_dt(ref)
    n_dev = int(round(10.0 / dt_c))
    for _ in range(n_dev):
        ref.step(dt_c)
    u_max = float(np.abs(ref.ddz(ref.psi)).max())
    w_max = float(np.abs(ref.ddx(ref.psi)).max())
    s = RB2Solver.from_state(ref.b, ref.zeta, ref.psi, 4.0, 1.0, 1e5, 1.0,
                             device)
    for _ in range(SOLVER_STEPS):
        ref.step(dt_c)
        s.step(dt_c)
    readings["c_developed"] = _fields_held(
        f"(c) 64 x 32, Ra 1e5, seed 0 after {n_dev} numpy steps (t = 10, "
        f"|u| {u_max:.3f}, |w| {w_max:.3f}), {SOLVER_STEPS} steps",
        _solver_fields(s), _solver_fields(ref), DEVELOPED_TOL)

    # (d) captured against eager over two snapshot intervals.
    n_per = max(1, int(round(0.125 / dt)))
    eager = RB2Solver(512, 128, 4.0, 1.0, 1e6, 1.0, 42, device)
    cap = RB2Solver(512, 128, 4.0, 1.0, 1e6, 1.0, 42, device)
    td.reset_launches()
    graph = cap.capture(n_per, dt)
    recorded = td.CAPTURED["tridiag"]
    captured = True
    for _ in range(2):
        for _ in range(n_per):
            eager.step(dt)
        graph.replay()
        fe, fc = _solver_fields(eager), _solver_fields(cap)
        captured &= all(np.array_equal(fe[k], fc[k]) for k in fe)
    # One traced replay of the interval gives a step's device time; its
    # count of tridiag records only shows that the kernel ran: in this
    # script a traced replay has read one record short (159 of 160, and 3
    # of a 2-step graph's 4) while captured == eager bit for bit showed
    # every solve ran. The launches a replay runs are the wrapper's count
    # of those it recorded in the capture.
    _, counts, busy, wall = traced(graph.replay)
    seen = counts["tridiag"]
    step_ms = busy / n_per
    say(f"phase S (d) captured == eager over 2 intervals of {n_per} steps "
        f"(state and snapshot fields) bit for bit: {captured}; the graph "
        f"holds {recorded} tridiag launches, one traced replay shows "
        f"{seen}; device busy {busy:.3f} ms of {wall:.3f} ms wall "
        f"({step_ms:.4f} ms a step) on {card}")
    readings["d_bit_for_bit"] = {"two_runs": repeat,
                                 "captured_vs_eager": captured}
    if not (repeat and captured) or recorded != 2 * n_per or \
            not 0 < seen <= recorded:
        raise SystemExit(f"phase S (d): two runs equal {repeat}, captured "
                         f"== eager {captured}, tridiag launches recorded "
                         f"{recorded} (want {2 * n_per}), traced {seen}")
    del eager, cap, graph
    torch.cuda.empty_cache()

    # (e) one seed through the CLI, the main path: the wrapper counts
    # the launches made from Python (the capture's warm-up step, the
    # snapshots) and those recorded into the graph, and simulate_rb2d
    # counts the graph's replays, each of which runs them again.
    path = os.path.join(tmp, "rb2d_ra1e6_s42.npz")
    cli = load_driver("rb2d", "generate_data_torch.py")
    td.reset_launches()
    rb.reset_replays()
    t0 = time.perf_counter()
    cli.main(REGEN_FLAGS + ["--out", path])
    seed_s = time.perf_counter() - t0
    eager_launches = td.LAUNCHES["tridiag"]
    per_replay = td.CAPTURED["tridiag"]
    replays = rb.REPLAYS["interval"]
    n_tr = int(round(25.0 / dt))
    want_replays = n_tr // n_per + 200
    want_eager = 2 + 2 * (n_tr % n_per) + 2 * 200
    launches = eager_launches + per_replay * replays
    say(f"phase S (e) one seed with data/regen_rb2d.sh's flags: "
        f"{seed_s:.2f} s on {card} ({n_tr} + 200 x {n_per} steps); "
        f"tridiag launches {launches} ({eager_launches} from Python, "
        f"{per_replay} in the graph x {replays} replays counted, want "
        f"{want_replays})")
    if eager_launches != want_eager or per_replay != 2 * n_per or \
            replays != want_replays:
        raise SystemExit(f"phase S (e): {eager_launches} tridiag "
                         f"launches from Python (want {want_eager}), "
                         f"{per_replay} in the graph (want "
                         f"{2 * n_per}), {replays} replays (want "
                         f"{want_replays})")
    with np.load(path) as z:
        fields = {k: z[k] for k in z.files}
    for k in ("p", "b", "u", "w"):
        v = fields[k]
        if v.shape != (200, 128, 512) or v.dtype != np.float32 or \
                not np.isfinite(v).all():
            raise SystemExit(f"phase S (e): {k} {v.dtype} {v.shape}, "
                             f"finite {np.isfinite(v).all()}")
    got = flow_statistics(fields)
    with np.load(STATS_ASSET) as z:
        seeds = list(z["seeds"])
        ref = {k: z[k] for k in got}
    i42, i7 = seeds.index(42), seeds.index(7)
    stats = {}
    for k in got:
        dist = float(np.abs(ref[k][i42] - ref[k][i7]).max())
        scale = float(np.abs(ref[k][i42]).max())
        limit = max(STATS_SLACK * dist, STATS_FLOOR * scale)
        d = float(np.abs(got[k] - ref[k][i42]).max())
        stats[k] = {"distance": d, "limit": limit,
                    "seeds_42_7": dist}
        say(f"phase S (e) {k}: |card - numpy s42| {d:.4e} (numpy "
            f"s42 - s7 {dist:.4e}; limit {limit:.4e})"
            + (f"; card {float(got[k]):.5f}, numpy s42 "
               f"{float(ref[k][i42]):.5f}, s7 {float(ref[k][i7]):.5f}"
               if np.ndim(got[k]) == 0 else ""))
        if not d <= limit:
            raise SystemExit(f"phase S (e): {k} {d:.4e} from numpy "
                             f"seed 42, beyond {limit:.4e}")
    readings["e_seed"] = {"seconds": seed_s, "steps": n_tr + 200 * n_per,
                          "device_ms_per_step": step_ms,
                          "stats": stats}

    # (f) the flagship's training on the file.
    log_dir = os.path.join(tmp, "log")
    flags = rb2d_flags(tmp, log_dir)
    for flag in ("--train_data", "--eval_data"):
        flags[flags.index(flag) + 1] = os.path.basename(path)
    run = load_driver("rb2d", "train_torch.py").main(
        flags + ["--epochs", "2"])
    losses = [e["loss"] for e in run["epochs"]]
    if len(losses) != 2 or not np.isfinite(
            [e[k] for e in run["epochs"] for k in e
             if k.endswith("loss")]).all():
        raise SystemExit(f"phase S (f): {run['epochs']}")
    say(f"phase S (f) train_torch on the card's seed, 2 epochs x 8 "
        f"steps at the flagship widths: losses "
        + ", ".join(f"{v:.5f}" for v in losses))
    readings["f_train_losses"] = losses
    say(f"phase S took {time.perf_counter() - t_s:.1f} s")
    row.update(launches=launches, launches_from_python=eager_launches,
               launches_in_graph_replays=per_replay * replays)
    return {"solver": readings, "card": card}, row


# ------------------------------------------------------------------------
# Phase T: the turb3d data CLI on the card, and the first epochs of a
# from-scratch training run (scripts/train_from_scratch.py --smoke).

# A card field against the numpy copy's, x its max |value|: the closed
# form in float64 on the card (whose sin, cos and exp round otherwise
# than numpy's), cast once to float32 as the numpy copy casts.
BELTRAMI_TOL = 2.0 ** -22
BELTRAMI_SEEDS = (7, 123)


def turb3d_data_and_scratch(card, tmp):
    """Phase T: (a) ``experiments/turb3d/generate_data_torch.py`` on the
    card for seeds 7 and 123 at its default flags, every field within
    BELTRAMI_TOL of its max |value| from the numpy copy's
    (``beltrami_fields``), timed; (b) ``scripts/train_from_scratch.py
    --smoke``: the rb2d flagship's ``command.sh`` under f32, 2 epochs of
    its 256 steps on phase S's seed (in ``tmp``) as train and val data,
    every epoch's curve keys present and finite; its launches, the
    wrappers' from Python plus those the captured step's graph replays
    ran (``REPLAYED``): each jet once a step. Returns ({"turb3d_data",
    "from_scratch"} readings, the launches of (b))."""
    from space_time_pde_torch.data import generator as gen
    from space_time_pde_torch.ops import fused_jet as fj
    from space_time_pde_torch.ops import fused_query as fq
    from space_time_pde_torch.train import REPLAYED, reset_replayed

    t_t = time.perf_counter()
    cli = load_driver("turb3d", "generate_data_torch.py")
    data = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for seed in BELTRAMI_SEEDS:
            path = os.path.join(out_dir, f"beltrami_s{seed}.npz")
            t0 = time.perf_counter()
            cli.main(["--seed", str(seed), "--out", path])
            seconds = time.perf_counter() - t0
            want = gen.beltrami_fields(seed)
            with np.load(path) as z:
                got = {k: z[k] for k in z.files}
            rel = {k: float(np.abs(got[k] - want[k]).max()
                            / np.abs(want[k]).max())
                   for k in ("p", "u", "v", "w")}
            same = sorted(got) == sorted(want) and all(
                got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
                for k in want) and all(
                float(got[k]) == float(want[k]) for k in want
                if np.ndim(want[k]) == 0)
            say(f"phase T (a) beltrami seed {seed} on the card: {seconds:.3f} "
                f"s (npz written); max |card - numpy| / max |numpy| "
                + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
                + f" (limit {BELTRAMI_TOL:.3e}); schema and scalars equal: "
                f"{same}")
            if not same or not all(v <= BELTRAMI_TOL for v in rel.values()):
                raise SystemExit(f"phase T (a): seed {seed}: {rel}, schema "
                                 f"{same}")
            data[seed] = {"seconds": seconds, "max_rel": rel}

    work = os.path.join(tmp, "scratch")
    os.makedirs(os.path.join(work, "data"))
    os.link(os.path.join(tmp, "rb2d_ra1e6_s42.npz"),
            os.path.join(work, "data", "rb2d_ra1e6_s42.npz"))
    tfs = load_module("scripts", "train_from_scratch.py")
    fj.reset_launches()
    fq.reset_launches()
    reset_replayed()
    res = tfs.main(["--recipe", "rb2d", "--policy", "f32", "--work", work,
                    "--smoke"])
    torch.cuda.synchronize()
    wrapped = {**fj.LAUNCHES, **fq.LAUNCHES}
    launches = {k: wrapped[k] + REPLAYED[k] for k in wrapped}
    train = res["train"]
    say(f"phase T (b) train_from_scratch --smoke: {train['epochs']} epochs "
        f"to step {train['step']}, {train['sec_per_step_mean']:.6f} s/step "
        f"after the first epoch on {card}; skipped-update epochs "
        f"{len(train['skipped_updates'])}, recoveries "
        f"{len(train['recoveries'])}; curve keys ok {res['curve']['ok']}; "
        f"launches {launches} (from Python {wrapped}, in graph replays "
        f"{dict(REPLAYED)})")
    if not res["ok"] or train["step"] != 512 or res["data"]["made"]:
        raise SystemExit(f"phase T (b): ok {res['ok']}, step {train['step']} "
                         f"(want 512), data files made {res['data']['made']} "
                         f"(want 0: phase S's seed)")
    for k in ("jet_fwd", "jet_bwd"):
        if launches[k] != train["step"]:
            raise SystemExit(f"phase T (b): {k} launched {launches[k]} times "
                             f"in {train['step']} steps")
    if launches["decode_blend_gather"] < 1:
        raise SystemExit("phase T (b): the epoch eval launched no "
                         "decode_blend_gather")
    say(f"phase T took {time.perf_counter() - t_t:.1f} s")
    readings = {"turb3d_data": {"limit": BELTRAMI_TOL, "seeds": data},
                "from_scratch": {
                    k: res[k] for k in ("recipe", "policy", "steps_per_epoch",
                                        "ok")}}
    readings["from_scratch"].update(
        step=train["step"], sec_per_step=train["sec_per_step_mean"],
        skipped_updates=train["skipped_updates"],
        recoveries=train["recoveries"], curve_keys_ok=res["curve"]["ok"])
    return readings, launches


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
    for src in ("fused_query", "fused_query_bf16", "fused_jet",
                "fused_jet_bf16", "tridiag"):
        for line in ptxas_summary(log.get(src, "")):
            print(f"{src}.cu {line}", flush=True)
    for dim in (3, 4):
        plan = f32_plan(dim)
        print(f"fused_query.cu plan at C = 64, nf = 64, D = {dim} (both "
              f"entries): {plan['smem']} bytes of shared memory a CTA, "
              f"{plan['stages']} ring slots of {plan['slot']} bytes, kx "
              f"{plan['kx']}, weight image {plan['image']} f32 values, "
              f"clusters of {plan['cluster']} CTAs, {plan['rows']} corner "
              f"rows a tile, widths of nf = {plan['base']}",
              flush=True)
    for dim, pre in ((3, 0), (4, 0), (3, 1), (4, 1)):
        plan = bf16_plan(dim, pre)
        print(f"fused_query_bf16.cu plan at C = 64, nf = 64, D = {dim}, "
              f"{'pre-gathered' if pre else 'gather'}: {plan['smem']} bytes "
              f"of shared memory a CTA, {plan['stages']} ring stages of "
              f"16 KB, kx {plan['kx']}, tile image {plan['image']} bf16 "
              f"values, clusters of {plan['cluster']} CTAs, "
              f"{plan['rows']} corner rows a tile", flush=True)
    for src in ("fused_query", "fused_query_bf16", "fused_jet",
                "fused_jet_bf16"):
        sass, c7520 = sass_counts(src), log.get(src, "").count("C7520")
        print(f"{src}.cu SASS: {sass}; ptxas notes of serialized wgmma "
              f"(C7520): {c7520}", flush=True)
        if src in ("fused_query", "fused_jet") and (
                c7520 or isinstance(sass, dict) and (
                    sass["HGMMA"] < 1 or sass["HMMA"] > 0)):
            raise SystemExit(f"{src}.cu: the f32 kernels must run on wgmma "
                             f"(HGMMA), with no mma.sync (HMMA) and no "
                             f"serialized wgmma (C7520)")
    ring = (ctypes.c_longlong * 4)()
    for what, mt, staging in (("forward layers and chain product, D = 3",
                               4, 1),
                              ("forward layers and chain product, D = 4",
                               5, 1),
                              ("split-K weight gradients, 256 rows", 4, 0)):
        _build.load("fused_jet_bf16").stpde_jet_bf16_ring(mt, staging, ring)
        print(f"fused_jet_bf16.cu ring of the {what}: {ring[1]} stages of "
              f"{ring[0]} bytes, {ring[2]} bytes of shared memory a CTA of "
              f"{ring[3]} threads", flush=True)
    from space_time_pde_torch.ops import fused_jet as fj
    for dim in (3, 4):
        kc = fj.f32_chain_cols(dim)
        for what, mt, kn, staging in (
                ("forward layers and chain product", dim + 1, kc, 1),
                ("d feats", 4, fj.F32_FEAT_COLS, 0)):
            _build.load("fused_jet").stpde_jet_f32_ring(mt, kn, staging,
                                                        ring)
            print(f"fused_jet.cu ring of the {what}, D = {dim}: {ring[1]} "
                  f"stages of {ring[0]} bytes ({mt} A tiles, {kn} columns "
                  f"a consumer), {ring[2]} bytes of shared memory a CTA "
                  f"of {ring[3]} threads", flush=True)
    for mt in (1, 2, 4):
        _build.load("fused_jet").stpde_jet_f32_ring(mt, fj.F32_TN_COLS, 0,
                                                    ring)
        print(f"fused_jet.cu ring of the split-K weight gradients, "
              f"{64 * mt} rows: {ring[1]} stages of {ring[0]} bytes, "
              f"{ring[2]} bytes of shared memory", flush=True)
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
    rb2d_train, ckpt_paths = rb2d_train_path(card)      # + phase O2
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
    train_step_vs_jax(device, TURB3D_STEP_REF, median_limit=STEP_MEDIAN)
    torch.cuda.empty_cache()
    turb3d_train, o2 = turb3d_train_path(card)          # + phase O2
    ckpt_paths.update(o2)
    torch.cuda.empty_cache()

    # Phase A: the rb2d eval path on real RB2D windows.
    rb2d_eval_real = rb2d_real_windows(device, card)
    torch.cuda.empty_cache()

    # Phase B: a BatchNorm step against JAX, then BatchNorm training.
    say(f"rb2d BatchNorm training step vs the JAX-CPU reference "
        f"({os.path.relpath(BN_STEP_REF, ROOT)}):")
    train_step_vs_jax(device, BN_STEP_REF)
    torch.cuda.empty_cache()
    rb2d_bn_train, o2 = rb2d_train_path(                # + phase O2
        card, "--norm", "batch", what="rb2d BatchNorm",
        ckpt_path="rb2d_bn_ckpt_eval")
    ckpt_paths.update(o2)
    torch.cuda.empty_cache()

    # Phase C: a JAX run resumed in the port.
    rb2d_resume = resume_from_jax(device, card)
    torch.cuda.empty_cache()

    # Phases D-F: the parallel paths (ranks in processes of their own).
    # Phase O2 on rank 0's checkpoint of the sharded-encoder CLI run.
    with tempfile.TemporaryDirectory() as tmp:
        parallel = parallel_phases(card, tmp)
        log_f1 = os.path.join(tmp, "log_f1")
        ckpt_paths.update(own_run_eval(
            card, "rb2d_dp_sp_sharded_ckpt_eval", "rb2d", log_f1,
            file_weights(os.path.join(log_f1, "checkpoints"))))
    torch.cuda.empty_cache()

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
    bf16_paths.update(bf16_train_clis(card, pde_bf16=True,
                                      evaluate=True))  # + phase O2
    torch.cuda.empty_cache()
    say(f"phases K-N took {time.perf_counter() - t_kn:.1f} s")

    # Phase P: the captured step against the eager step.
    captured_vs_eager(device, card)
    torch.cuda.empty_cache()

    # Phase O1: --ckpt against --params on the committed exports.
    t_o = time.perf_counter()
    ckpt_paths.update(ckpt_vs_params(card))
    torch.cuda.empty_cache()
    say(f"phase O1 took {time.perf_counter() - t_o:.1f} s; phase O ran "
        f"{sorted(ckpt_paths)}")

    # Phase S: the RB2D data generator on the card; phase T: the turb3d
    # data CLI, and the rb2d recipe trained from scratch on S's seed.
    with tempfile.TemporaryDirectory() as tmp:
        solver, tridiag_row = rb2d_generator(device, card, tmp)
        torch.cuda.empty_cache()
        phase_t, scratch = turb3d_data_and_scratch(card, tmp)
    torch.cuda.empty_cache()

    by_path = {"rb2d_eval": rb2d_eval, "rb2d_train": rb2d_train,
               "turb3d_eval_val": turb3d_eval["val"],
               "turb3d_eval_test": turb3d_eval["test"],
               "turb3d_train": turb3d_train,
               "rb2d_eval_real": rb2d_eval_real,
               "rb2d_bn_train": rb2d_bn_train, "rb2d_resume": rb2d_resume,
               **parallel, **bf16_paths, **ckpt_paths,
               "rb2d_from_scratch": scratch}
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
    # The data generator's kernel replaces numpy code, no TPU kernel.
    kernels.append({"name": "tridiag", "route": "cuda", "math": "fp64",
                    "source": "space_time_pde_torch/csrc/tridiag.cu",
                    "replaces": "space_time_pde_tpu/data/generator.py:80",
                    "replaces_kind": "numpy (_thomas_batched), no TPU "
                                     "kernel",
                    "path": "rb2d_data",
                    "launches_by_path": {"rb2d_data":
                                         tridiag_row["launches"]},
                    **tridiag_row})
    say("done")
    print(json.dumps(solver))
    print(json.dumps({"phase_t": phase_t}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2])
    else:
        main()
