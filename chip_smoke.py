"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases (any failure raises and exits non-zero):

1. require a CUDA device; print the card (``nvidia-smi`` name and power
   limit), the torch / CUDA / sympy versions and both TF32 flags
   (switched off);
2. build every kernel from ``space_time_pde_torch/csrc`` (one nvcc per
   source, in parallel);
3. both decode kernels against their plain PyTorch twins on the card,
   at the flagship widths (C = 64, nf = 64, D = 3, out = 4) on 65,536
   seeded points that include lattice faces, cell edges and points
   outside the domain; tolerance rtol = atol = 1e-4 (both f32; only the
   summation order and the order of the blend-before-head rounding
   differ); CUDA-event times of both;
4. both jet kernels against their plain twins at the flagship widths on
   8,192 such points (the flagship step's count): the forward's value,
   Jacobian and Hessian blocks against ``jet_fwd_plain``, the backward's
   d feats2 and 9 parameter gradients for a seeded cotangent against
   autograd through it. The plain twin also runs in float64 on the card;
   per quantity, the kernel may sit at most JET_SLACK times as far from
   it as the f32 twin does, ``|err| <= rtol |ref| + atol max|ref|``
   (``atol_needed`` below; floor JET_FLOOR). CUDA-event times, plain /
   kernel / kernel / plain;
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
10. one JSON line of all four kernels (``path``: eval, train or
    off_path), then the status line.

Imports nothing of JAX or of the JAX package.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(ROOT, "space_time_pde_torch", "assets",
                     "r5_rb2d_4x_e900_230400.npz")
STEP_REF = os.path.join(ROOT, "space_time_pde_torch", "assets",
                        "rb2d_train_step_ref.npz")
N_CHECK = 65536                 # points per decode kernel-vs-plain call
N_JET = 8192                    # the flagship step: 8 crops x 1,024 points
RTOL = ATOL = 1e-4              # decode kernel vs plain, f32 both
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
# a scale-relative floor, never below JET_FLOOR of max |ref|.
JET_RTOL, JET_SLACK, JET_FLOOR = 1e-4, 2.0, 1e-6
# Training step vs the JAX reference: loss terms against JAX float32;
# every gradient leaf against float64, point by point, with atol (a
# fraction of the leaf's max |g64|) twice the largest that JAX float32
# itself needs over all leaves (3.18e-4, read from the reference file).
# Not per leaf: the f32 gradient's error comes mostly from mask flips
# (pre-activations within rounding of 0 take the other LeakyReLU branch,
# which moves that point's Jacobian and Hessian by a finite step), so
# any one leaf's error is a draw of a few discrete events. On the CPU
# the port's plain path lands 1-5x JAX's distance per leaf in norm, and
# needs at most 2.9e-4 point by point.
LOSS_RTOL = 1e-4
STEP_SLACK = 2.0
REPLACES = {
    "decode_blend_gather": "space_time_pde_tpu/ops/fused_query.py:244",
    "decode_blend": "space_time_pde_tpu/ops/fused_query.py:400",
    "jet_fwd": "space_time_pde_tpu/ops/fused_jet.py:175",
    "jet_bwd": "space_time_pde_tpu/ops/fused_jet.py:219",
}
SOURCES = {
    "decode_blend_gather": "space_time_pde_torch/csrc/fused_query.cu",
    "decode_blend": "space_time_pde_torch/csrc/fused_query.cu",
    "jet_fwd": "space_time_pde_torch/csrc/fused_jet.cu",
    "jet_bwd": "space_time_pde_torch/csrc/fused_jet.cu",
}
PATHS = {"decode_blend_gather": "eval", "decode_blend": "off_path",
         "jet_fwd": "train", "jet_bwd": "train"}


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
    """n query points in [0, 1]^3 coordinates: uniform ones that
    overshoot the domain, points on the domain faces, and points on
    lattice nodes (cell edges and corners)."""
    n4 = n // 4
    uniform = rng.uniform(-0.05, 1.05, (n - 2 * n4, 3))
    faces = rng.rand(n4, 3)
    axis = rng.randint(0, 3, n4)
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


def kernel_vs_plain(imnet, device):
    """Phase 3: both decode entry points against their plain twins."""
    from space_time_pde_torch.ops import fused_query as fq
    from space_time_pde_torch.ops.grid_interp import _locate

    rng = np.random.RandomState(0)
    spatial = (4, 16, 64)                     # flagship eval latent grid
    grid = torch.from_numpy(
        rng.randn(*spatial, imnet.in_features).astype(np.float32)).to(device)
    pts = torch.from_numpy(check_points(rng, spatial, N_CHECK)).to(device)
    cell, frac = _locate(pts, spatial, 0.0, 1.0)
    cell_flat = fq._flat_cells(cell, spatial)
    table = fq.cell_major_features(grid).contiguous()
    feats2 = table[cell_flat.long()].reshape(-1, grid.shape[-1]).contiguous()
    packed = fq.pack_imnet_params(imnet)
    kw = dict(nf=imnet.nf, activation=imnet.activation,
              negative_slope=imnet.negative_slope)
    calls = {
        "decode_blend_gather": (
            lambda: fq.decode_blend_gather(table, cell_flat, frac, packed,
                                           **kw),
            lambda: fq.decode_blend_gather_plain(table, cell_flat, frac,
                                                 packed, **kw)),
        "decode_blend": (
            lambda: fq.decode_blend(feats2, frac, packed, n_corners=8, **kw),
            lambda: fq.decode_blend_plain(feats2, frac, packed, n_corners=8,
                                          **kw)),
    }
    rows = {}
    for name, (kernel, plain) in calls.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs()
        max_abs = float(err.max())
        max_rel = float((err / want.abs().clamp_min(1e-6)).max())
        ok = bool((err <= ATOL + RTOL * want.abs()).all())
        # Plain, kernel, kernel, plain: both see the same card state.
        p1, k1, k2, p2 = (cuda_ms(f, 5) for f in (plain, kernel, kernel,
                                                   plain))
        rows[name] = {"max_abs_err": max_abs, "ms": (k1 + k2) / 2,
                      "plain_ms": (p1 + p2) / 2}
        print(f"{name}: {N_CHECK} pts at C={imnet.in_features} "
              f"nf={imnet.nf}: max abs err {max_abs:.3e}, max rel err "
              f"{max_rel:.3e} (tolerance rtol=atol={RTOL:g}); kernel "
              f"{k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms",
              flush=True)
        if not ok or not torch.isfinite(got).all():
            raise SystemExit(f"{name}: kernel disagrees with its plain "
                             f"twin (max abs err {max_abs:.3e})")
    return rows


def _held(what, got, plain32, plain64):
    """(kernel's atol need, f32 twin's, limit) against the float64 twin,
    per quantity; raises when the kernel exceeds the limit."""
    g, p, r = (t.detach().double().cpu().numpy()
               for t in (got, plain32, plain64))
    scale = float(np.abs(r).max())
    need_k = atol_needed(g, r, scale, JET_RTOL)
    need_p = atol_needed(p, r, scale, JET_RTOL)
    limit = max(JET_SLACK * need_p, JET_FLOOR)
    ok = need_k <= limit and bool(torch.isfinite(got).all())
    print(f"  {what:12s} max|ref| {scale:.4e}: kernel needs atol "
          f"{need_k:.3e}, f32 twin {need_p:.3e}; limit {limit:.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"{what}: jet kernel disagrees with its plain twin")
    return float(np.abs(g - p).max())


def jet_vs_plain(imnet, device):
    """Phase 4: both jet kernels against their plain twins."""
    from space_time_pde_torch.ops import _build
    from space_time_pde_torch.ops import fused_jet as fj
    from space_time_pde_torch.ops import fused_query as fq
    from space_time_pde_torch.ops.grid_interp import _locate

    rng = np.random.RandomState(1)
    spatial = (4, 16, 16)                     # flagship train latent grid
    grid = torch.from_numpy(
        rng.randn(*spatial, imnet.in_features).astype(np.float32)).to(device)
    pts = torch.from_numpy(check_points(rng, spatial, N_JET)).to(device)
    cell, frac = _locate(pts, spatial, 0.0, 1.0)
    table = fq.cell_major_features(grid)
    feats2 = table[fq._flat_cells(cell, spatial).long()].reshape(
        -1, grid.shape[-1]).contiguous()
    frac = frac.contiguous()
    with torch.no_grad():
        packed = fq.pack_imnet_params(imnet)
    slope = fj.jet_slope(imnet.activation, imnet.negative_slope)
    kw = dict(nf=imnet.nf, slope=slope)
    p64 = {k: v.double() for k, v in packed.items()}
    f64, fr64 = feats2.double(), frac.double()

    out, ws = fj.jet_fwd(feats2, frac, packed, **kw)
    torch.cuda.synchronize()
    want = fj.jet_fwd_plain(feats2, frac, packed, **kw)
    want64 = fj.jet_fwd_plain(f64, fr64, p64, **kw)
    dim = frac.shape[-1]
    names = (["value"] + [f"jac_{a}" for a in range(dim)]
             + [f"hess_{a}{b}" for a, b in fj.tri_pairs(dim)])
    print(f"jet_fwd: {N_JET} pts at C={imnet.in_features} nf={imnet.nf} "
          f"vs the f32 / float64 plain twin (rtol {JET_RTOL:g}):",
          flush=True)
    fwd_err = max(_held(nm, out[:, i], want[:, i], want64[:, i])
                  for i, nm in enumerate(names))

    ybar = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).to(
        device)
    dfeats, grads = fj.jet_bwd(feats2, frac, packed, ws, ybar, **kw)
    torch.cuda.synchronize()
    dfeats_p, grads_p = fj.jet_bwd_plain(feats2, frac, packed, ybar, **kw)
    dfeats_64, grads_64 = fj.jet_bwd_plain(f64, fr64, p64, ybar.double(),
                                           **kw)
    print("jet_bwd: d feats2 and the packed-parameter gradients for a "
          "seeded cotangent:", flush=True)
    bwd_err = _held("dfeats2", dfeats, dfeats_p, dfeats_64)
    for name in grads:
        bwd_err = max(bwd_err, _held(name, grads[name], grads_p[name],
                                     grads_64[name]))
    del want64, dfeats_64, grads_64

    lib = _build.load("fused_jet")
    shape = (N_JET, feats2.shape[-1], dim, imnet.nf, packed["w5"].shape[-1])
    print(f"jet workspace at this size: forward (every layer's chains and "
          f"masks, read by the backward) {lib.stpde_jet_fwd_workspace(*shape)}"
          f" bytes, backward scratch {lib.stpde_jet_bwd_workspace(*shape)} "
          f"bytes", flush=True)
    fwd_k = lambda: fj.jet_fwd(feats2, frac, packed, **kw)
    fwd_p = lambda: fj.jet_fwd_plain(feats2, frac, packed, **kw)
    bwd_k = lambda: fj.jet_bwd(feats2, frac, packed, ws, ybar, **kw)
    bwd_p = lambda: fj.jet_bwd_plain(feats2, frac, packed, ybar, **kw)
    rows = {}
    for name, kernel, plain, err in (("jet_fwd", fwd_k, fwd_p, fwd_err),
                                     ("jet_bwd", bwd_k, bwd_p, bwd_err)):
        p1, k1, k2, p2 = (cuda_ms(f, 3) for f in (plain, kernel, kernel,
                                                   plain))
        rows[name] = {"max_abs_err": err, "ms": (k1 + k2) / 2,
                      "plain_ms": (p1 + p2) / 2}
        print(f"{name}: max abs err vs f32 twin {err:.3e}; kernel "
              f"{k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms",
              flush=True)
    return rows


def train_step_vs_jax(device):
    """Phase 8: one flagship training step against the JAX reference."""
    from space_time_pde_torch.bridge import (
        load_flax_params, seeded_flax_params)
    from space_time_pde_torch.ops import fused_jet as fj
    from space_time_pde_torch.physics import get_pde_layer
    from space_time_pde_torch.train import (
        build_models, init_state, make_loss_fn, make_optimizer,
        make_train_step)
    from space_time_pde_torch.utils.config import Config

    with np.load(STEP_REF, allow_pickle=False) as z:
        ref = {k: z[k] for k in z.files}
    spec = json.loads(str(ref["spec"]))
    cfg = Config.from_dict(spec["config"])
    lres_shape = ref["lres"].shape[1:4]
    unet, imnet = build_models(cfg, lres_shape, device)
    opt = make_optimizer(cfg)
    state = init_state(cfg.train.seed, unet, imnet, opt)
    params = seeded_flax_params(spec["shapes"], spec["weight_seed"])
    load_flax_params(unet, params["unet"])
    load_flax_params(imnet, params["imnet"])
    ext = ref["coord_extents"]
    pde = get_pde_layer(
        "rb2d", mean=ref["channel_mean"], std=ref["channel_std"],
        t_crop=float(ext[0]), z_crop=float(ext[1]), x_crop=float(ext[2]),
        rayleigh=cfg.physics.rayleigh, prandtl=cfg.physics.prandtl)
    loss_fn = make_loss_fn(cfg, unet, imnet, pde)
    batch = {k: torch.from_numpy(ref[k]).to(device)
             for k in ("lres", "point_coord", "point_value")}
    fj.reset_launches()
    # One optimizer step; its gradients stay in the parameters' .grad.
    state, metrics = make_train_step(loss_fn, opt)(state, batch)
    torch.cuda.synchronize()
    if fj.LAUNCHES["jet_fwd"] < 1 or fj.LAUNCHES["jet_bwd"] < 1:
        raise SystemExit(f"the training step did not run the jet kernels: "
                         f"{fj.LAUNCHES}")
    terms32, terms64 = spec["terms32"], spec["terms64"]
    bad = []
    for k, v in metrics.items():
        if k not in terms32:
            continue
        got = float(v)
        rel = abs(got - terms32[k]) / max(abs(terms32[k]), 1e-30)
        print(f"  {k:18s} port {got:.8g}  JAX f32 {terms32[k]:.8g}  "
              f"float64 {terms64[k]:.8g}  rel diff vs JAX {rel:.2e}",
              flush=True)
        # The temperature residual is ~1e-17 (b == 0 on Taylor-Green):
        # read it against the total loss.
        if abs(got - terms32[k]) > LOSS_RTOL * max(abs(terms32[k]),
                                                   1e-6 * terms32["loss"]):
            bad.append(k)
    rtol = spec["grad_rtol"]
    jax_need = max(float(ref[k]) for k in ref if k.startswith("need/"))
    limit = STEP_SLACK * jax_need
    needs, norms = {}, {}
    for name, module in (("unet", unet), ("imnet", imnet)):
        for k, p in module.named_parameters():
            key = f"{name}.{k}"
            g = p.grad.double().cpu().numpy()
            g64 = ref[f"grad64/{key}"].astype(np.float64)
            needs[key] = atol_needed(g, g64, float(ref[f"scale/{key}"]),
                                     rtol)
            n64 = np.linalg.norm(g64)
            norms[key] = (np.linalg.norm(g - g64) / n64,
                          np.linalg.norm(ref[f"grad/{key}"] - g64) / n64)
            if needs[key] > limit:
                bad.append(key)
    for key in sorted(needs, key=needs.get)[-5:]:
        print(f"  {key:34s} needs atol {needs[key]:.3e} x max|g64| (JAX "
              f"f32 {float(ref[f'need/{key}']):.3e}); rel L2 vs float64 "
              f"{norms[key][0]:.2e} (JAX f32 {norms[key][1]:.2e})",
              flush=True)
    ratio = [a / b for a, b in norms.values() if b > 0]
    print(f"train step vs JAX: {len(needs)} gradient leaves vs float64 at "
          f"rtol {rtol:g}: worst atol {max(needs.values()):.3e} x max|g64| "
          f"(limit {limit:.3e} = {STEP_SLACK:g} x JAX f32's worst "
          f"{jax_need:.3e}); rel L2 error / JAX's: median "
          f"{np.median(ratio):.2f}, max {max(ratio):.2f}; jet launches "
          f"{dict(fj.LAUNCHES)}", flush=True)
    if bad:
        raise SystemExit(f"training step disagrees with JAX: {bad}")


def train_path(device, card):
    """Phase 9: ``train_torch.main`` trains, then resumes."""
    import importlib.util

    from space_time_pde_torch.data import save_npz, taylor_green_fields
    from space_time_pde_torch.ops import fused_jet as fj
    from space_time_pde_torch.ops import fused_query as fq

    spec = importlib.util.spec_from_file_location(
        "train_torch", os.path.join(ROOT, "experiments", "rb2d",
                                    "train_torch.py"))
    train_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_torch)
    with tempfile.TemporaryDirectory() as tmp:
        save_npz(os.path.join(tmp, "tg.npz"),
                 taylor_green_fields(nt=32, nz=128, nx=256))
        flags = [
            "--device", "cuda", "--data_folder", tmp, "--train_data",
            "tg.npz", "--eval_data", "tg.npz", "--nt", "16", "--nz", "128",
            "--nx", "128", "--downsamp_t", "4", "--downsamp_xz", "8",
            "--lat_dims", "64", "--unet_nf", "32", "--imnet_nf", "64",
            "--n_samp_pts_per_crop", "1024", "--batch_size_per_gpu", "8",
            "--inner_steps", "8", "--pseudo_epoch_size", "64",
            "--alpha_pde", "0.1", "--lr", "5e-3", "--lr_schedule", "cosine",
            "--pde_loss_type", "huber", "--seed", "42",
            "--log_dir", os.path.join(tmp, "log")]
        fj.reset_launches()
        fq.reset_launches()
        first = train_torch.main(flags + ["--epochs", "2"])
        torch.cuda.synchronize()
        launches = {**fj.LAUNCHES, **fq.LAUNCHES}
        resumed = train_torch.main(flags + [
            "--epochs", "3", "--resume", os.path.join(tmp, "log",
                                                      "checkpoints")])
        torch.cuda.synchronize()
    print(f"train path launches (2 epochs x 8 steps): {launches}",
          flush=True)
    for name in ("jet_fwd", "jet_bwd"):
        if launches[name] < 1:
            raise SystemExit(f"{name} was not launched by the train path")
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
    rate = 8 * 1024 / np.mean(sps)
    print(f"train step: {np.mean(sps):.4f} s/step ({', '.join(f'{s:.4f}' for s in sps)}"
          f" in epochs 1-2), {rate:.0f} points/s (B 8 x 1,024 points, "
          f"flagship widths, jet + jet backward kernels) on {card}; losses "
          + ", ".join(f"{e['loss']:.5f}" for e in epochs), flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); this needs an NVIDIA "
                         "GPU")
    sys.path.insert(0, ROOT)
    import importlib.util

    import sympy

    from space_time_pde_torch.bridge import load_exported, load_flax_params
    from space_time_pde_torch.data import save_npz, taylor_green_fields
    from space_time_pde_torch.inference import lattice_points
    from space_time_pde_torch.models import ImNet
    from space_time_pde_torch.ops import _build
    from space_time_pde_torch.ops import fused_query as fq

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
    if log:
        for src in ("fused_query", "fused_jet"):
            regs = [ln.strip() for ln in log.get(src, "").splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"{src}.cu: " + " | ".join(regs), flush=True)
    print(f"kernels loaded in {time.perf_counter() - t0:.1f}s ("
          + (f"nvcc {log['seconds']:.1f}s, all sources in parallel" if log
             else "already built") + ")", flush=True)

    # Phases 3-4: kernels vs plain twins at the flagship widths.
    exported = load_exported(ASSET)
    m = exported["config"]["model"]
    imnet = ImNet(dim=3, in_features=m["lat_dims"],
                  out_features=m["out_channels"], nf=m["imnet_nf"],
                  activation=m["activation"],
                  negative_slope=m["negative_slope"])
    load_flax_params(imnet, exported["params"]["imnet"])
    imnet = imnet.to(device).eval()
    with torch.no_grad():
        rows = kernel_vs_plain(imnet, device)
    rows.update(jet_vs_plain(imnet, device))
    torch.cuda.empty_cache()

    # Phase 5: the flagship serving path.
    spec = importlib.util.spec_from_file_location(
        "evaluation_torch",
        os.path.join(ROOT, "experiments", "rb2d", "evaluation_torch.py"))
    evaluation_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(evaluation_torch)
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
    print(f"eval path launches: {launches}", flush=True)
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
    print(f"scattered-point request ({len(idx)} points, gather="
          f"'pregather', off the main paths) launches: {off_path}",
          flush=True)
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
    print(f"dense decode: {rate / 1e6:.3f}M pts/s (UNet encode + "
          f"{out_shape} lattice decode per window, windows 2-3) on "
          f"{card}; rel-L2 vs Taylor-Green "
          + ", ".join(f"{r:.4f}" for r in res["rel_l2"])
          + " is a smoke number for an RB2D-trained model, not a quality "
            "claim", flush=True)
    del res, unet, imnet_main, window0
    torch.cuda.empty_cache()

    # Phases 8-9: the training step against JAX, then the train path.
    print("flagship training step vs the JAX-CPU reference "
          f"({os.path.relpath(STEP_REF, ROOT)}):", flush=True)
    train_step_vs_jax(device)
    torch.cuda.empty_cache()
    train_launches = train_path(device, card)

    counts = {"decode_blend_gather": launches["decode_blend_gather"],
              "decode_blend": off_path["decode_blend"],
              "jet_fwd": train_launches["jet_fwd"],
              "jet_bwd": train_launches["jet_bwd"]}
    kernels = []
    for name in REPLACES:
        entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "path": PATHS[name],
                 "launches": counts[name], **rows[name]}
        if PATHS[name] == "off_path":
            # Counted in its own scattered-point request; the eval and
            # train paths never launch it.
            entry["main_path_launches"] = launches[name] + \
                train_launches[name]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
