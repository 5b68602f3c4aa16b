"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases (any failure raises and exits non-zero):

1. require a CUDA device; print the card (``nvidia-smi`` name and power
   limit), the torch / CUDA versions and both TF32 flags (switched off);
2. build the decode kernels from ``space_time_pde_torch/csrc`` (nvcc);
3. each kernel against its plain PyTorch twin on the card, at the
   flagship widths (C = 64, nf = 64, D = 3, out = 4) on 65,536 seeded
   points that include lattice faces, cell edges and points outside the
   domain; tolerance rtol = atol = 1e-4 (both f32; only the summation
   order and the order of the blend-before-head rounding differ);
   CUDA-event times of both;
4. the flagship serving path end to end: the committed rb2d flagship
   weights (``space_time_pde_torch/assets``), a Taylor–Green dataset at
   the flagship eval geometry, ``evaluation_torch.main`` answering three
   window requests (UNet3d at igres (4, 16, 64), dense decode of a
   (16, 128, 512) lattice per window); the kernel launch counts of that
   run alone (only ``decode_blend_gather`` is on it);
5. the pre-gathered entry (``decode_blend``, off the main path on a GPU:
   the TPU ran it only as a fallback the port does not need) answering
   one scattered-point request at the reference points, counted apart;
6. 4,096 lattice points of window 0, from the dense decode and from the
   scattered request, against the JAX-CPU reference stored beside the
   weights, point by point: ``|err| <= REF_RTOL |ref| + REF_ATOL
   max|ref|`` (see below for why the absolute part scales);
7. one JSON line of the main path's kernels, then the status line.

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
N_CHECK = 65536                 # points per kernel-vs-plain call
RTOL = ATOL = 1e-4              # kernel vs plain, f32 both
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
REPLACES = {
    "decode_blend_gather": "space_time_pde_tpu/ops/fused_query.py:244",
    "decode_blend": "space_time_pde_tpu/ops/fused_query.py:400",
}
MAIN_PATH = ("decode_blend_gather",)


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


def check_points(rng, spatial):
    """N_CHECK query points in [0, 1]^3 coordinates: uniform ones that
    overshoot the domain, points on the domain faces, and points on
    lattice nodes (cell edges and corners)."""
    n4 = N_CHECK // 4
    uniform = rng.uniform(-0.05, 1.05, (2 * n4, 3))
    faces = rng.rand(n4, 3)
    axis = rng.randint(0, 3, n4)
    faces[np.arange(n4), axis] = rng.randint(0, 2, n4)
    nodes = np.stack([rng.randint(0, s, n4) / (s - 1.0) for s in spatial],
                     -1)
    return np.concatenate([uniform, faces, nodes]).astype(np.float32)


def atol_needed(got, want, scale):
    """Smallest REF_ATOL (a fraction of ``scale``) at which
    ``|got - want| <= REF_RTOL |want| + atol * scale`` holds everywhere."""
    return max(0.0, float(np.max(np.abs(got - want)
                                 - REF_RTOL * np.abs(want))) / scale)


def kernel_vs_plain(imnet, device):
    """Phase 3: both entry points against their plain twins."""
    from space_time_pde_torch.ops import fused_query as fq
    from space_time_pde_torch.ops.grid_interp import _locate

    rng = np.random.RandomState(0)
    spatial = (4, 16, 64)                     # flagship eval latent grid
    grid = torch.from_numpy(
        rng.randn(*spatial, imnet.in_features).astype(np.float32)).to(device)
    pts = torch.from_numpy(check_points(rng, spatial)).to(device)
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); this needs an NVIDIA "
                         "GPU")
    sys.path.insert(0, ROOT)
    import importlib.util

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
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    # Phase 2: build.
    t0 = time.perf_counter()
    _build.load()
    log = _build.build_log()
    regs = [ln.strip() for ln in log.get("ptxas", "").splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"kernels loaded in {time.perf_counter() - t0:.1f}s ("
          + (f"nvcc {log['seconds']:.1f}s: " + " | ".join(regs) if log
             else "already built") + ")", flush=True)

    # Phase 3: kernels vs plain twins at the flagship widths.
    exported = load_exported(ASSET)
    m = exported["config"]["model"]
    imnet = ImNet(dim=3, in_features=m["lat_dims"],
                  out_features=m["out_channels"], nf=m["imnet_nf"],
                  activation=m["activation"],
                  negative_slope=m["negative_slope"])
    load_flax_params(imnet, exported["params"]["imnet"])
    rows = kernel_vs_plain(imnet.to(device).eval(), device)

    # Phase 4: the flagship serving path.
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
    print(f"main path launches: {launches}", flush=True)
    for name in MAIN_PATH:
        if launches[name] < 1:
            raise SystemExit(f"{name} was not launched by the main path")
    window0 = res["window0"]
    if tuple(window0.shape) != out_shape + (4,):
        raise SystemExit(f"window 0 decoded to {tuple(window0.shape)}")
    if not all(np.isfinite(res["rel_l2"])) or not torch.isfinite(
            window0).all():
        raise SystemExit("non-finite output on the main path")

    # Phase 5: the pre-gathered entry, off the main path.
    unet, imnet_main = res["models"]
    idx = torch.from_numpy(ref["index"]).to(device)
    pts = torch.from_numpy(lattice_points(out_shape)[ref["index"]])
    fq.reset_launches()
    with torch.no_grad():
        latent = unet(torch.as_tensor(res["lres0"], device=device)[None])
        point_out = fq.fused_query_local_implicit_grid(
            imnet_main, latent, pts.to(device)[None], gather="pregather")[0]
    torch.cuda.synchronize()
    print(f"scattered-point request ({len(idx)} points, gather="
          f"'pregather', off the main path) launches: {dict(fq.LAUNCHES)}",
          flush=True)
    if fq.LAUNCHES["decode_blend"] < 1 or not torch.isfinite(
            point_out).all():
        raise SystemExit("the scattered-point request failed")

    # Phase 6: both against the JAX-CPU reference, point by point.
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

    def entry(name, **counts):
        return {"name": name, "route": "cuda",
                "source": "space_time_pde_torch/csrc/fused_query.cu",
                "replaces": REPLACES[name], **counts, **rows[name]}

    # Ported, checked against its plain twin, but not run by the main
    # path: reported on its own line, with the main path's count (0).
    print(json.dumps({"off_path_kernels": [
        entry(name, main_path_launches=launches[name])
        for name in REPLACES if name not in MAIN_PATH]}))
    print(json.dumps({"kernels": [entry(name, launches=launches[name])
                                  for name in MAIN_PATH]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
