"""Where a training step's device time goes, on the card.

Builds the step of ``space_time_pde_torch/assets/<recipe>_train_step_ref
.npz`` as ``chip_smoke.py`` does (the seeded weights and batch that it
holds against JAX: the rb2d flagship or the ``r5_turb3d_200x_big``
recipe) under ``--policy`` (``f32``; ``bf16``: ``--use_bf16``;
``bf16_pde``: ``--use_bf16 --pde_bf16``), as ``--step eager`` (the
steps launched from Python, ``make_multi_step``) or ``--step captured``
(``CapturedStep``: one CUDA graph a dispatch, as the train CLIs run on a
card), ``--inner`` steps a dispatch (the CLIs' ``--inner_steps``; 8 in
the flagship recipe). It times ``--steps`` dispatches after ``--warm``
warm ones (the captured step warms up and captures in those) with a
host clock ended by a device synchronise, then runs ``--prof``
dispatches under a device trace (``chip_smoke.traced``) and ``--prof``
more under ``torch.profiler``, and prints the untraced s/step, the
kernels' summed device time a step, the idle share of the traced
dispatches (1 - the device's busy time, the union of its kernels',
copies' and fills' intervals / their wall time, both from that trace)
and the kernels by device time, with the card's name and power limit,
and one JSON line. ``--all`` runs both families, the three
policies and both step modes in one process. Needs a CUDA device.

    python scripts/profile_torch_step.py --recipe turb3d --step captured
    python scripts/profile_torch_step.py --all

``--jets`` profiles the jet kernels alone instead: ``--steps`` calls of
``jet_fwd`` and then of ``jet_bwd`` on ``chip_smoke.py``'s phase 4 and 11
inputs (the committed exports' ImNets, 8,192 points at D = 3 and 4,096
at D = 4), each kernel of the call with its device time and launches
per call; ``--each`` adds one call's launches in order, each with its
device time (the layers of a kernel apart). ``--dtype bf16`` runs the
bf16 instantiation (``csrc/fused_jet_bf16.cu``: the rows rounded to bf16,
the weights packed at bf16) instead of the f32 one; ``--source A.cu``
profiles another version of that instantiation's source (built as the
package builds it, ``csrc/`` on the include path), e.g. an earlier
commit's, for a before / after table.

    python scripts/profile_torch_step.py --jets --each [--dtype bf16] \
        [--source A.cu]

``--sources A.cu B.cu ...`` times other versions of
``space_time_pde_torch/csrc/fused_jet.cu`` on the same inputs: each is
built as the package builds it (``csrc/`` on the include path, for
``jet_common.cuh``), and ``jet_fwd`` / ``jet_bwd`` run on each
in turn (CUDA events, the mean of ``--steps`` calls, the sources in
order, then in reverse), with the largest difference of every output
from the first source's, relative to that output's max |value|.

``--mma-ceiling`` measures what ``mma.sync.m16n8k8`` TF32 products can
issue on the card with operands in registers (no loads, one block of 8
warps on each SM, each warp 4 x 4 m16n8 tiles): in 3xTF32 as the jet
and decode kernels run them (three products a k8 step into a zeroed
temporary, then added to the accumulator), three straight into the
accumulator, and one (plain TF32).
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch

from chip_smoke import (ASSET, ASSETS, N_JET, N_JET4, TURB3D_ASSET,
                        cuda_ms, jet_inputs, load_imnet, reference_step,
                        traced)


def device_rows(fn, reps):
    """Run ``fn`` ``reps`` times under ``torch.profiler``: (kernel rows
    sorted by device time, [(ms per rep, launches per rep, name)], and
    the kernel ms per rep)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
    rows.sort(key=dev, reverse=True)
    out = [(dev(e) / 1e3 / reps, e.count / reps, e.key) for e in rows]
    return out, sum(r[0] for r in out)


def print_rows(rows, total, top, unit):
    for ms, count, key in rows[:top]:
        print(f"  {ms:9.3f} ms/{unit} {100 * ms / total:5.1f}%  "
              f"{count:8.1f} launches/{unit}  {key[:90]}")


def launches_in_order(fn):
    """[(ms, kernel name)] of one ``fn()``'s launches, in launch order."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    return [(e.time_range.elapsed_us() / 1e3, e.name) for e in evs]


def jet_cases(device):
    """(D, n, nf, jet_fwd / jet_bwd inputs) of chip_smoke.py's phases 4
    and 11."""
    for dim, asset, spatial, n in ((3, ASSET, (4, 16, 16), N_JET),
                                   (4, TURB3D_ASSET, (4, 8, 8, 8), N_JET4)):
        imnet = load_imnet(asset, dim, device)
        yield dim, n, imnet.nf, jet_inputs(imnet, device, spatial, n)
        torch.cuda.empty_cache()


def profile_jets(card, reps, top, each, dtype="f32", source=None):
    from space_time_pde_torch.ops import fused_jet as fj
    from space_time_pde_torch.ops import fused_query as fq

    if source:
        import ctypes
        import tempfile

        from space_time_pde_torch.ops import _build

        name = "fused_jet_bf16" if dtype == "bf16" else "fused_jet"
        _build.load()
        so = os.path.join(tempfile.mkdtemp(), "source.so")
        subprocess.run([_build._nvcc(), *_build._FLAGS, "-I",
                        str(_build._CSRC), "-o", so, source], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(so)
        for fn, (at, rt) in _build._ARGTYPES[name].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes, getattr(lib, fn).restype = at, rt
        _build._libs[name] = lib
        print(f"profiling {source} in place of csrc/{name}.cu", flush=True)

    for dim, n, nf, (feats2, frac, packed, ybar, kw) in jet_cases(
            torch.device("cuda")):
        if dtype == "bf16":
            bf = torch.bfloat16
            feats2 = feats2.to(bf)
            packed = {k: v.to(bf) if k in fq._ROUNDED else v
                      for k, v in packed.items()}
            kw = dict(kw, compute_dtype=bf)
        _, ws = fj.jet_fwd(feats2, frac, packed, **kw)
        fj.jet_bwd(feats2, frac, packed, ws, ybar, **kw)
        torch.cuda.synchronize()
        calls = (("jet_fwd", lambda: fj.jet_fwd(feats2, frac, packed, **kw)),
                 ("jet_bwd", lambda: fj.jet_bwd(feats2, frac, packed, ws,
                                                ybar, **kw)))
        for name, fn in calls:
            rows, total = device_rows(fn, reps)
            print(f"{name} ({dtype}) at D={dim}, {n} points, "
                  f"C={feats2.shape[-1]} "
                  f"nf={nf} on {card}: {total:.3f} ms of kernel time "
                  f"a call, {sum(r[1] for r in rows):.0f} launches a call")
            print_rows(rows, total, top, "call")
            if each:
                for i, (ms, key) in enumerate(launches_in_order(fn)):
                    print(f"    #{i:2d} {ms:8.3f} ms  {key[:80]}")
        del ws


def time_sources(card, paths, reps):
    """jet_fwd / jet_bwd on each version of csrc/fused_jet.cu in
    ``paths``, in turns."""
    import ctypes

    from space_time_pde_torch.ops import _build
    from space_time_pde_torch.ops import fused_jet as fj

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "space_time_pde_torch", "_build")
    os.makedirs(out, exist_ok=True)
    procs = [subprocess.Popen(
        [_build._nvcc(), *_build._FLAGS, "-I", str(_build._CSRC), "-o",
         os.path.join(out, f"source{i}.so"), path], stderr=subprocess.PIPE,
        text=True) for i, path in enumerate(paths)]
    libs = []
    for i, (path, proc) in enumerate(zip(paths, procs)):
        if proc.wait():
            raise SystemExit(f"{path}: nvcc failed\n{proc.stderr.read()}")
        lib = ctypes.CDLL(os.path.join(out, f"source{i}.so"))
        for fn, (at, rt) in _build._ARGTYPES["fused_jet"].items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = at, rt
        libs.append(lib)
    _build.load()
    for dim, n, _, (feats2, frac, packed, ybar, kw) in jet_cases(
            torch.device("cuda")):
        times, first = {}, None
        for lib in libs + libs[::-1]:
            _build._libs["fused_jet"] = lib
            o, ws = fj.jet_fwd(feats2, frac, packed, **kw)
            d, g = fj.jet_bwd(feats2, frac, packed, ws, ybar, **kw)
            res = [o, d] + [g[k] for k in sorted(g)]
            first = first or res
            diff = max(float((a - b).abs().max() / b.abs().max().clamp_min(
                1e-30)) for a, b in zip(res, first))
            f = cuda_ms(lambda: fj.jet_fwd(feats2, frac, packed, **kw), reps)
            b = cuda_ms(lambda: fj.jet_bwd(feats2, frac, packed, ws, ybar,
                                           **kw), reps)
            times.setdefault(id(lib), []).append((f, b, diff))
            del ws
        for path, lib in zip(paths, libs):
            (f1, b1, diff), (f2, b2, _) = times[id(lib)]
            print(f"D={dim} {n} points on {card}: {path}: jet_fwd "
                  f"{f1:.3f} / {f2:.3f} ms, jet_bwd {b1:.3f} / {b2:.3f} ms; "
                  f"max diff vs {paths[0]} {diff:.2e} of max |value|")


_MMA_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// MODE 0: 3 products into a zeroed temporary, added to the accumulator;
// 1: 3 products into the accumulator; 2: 1 product.
template <int MODE>
__global__ void __launch_bounds__(256, 1) bench(float* out, int iters) {
  uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
  const uint32_t s = threadIdx.x * 2654435761u;
  for (int m = 0; m < 4; ++m)
    for (int e = 0; e < 4; ++e) ah[m][e] = s + m * 7 + e, al[m][e] = s ^ (m + e);
  for (int n = 0; n < 4; ++n)
    for (int e = 0; e < 2; ++e) bh[n][e] = s + n * 3 + e, bl[n][e] = s ^ (n * 5 + e);
  float acc[4][4][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (MODE == 0) {
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          mma(p, al[m], bh[n][0], bh[n][1]);
          mma(p, ah[m], bl[n][0], bl[n][1]);
          mma(p, ah[m], bh[n][0], bh[n][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] += p[e];
        } else if (MODE == 1) {
          mma(acc[m][n], al[m], bh[n][0], bh[n][1]);
          mma(acc[m][n], ah[m], bl[n][0], bl[n][1]);
          mma(acc[m][n], ah[m], bh[n][0], bh[n][1]);
        } else {
          mma(acc[m][n], ah[m], bh[n][0], bh[n][1]);
        }
      }
#pragma unroll
    for (int m = 0; m < 4; ++m) ah[m][0] += 1;
  }
  float t = 0.f;
  for (int m = 0; m < 4; ++m)
    for (int n = 0; n < 4; ++n)
      for (int e = 0; e < 4; ++e) t += acc[m][n][e];
  out[blockIdx.x * 256 + threadIdx.x] = t;
}
template <int MODE>
float run_one(float* out, int blocks, int iters) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  bench<MODE><<<blocks, 256>>>(out, iters);
  cudaEventRecord(a);
  bench<MODE><<<blocks, 256>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  return ms;
}
extern "C" float run(float* out, int blocks, int iters, int mode) {
  return mode == 0 ? run_one<0>(out, blocks, iters)
       : mode == 1 ? run_one<1>(out, blocks, iters)
                   : run_one<2>(out, blocks, iters);
}
"""


def mma_ceiling(card):
    import ctypes
    import tempfile

    from space_time_pde_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        src, so = os.path.join(tmp, "mma.cu"), os.path.join(tmp, "mma.so")
        with open(src, "w") as f:
            f.write(_MMA_SRC)
        subprocess.run([_build._nvcc(), *_build._FLAGS, "-o", so, src],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(so)
    lib.run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int]
    lib.run.restype = ctypes.c_float
    blocks, iters = torch.cuda.get_device_properties(0).multi_processor_count, 20000
    out = torch.zeros(blocks * 256, device="cuda")
    for mode, name, products in ((0, "3xTF32, temporary + add", 3),
                                 (1, "3xTF32, into the accumulator", 3),
                                 (2, "TF32, one product", 1)):
        ms = lib.run(out.data_ptr(), blocks, iters, mode)
        flops = 2 * 16 * 8 * 8 * 16 * products * 8 * blocks * iters
        issued = flops / (ms * 1e-3) / 1e12
        print(f"mma.sync m16n8k8 TF32 on {card}, {name}: {ms:.3f} ms, "
              f"{issued:.1f} TFLOP/s issued, {issued / products:.1f} "
              f"TFLOP/s of products")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--recipe", choices=("rb2d", "turb3d"),
                        default="turb3d")
    parser.add_argument("--policy", choices=("f32", "bf16", "bf16_pde"),
                        default="f32")
    parser.add_argument("--step", choices=("eager", "captured"),
                        default="captured")
    parser.add_argument("--inner", type=int, default=8,
                        help="steps a dispatch (--inner_steps)")
    parser.add_argument("--all", action="store_true",
                        help="both recipes x three policies x both steps")
    parser.add_argument("--jets", action="store_true",
                        help="profile jet_fwd / jet_bwd alone at D = 3, 4")
    parser.add_argument("--each", action="store_true",
                        help="with --jets: one call's launches in order")
    parser.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                        help="with --jets: the instantiation to profile")
    parser.add_argument("--source", metavar="CU",
                        help="with --jets: profile this version of the "
                        "instantiation's source")
    parser.add_argument("--sources", nargs="+", metavar="CU",
                        help="time these versions of csrc/fused_jet.cu")
    parser.add_argument("--mma-ceiling", action="store_true",
                        help="the tensor cores' mma.sync TF32 rate")
    parser.add_argument("--warm", type=int, default=3,
                        help="warm dispatches (jets: calls)")
    parser.add_argument("--steps", type=int, default=5,
                        help="timed dispatches (jets: calls)")
    parser.add_argument("--prof", type=int, default=2,
                        help="profiled dispatches")
    parser.add_argument("--top", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    if args.mma_ceiling:
        mma_ceiling(card)
        return
    if args.sources:
        time_sources(card, args.sources, args.steps)
        return
    if args.jets:
        profile_jets(card, args.steps, args.top, args.each, args.dtype,
                     args.source)
        return
    cases = ([(r, p, m) for r in ("rb2d", "turb3d")
              for p in ("f32", "bf16", "bf16_pde")
              for m in ("eager", "captured")] if args.all
             else [(args.recipe, args.policy, args.step)])
    for recipe, policy, mode in cases:
        profile_step(card, device, recipe, policy, mode, args.inner,
                     args.warm, args.steps, args.prof, args.top)
        torch.cuda.empty_cache()


def profile_step(card, device, recipe, policy, mode, inner, warm, steps,
                 prof, top):
    """One (recipe, policy, step mode): s/step, kernel time a step and
    the idle share, printed, and as one JSON line."""
    from space_time_pde_torch.train import (
        CapturedStep, make_loss_fn, make_multi_step, make_train_step)

    cfg, pde, opt, state, batch, _, _ = reference_step(
        os.path.join(ASSETS, f"{recipe}_train_step_ref.npz"), device,
        use_bf16=policy != "f32", pde_bf16=policy == "bf16_pde")
    loss_fn = make_loss_fn(cfg, state.unet, state.imnet, pde)
    if inner > 1:
        batch = {k: torch.stack([v] * inner) for k, v in batch.items()}
    if mode == "captured":
        step = CapturedStep(loss_fn, opt, inner, device)
    else:
        step = (make_multi_step(loss_fn, opt, inner) if inner > 1
                else make_train_step(loss_fn, opt))

    def dispatch():
        nonlocal state
        state, _ = step(state, batch)

    for _ in range(max(warm, 2)):
        dispatch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        dispatch()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / (steps * inner)
    torch.cuda.reset_peak_memory_stats()
    _, _, busy, traced_wall = traced(
        lambda: [dispatch() for _ in range(prof)])
    rows, total = device_rows(dispatch, prof)
    total /= inner
    line = {"recipe": recipe, "policy": policy, "step": mode,
            "inner": inner, "s_per_step": wall,
            "kernel_ms_per_step": total,
            "busy_ms_per_step": busy / (prof * inner),
            "traced_ms_per_step": traced_wall / (prof * inner),
            "idle_share": 1 - busy / traced_wall,
            "launches_per_step": sum(r[1] for r in rows) / inner,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "card": card}
    print(f"{recipe} {policy} {mode} step ({inner} a dispatch) on {card}: "
          f"{wall:.6f} s/step untraced; {total:.3f} ms of kernel time a "
          f"step; traced: {line['traced_ms_per_step']:.3f} ms a step, the "
          f"device busy {line['busy_ms_per_step']:.3f} ms of it, idle share "
          f"{line['idle_share']:.3f} (1 - busy / untraced s/step "
          f"{1 - line['busy_ms_per_step'] / (wall * 1e3):.3f}); "
          f"{line['launches_per_step']:.0f} kernel launches a step; peak "
          f"memory {line['peak_gb']:.2f} GB", flush=True)
    print_rows([(ms / inner, n / inner, key) for ms, n, key in rows],
               total, top, "step")
    print(json.dumps(line), flush=True)

if __name__ == "__main__":
    main()
