"""Time the jet kernels against an earlier version of them, on the card.

On ``chip_smoke.py``'s phase 4 / 11 inputs (the committed exports'
ImNets, a seeded latent grid and cotangent: the rb2d flagship at D = 3 on
8,192 points and the turb3d recipe at D = 4 on 4,096) it runs, in turns,
the plain twins, the earlier kernels, this tree's kernels (``jet_fwd`` /
``jet_bwd``), this tree's again, the earlier ones again and the twins
again (CUDA events, the mean of ``--reps`` calls each), and prints every
time, the share of the bound (``chip_smoke.py::bound``), the largest
difference of each kernel's outputs from its twin's (relative to max
|twin|, over the blocks, or d feats2 and the nine gradients), and the
card's name and power limit. Needs a CUDA device and ``nvcc``.

    python scripts/time_bf16_jet.py --old _archive/old_fused_jet_bf16.cu
    python scripts/time_bf16_jet.py --dtype float32 \\
        --old _archive/old_fused_jet.cu --widths 32:32,16:16

``--dtype bfloat16`` (the default): the bf16 instantiation
(``csrc/fused_jet_bf16.cu``; the rows rounded to bf16 and the weights
packed at bf16); as a yardstick for the product mainloop alone (not a
kernel of the port) it also times ``torch.matmul`` on the shape of layer
1's hidden product, [4R, 16 nf] x [16 nf, 8 nf] in bf16. ``--dtype
float32``: the f32 kernels (``csrc/fused_jet.cu``, 3xTF32), and each
output's distance from the float64 twin beside the f32 twin's, quantity
by quantity (the rule of chip_smoke.py phases 4 and 11: at most
JET_SLACK times the twin's, floor JET_FLOOR); ``--widths C:nf,...``
times the same turns, at D = 3 and 4, on a random-init ImNet of each of
those widths (seeded, the exports' activation) besides the exports.

``--old`` is a ``fused_jet_bf16.cu`` (``fused_jet.cu`` at float32) with
the same C entry points (for example an earlier commit's: ``git show
<commit>:space_time_pde_torch/csrc/fused_jet.cu``); it is built into a
temporary directory with the package's flags, ``csrc/`` on the include
path. Without ``--old`` only this tree's kernels and the twins run.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from space_time_pde_torch.ops import _build  # noqa: E402
from space_time_pde_torch.ops import fused_jet as fj  # noqa: E402
from space_time_pde_torch.ops import fused_query as fq  # noqa: E402
from time_bf16_decode import random_imnet  # noqa: E402

BF = torch.bfloat16
NAME = "fused_jet_bf16"


def build_old(path, tmp, name=NAME):
    so = os.path.join(tmp, "old.so")
    subprocess.run([_build._nvcc(), *_build._FLAGS, "-I", str(_build._CSRC),
                    "-o", so, path], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    for fn, (argtypes, restype) in _build._ARGTYPES[name].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
    return lib


def rel_err(got, want):
    """max |got - want| / max |want| over paired tensors."""
    return max(float((g.double() - w.double()).abs().max())
               / max(float(w.double().abs().max()), 1e-30)
               for g, w in zip(got, want))


def compare(old_lib, asset, dim, spatial, n, reps, card):
    device = torch.device("cuda")
    new_lib = _build.load(NAME)
    imnet = cs.load_imnet(asset, dim, device)
    feats2, frac, _, ybar, kw = cs.jet_inputs(imnet, device, spatial, n)
    with torch.no_grad():
        p16 = fq.pack_imnet_params(imnet, dtype=BF)
    f16 = feats2.to(BF)
    kw16 = dict(kw, compute_dtype=BF)

    def use(lib):
        _build._libs[NAME] = lib

    def fwd():
        return fj.jet_fwd(f16, frac, p16, **kw16)

    def bwd_of(ws):
        return lambda: fj.jet_bwd(f16, frac, p16, ws, ybar, **kw16)

    twin_f = fj.jet_fwd_plain(f16, frac, p16, **kw16)
    twin_d, twin_g = fj.jet_bwd_bf16_plain(f16, frac, p16, ybar, **kw)
    twin_b = [twin_d] + [twin_g[k] for k in sorted(twin_g)]
    libs = {"new": new_lib}
    if old_lib is not None:
        libs["old"] = old_lib
    ws, errs = {}, {}
    for name, lib in libs.items():
        use(lib)
        out, ws[name] = fwd()
        d, g = bwd_of(ws[name])()
        torch.cuda.synchronize()
        errs[name] = (rel_err([out], [twin_f]),
                      rel_err([d] + [g[k] for k in sorted(g)], twin_b))
    del twin_b, twin_d, twin_g, twin_f
    plain = ((lambda: fj.jet_fwd_plain(f16, frac, p16, **kw16)),
             (lambda: fj.jet_bwd_bf16_plain(f16, frac, p16, ybar, **kw)))

    def timed(name):
        if name == "plain":
            return tuple(cs.cuda_ms(f, reps) for f in plain)
        use(libs[name])
        return cs.cuda_ms(fwd, reps), cs.cuda_ms(bwd_of(ws[name]), reps)

    order = ["plain", "old", "new", "new", "old", "plain"]
    seq = [(name, timed(name)) for name in order if name in libs
           or name == "plain"]
    use(new_lib)
    mean = {name: [sum(t[i] for k, t in seq if k == name) / 2
                   for i in range(2)] for name, _ in seq}
    shape = dict(n=n, c=imnet.in_features, dim=dim, nf=imnet.nf,
                 out=imnet.out_features)
    bounds = [cs.bound(kind, math="bf16", **shape)[0]
              for kind in ("jet_fwd", "jet_bwd")]
    print(f"D={dim}, {n} points, C={imnet.in_features} nf={imnet.nf} "
          f"({card}), ms in turns (forward / backward): "
          + ", ".join(f"{name} {f:.3f}/{b:.3f}" for name, (f, b) in seq),
          flush=True)
    for i, kind in enumerate(("forward", "backward")):
        line = (f"  {kind}: bound {bounds[i]:.3f} ms; plain "
                f"{mean['plain'][i]:.3f}")
        for name in libs:
            t = mean[name][i]
            line += (f"; {name} {t:.3f} ms ({100 * bounds[i] / t:.1f}% of "
                     f"the bound, max |kernel - twin| / max |twin| "
                     f"{errs[name][i]:.2e})")
        if "old" in libs:
            line += f"; old / new {mean['old'][i] / mean['new'][i]:.2f}x"
        print(line, flush=True)
    rows = n * 2 ** dim * (dim + 1)
    a = torch.randn(rows, 16 * imnet.nf, device=device, dtype=BF)
    b = torch.randn(16 * imnet.nf, 8 * imnet.nf, device=device, dtype=BF)
    ms = cs.cuda_ms(lambda: torch.matmul(a, b), reps)
    flop = 2 * rows * 16 * imnet.nf * 8 * imnet.nf
    print(f"  yardstick, not a kernel of the port: torch.matmul "
          f"[{rows}, {16 * imnet.nf}] x [{16 * imnet.nf}, {8 * imnet.nf}] "
          f"bf16 {ms:.3f} ms ({flop / ms / 1e9:.0f} TFLOP/s)", flush=True)


def f32_needs(outs, refs, scale_of):
    """Per quantity, the atol (a fraction of max |float64|) at which the
    outputs meet ``|err| <= JET_RTOL |ref| + atol max|ref|``."""
    return {k: cs.atol_needed(outs[k].double().cpu().numpy(),
                              refs[k].cpu().numpy(), scale_of[k],
                              cs.JET_RTOL) for k in refs}


def f32_outputs(out, dfeats, grads, dim):
    names = (["value"] + [f"jac_{a}" for a in range(dim)]
             + [f"hess_{a}{b}" for a, b in fj.tri_pairs(dim)])
    got = {nm: out[:, i] for i, nm in enumerate(names)}
    got["dfeats2"] = dfeats
    got.update(grads)
    return got


def compare_f32(old_lib, imnet, dim, spatial, n, reps, card):
    """The f32 jets (csrc/fused_jet.cu): this tree's and the earlier one's
    against the f32 twins, in turns, and every quantity's distance from
    the float64 twin beside the f32 twin's."""
    device = torch.device("cuda")
    name = "fused_jet"
    new_lib = _build.load(name)
    feats2, frac, packed, ybar, kw = cs.jet_inputs(imnet, device, spatial,
                                                   n)
    p64 = {k: v.double() for k, v in packed.items()}

    def use(lib):
        _build._libs[name] = lib

    def fwd():
        return fj.jet_fwd(feats2, frac, packed, **kw)

    def bwd_of(ws):
        return lambda: fj.jet_bwd(feats2, frac, packed, ws, ybar, **kw)

    ref = f32_outputs(
        fj.jet_fwd_plain(feats2.double(), frac.double(), p64, **kw),
        *fj.jet_bwd_plain(feats2.double(), frac.double(), p64,
                          ybar.double(), **kw), dim)
    ref = {k: v.detach() for k, v in ref.items()}
    scale = {k: float(v.abs().max()) for k, v in ref.items()}
    twin = f32_outputs(fj.jet_fwd_plain(feats2, frac, packed, **kw),
                       *fj.jet_bwd_plain(feats2, frac, packed, ybar, **kw),
                       dim)
    need = {"plain": f32_needs(twin, ref, scale)}
    libs = {"new": new_lib}
    if old_lib is not None:
        libs["old"] = old_lib
    ws, errs = {}, {}
    nblk = 1 + dim + dim * (dim + 1) // 2
    for lname, lib in libs.items():
        use(lib)
        out, ws[lname] = fwd()
        d, g = bwd_of(ws[lname])()
        torch.cuda.synchronize()
        got = f32_outputs(out, d, g, dim)
        keys = list(got)
        errs[lname] = (rel_err([got[k] for k in keys[:nblk]],
                               [twin[k] for k in keys[:nblk]]),
                       rel_err([got[k] for k in keys[nblk:]],
                               [twin[k] for k in keys[nblk:]]))
        need[lname] = f32_needs(got, ref, scale)
        del got, out, d, g
    del ref, twin
    plain = ((lambda: fj.jet_fwd_plain(feats2, frac, packed, **kw)),
             (lambda: fj.jet_bwd_plain(feats2, frac, packed, ybar, **kw)))

    def timed(lname):
        if lname == "plain":
            return tuple(cs.cuda_ms(f, reps) for f in plain)
        use(libs[lname])
        return cs.cuda_ms(fwd, reps), cs.cuda_ms(bwd_of(ws[lname]), reps)

    order = ["plain", "old", "new", "new", "old", "plain"]
    seq = [(k, timed(k)) for k in order if k in libs or k == "plain"]
    use(new_lib)
    mean = {k: [sum(t[i] for j, t in seq if j == k) / 2 for i in range(2)]
            for k, _ in seq}
    shape = dict(n=n, c=imnet.in_features, dim=dim, nf=imnet.nf,
                 out=imnet.out_features)
    bounds = [cs.bound(kind, math="tf32x3", **shape)[0]
              for kind in ("jet_fwd", "jet_bwd")]
    print(f"float32 D={dim}, {n} points, C={imnet.in_features} "
          f"nf={imnet.nf} ({card}), ms in turns (forward / backward): "
          + ", ".join(f"{k} {f:.3f}/{b:.3f}" for k, (f, b) in seq),
          flush=True)
    for i, kind in enumerate(("forward", "backward")):
        line = (f"  {kind}: bound {bounds[i]:.3f} ms; plain "
                f"{mean['plain'][i]:.3f}")
        for lname in libs:
            t = mean[lname][i]
            line += (f"; {lname} {t:.3f} ms ({100 * bounds[i] / t:.1f}% of "
                     f"the bound, max |kernel - twin| / max |twin| "
                     f"{errs[lname][i]:.2e})")
        if "old" in libs:
            line += f"; old / new {mean['old'][i] / mean['new'][i]:.2f}x"
        print(line, flush=True)
    print(f"  atol needed vs the float64 twin at rtol {cs.JET_RTOL:g} "
          f"(rule: <= max({cs.JET_SLACK:g} x plain's, {cs.JET_FLOOR:g})), "
          f"per quantity, " + " / ".join(["plain"] + list(libs)) + ":",
          flush=True)
    for k in need["plain"]:
        limit = max(cs.JET_SLACK * need["plain"][k], cs.JET_FLOOR)
        print(f"    {k:12s} " + " / ".join(
            f"{need[lname][k]:.3e}" for lname in ["plain", *libs])
            + "; " + ", ".join(f"{lname} {need[lname][k] / limit:.3f} of "
                               f"the limit" for lname in libs), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", help="an earlier csrc/fused_jet_bf16.cu "
                    "(fused_jet.cu at float32) to time against")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--widths", default="",
                    help="with --dtype float32: C:nf pairs to time too on "
                         "random-init ImNets, e.g. 32:32,16:16")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    f32 = args.dtype == "float32"
    widths = [tuple(int(v) for v in w.split(":"))
              for w in args.widths.split(",") if w]
    _build.load()
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        old = (build_old(args.old, tmp, "fused_jet" if f32 else NAME)
               if args.old else None)
        for asset, dim, spatial, n in (
                (cs.ASSET, 3, (4, 16, 16), cs.N_JET),
                (cs.TURB3D_ASSET, 4, (4, 8, 8, 8), cs.N_JET4)):
            if not f32:
                compare(old, asset, dim, spatial, n, args.reps, card)
                torch.cuda.empty_cache()
                continue
            imnet = cs.load_imnet(asset, dim, device)
            for net in [imnet] + [random_imnet(imnet, c, nf, dim, device)
                                  for c, nf in widths]:
                compare_f32(old, net, dim, spatial, n, args.reps, card)
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
