"""Time a decode kernel against an earlier version of it, on the card.

On ``chip_smoke.py``'s phase 3 / G inputs (the committed exports' ImNets,
65,536 seeded points on a seeded latent grid: the rb2d flagship at D = 3
and the turb3d recipe at D = 4) it runs, in turns, the plain twin, the
earlier kernel, this tree's kernel (``decode_blend_gather``), this tree's
again, the earlier one again and the twin again (CUDA events, the mean of
``--reps`` calls each), and prints every time, the largest difference of
each kernel's output from the twin's (relative to max |twin|), the bound
and the card's name and power limit. Needs a CUDA device and ``nvcc``.

    python scripts/time_bf16_decode.py --old _archive/old_fused_query.cu
    python scripts/time_bf16_decode.py --dtype float32 \\
        --old _archive/old_fused_query.cu --widths 32:32,16:16

``--dtype bfloat16`` (the default; the table rounded to bf16, the bf16
kernel of ``csrc/fused_query_bf16.cu``): ``--old`` is a
``fused_query.cu`` whose ``stpde_decode_blend_gather_bf16`` takes the
weights of ``kernel_weights(dtype=bfloat16)`` as nine pointers (the layout
before ``decode_tiles``). ``--dtype float32`` (the f32 kernel of
``csrc/fused_query.cu``, 3xTF32): ``--old`` is a ``fused_query.cu`` whose
``stpde_decode_blend_gather`` takes the f32 ``kernel_weights`` as nine
pointers (the mma.sync kernel before the wgmma one), and each output's
distance from the float64 twin is printed beside the f32 twin's (the rule
of chip_smoke.py phases 3 and 10). ``--widths C:nf,...`` times the same
turns, at D = 3 and 4, on a random-init ImNet of each of those widths
(seeded, the exports' activation) besides the exports. ``--old`` is built
into a temporary directory with the package's flags, ``csrc/`` on the
include path, while the package builds its own.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from space_time_pde_torch.models.nonlinearities import \
    ACTIVATION_CODES  # noqa: E402
from space_time_pde_torch.ops import _build  # noqa: E402
from space_time_pde_torch.ops import fused_query as fq  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The nine-pointer entry of the earlier kernels (kernel_weights' layout).
_OLD_ARGS = [_P] * 13 + [_I] * 7 + [_F, _P]


def build_old(path, tmp, bf16):
    """Start nvcc on the earlier source; returns a function that waits for
    it and gives its gather entry."""
    so = os.path.join(tmp, "old.so")
    proc = subprocess.Popen(
        [_build._nvcc(), *_build._FLAGS, "-I", str(_build._CSRC), "-o", so,
         path], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def entry():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {path}:\n{err}")
        fn = getattr(ctypes.CDLL(so), "stpde_decode_blend_gather"
                     + ("_bf16" if bf16 else ""))
        fn.argtypes, fn.restype = _OLD_ARGS, _I
        return fn

    return entry


def random_imnet(like, c, nf, dim, device):
    """A random-init ImNet of C = ``c`` and ``nf`` (seeded), with the
    activation and outputs of ``like``."""
    from space_time_pde_torch.models import ImNet

    torch.manual_seed(0)
    return ImNet(dim=dim, in_features=c, out_features=like.out_features,
                 nf=nf, activation=like.activation,
                 negative_slope=like.negative_slope).to(device).eval()


def compare(old_fn, imnet, dim, spatial, reps, card, dtype):
    device = torch.device("cuda")
    bf16 = dtype == torch.bfloat16
    cell_flat, frac, table, packed, kw, want64, _, _ = cs.decode_inputs(
        imnet, device, spatial)
    tab = table.to(dtype)
    kw = dict(kw, compute_dtype=dtype)
    n = frac.shape[0]
    tiles = fq.decode_tiles(packed, nf=imnet.nf, dim=dim,
                            compute_dtype=dtype)
    old_w = fq.kernel_weights(packed, nf=imnet.nf,
                              **({"dtype": dtype} if bf16 else {}))
    out = torch.empty(n, imnet.out_features, device=device)
    act = ACTIVATION_CODES[imnet.activation]
    stream = torch.cuda.current_stream().cuda_stream
    shape = (n, tab.shape[0], imnet.in_features, dim, imnet.nf,
             imnet.out_features, act, imnet.negative_slope, stream)

    def old():
        code = old_fn(tab.data_ptr(), cell_flat.data_ptr(), frac.data_ptr(),
                      *[w.data_ptr() for w in old_w.values()],
                      out.data_ptr(), *shape)
        _build.check(code, "old decode_blend_gather")
        return out

    def new():
        return fq.decode_blend_gather(tab, cell_flat, frac, packed,
                                      tiles=tiles, **kw)

    def plain():
        return fq.decode_blend_gather_plain(tab, cell_flat, frac, packed,
                                            **kw)

    runs = [("old", old), ("new", new)]
    twin = plain()
    scale = float(np.abs(want64).max())
    errs, need = {}, {"plain": cs.atol_needed(twin.cpu().numpy(), want64,
                                                scale, cs.RTOL)}
    for name, fn in runs:
        got = fn().clone()
        torch.cuda.synchronize()
        errs[name] = float((got - twin).abs().max() / twin.abs().max())
        need[name] = cs.atol_needed(got.cpu().numpy(), want64, scale,
                                    cs.RTOL)
    order = [("plain", plain)] + runs + runs[::-1] + [("plain", plain)]
    seq = [(name, cs.cuda_ms(fn, reps)) for name, fn in order]
    names = ["plain"] + [name for name, _ in runs]
    mean = {name: sum(t for k, t in seq if k == name) / 2 for name in names}
    b_ms, _ = cs.bound("decode_blend_gather", n=n, c=imnet.in_features,
                       dim=dim, nf=imnet.nf, out=imnet.out_features,
                       n_cells=tab.shape[0],
                       math="bf16" if bf16 else "tf32x3")
    print(f"{dtype} D={dim}, {n} points, C={imnet.in_features} "
          f"nf={imnet.nf} ({card}), ms in turns: "
          + ", ".join(f"{name} {t:.3f}" for name, t in seq), flush=True)
    print("  means: " + ", ".join(f"{k} {v:.3f}" for k, v in mean.items())
          + f" ms (old / new {mean['old'] / mean['new']:.2f}x); bound "
          f"{b_ms:.3f} ms: " + ", ".join(
              f"{k} at {100 * b_ms / v:.1f}%" for k, v in mean.items()
              if k != "plain")
          + f"; max |kernel - twin| / max |twin|: {errs}", flush=True)
    if not bf16:
        print(f"  atol needed vs the float64 twin at rtol {cs.RTOL:g} "
              f"(x max|ref| {scale:.4e}; rule: <= {cs.DECODE_SLACK:g}x "
              f"plain's): " + ", ".join(f"{k} {v:.3e}" for k, v in
                                        need.items()), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="an earlier csrc/fused_query.cu to time against")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--widths", default="",
                    help="C:nf pairs to time too on random-init ImNets, "
                         "e.g. 32:32,16:16")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    widths = [tuple(int(v) for v in w.split(":"))
              for w in args.widths.split(",") if w]
    card = cs.card_line()
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        old_entry = build_old(args.old, tmp, dtype == torch.bfloat16)
        _build.load()                   # the package's own, meanwhile
        old_fn = old_entry()
        for asset, dim, spatial in ((cs.ASSET, 3, (4, 16, 64)),
                                    (cs.TURB3D_ASSET, 4, (4, 8, 8, 8))):
            imnet = cs.load_imnet(asset, dim, device)
            compare(old_fn, imnet, dim, spatial, args.reps, card, dtype)
            for c, nf in widths:
                compare(old_fn, random_imnet(imnet, c, nf, dim, device),
                        dim, spatial, args.reps, card, dtype)


if __name__ == "__main__":
    main()
