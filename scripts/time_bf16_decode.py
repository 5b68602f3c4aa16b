"""Time the bf16 decode kernel against an earlier version of it, on the card.

On ``chip_smoke.py``'s phase G inputs (the committed exports' ImNets,
65,536 seeded points on a seeded latent grid: the rb2d flagship at D = 3
and the turb3d recipe at D = 4, the table rounded to bf16) it runs, in
turns, the plain bf16 twin, the earlier kernel, this tree's kernel
(``decode_blend_gather`` at bf16, ``csrc/fused_query_bf16.cu``), this
tree's again, the earlier one again and the twin again (CUDA events, the
mean of ``--reps`` calls each), and prints every time, the largest
difference of each kernel's output from the twin's (relative to max
|twin|), the bf16 bound and the card's name and power limit. Needs a CUDA
device and ``nvcc``.

    python scripts/time_bf16_decode.py --old _archive/old_fused_query.cu

``--old`` is a ``fused_query.cu`` whose ``stpde_decode_blend_gather_bf16``
takes the weights of ``kernel_weights(dtype=bfloat16)`` as nine pointers
(the layout before ``decode_tiles``); it is built into a temporary
directory with the package's flags, ``csrc/`` on the include path.
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
from space_time_pde_torch.models.nonlinearities import \
    ACTIVATION_CODES  # noqa: E402
from space_time_pde_torch.ops import _build  # noqa: E402
from space_time_pde_torch.ops import fused_query as fq  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build_old(path, tmp):
    so = os.path.join(tmp, "old.so")
    subprocess.run([_build._nvcc(), *_build._FLAGS, "-I", str(_build._CSRC),
                    "-o", so, path], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    fn = lib.stpde_decode_blend_gather_bf16
    fn.argtypes, fn.restype = [_P] * 13 + [_I] * 7 + [_F, _P], _I
    return fn


def compare(old_fn, asset, dim, spatial, reps, card):
    device = torch.device("cuda")
    bf = torch.bfloat16
    imnet = cs.load_imnet(asset, dim, device)
    cell_flat, frac, table, packed, kw, _, _, _ = cs.decode_inputs(
        imnet, device, spatial)
    t16 = table.to(bf)
    kw = dict(kw, compute_dtype=bf)
    n = frac.shape[0]
    tiles = fq.decode_tiles(packed, nf=imnet.nf, dim=dim)
    old_w = fq.kernel_weights(packed, nf=imnet.nf, dtype=bf)
    out = torch.empty(n, imnet.out_features, device=device)

    def old():
        code = old_fn(
            t16.data_ptr(), cell_flat.data_ptr(), frac.data_ptr(),
            *[w.data_ptr() for w in old_w.values()], out.data_ptr(), n,
            t16.shape[0], imnet.in_features, dim, imnet.nf,
            imnet.out_features, ACTIVATION_CODES[imnet.activation],
            imnet.negative_slope, torch.cuda.current_stream().cuda_stream)
        _build.check(code, "old decode_blend_gather_bf16")
        return out

    def new():
        return fq.decode_blend_gather(t16, cell_flat, frac, packed,
                                      tiles=tiles, **kw)

    def plain():
        return fq.decode_blend_gather_plain(t16, cell_flat, frac, packed,
                                            **kw)

    twin = plain()
    errs = {}
    for name, fn in (("old", old), ("new", new)):
        got = fn().clone()
        torch.cuda.synchronize()
        errs[name] = float((got - twin).abs().max() / twin.abs().max())
    order = [("plain", plain), ("old", old), ("new", new), ("new", new),
             ("old", old), ("plain", plain)]
    seq = [(name, cs.cuda_ms(fn, reps)) for name, fn in order]
    mean = {name: sum(t for k, t in seq if k == name) / 2
            for name in ("plain", "old", "new")}
    b_ms, _ = cs.bound("decode_blend_gather", n=n, c=imnet.in_features,
                       dim=dim, nf=imnet.nf, out=imnet.out_features,
                       n_cells=t16.shape[0], math="bf16")
    print(f"D={dim}, {n} points, C={imnet.in_features} nf={imnet.nf} "
          f"({card}), ms in turns: "
          + ", ".join(f"{name} {t:.3f}" for name, t in seq), flush=True)
    print(f"  means: plain {mean['plain']:.3f}, old {mean['old']:.3f}, new "
          f"{mean['new']:.3f} ms ({mean['old'] / mean['new']:.2f}x); bound "
          f"{b_ms:.3f} ms: old at {100 * b_ms / mean['old']:.1f}% of it, new "
          f"at {100 * b_ms / mean['new']:.1f}%; max |kernel - twin| / "
          f"max |twin|: {errs}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="an earlier csrc/fused_query.cu to time against")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    _build.load()
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        old_fn = build_old(args.old, tmp)
        compare(old_fn, cs.ASSET, 3, (4, 16, 64), args.reps, card)
        compare(old_fn, cs.TURB3D_ASSET, 4, (4, 8, 8, 8), args.reps, card)


if __name__ == "__main__":
    main()
