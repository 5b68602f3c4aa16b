"""The f32 decode's arithmetic emulated on the CPU, against a card run.

Reads a file of ``scripts/f32_flip_check.py --dump`` (one width's decode
inputs with the card kernel's, the card's f32 twin's and the float64
outputs) and runs on the same inputs:

- the emulation of the ``wgmma`` kernel's arithmetic that
  ``tests/test_torch_decode_split.py`` holds to the card's rule
  (``_tile_chain`` with ``_mm_tf32x3(round_b_lo=True, promoted=True)``:
  TF32 hi / lo splits, each k8 step's three products truncated toward
  zero as the tensor cores accumulate, then added to an f32 accumulator
  that starts at the coordinate term and corner bias);
- f32 in the kernels' k8-step order (``_kernel_chain`` with
  ``_mm_f32_steps``), a yardstick that does not depend on a library.

Prints, on all points and on the points with no float64 pre-activation
near 0 (the dump's ``near``), each one's distance from float64: its atol
need as a share of the card's rule (twice the card's f32 twin's need,
``chip_smoke.py`` phases 3 and 10), which a few outputs near 0 set, and
its max and rms distance over all outputs, x max |float64|; then the
kernel's distance from the emulation. A product that the kernel gets
wrong moves every output that goes through it, so its rms distance
would stand apart from the emulation's; the script exits non-zero if
the kernel's rms distance from float64 is more than 1.5x the
emulation's.

    python scripts/f32_decode_emulation.py DUMP.npz [--chunk 256]
"""

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke as cs  # noqa: E402
import test_torch_decode_split as ts  # noqa: E402
from space_time_pde_torch.ops import fused_query as fq  # noqa: E402


def emulate(z, chunk):
    """(the wgmma emulation, the fixed-order f32) outputs [N, out]."""
    packed = {k[2:]: torch.from_numpy(z[k]) for k in z.files
              if k.startswith("w_")}
    table = torch.from_numpy(z["table"])
    cells = torch.from_numpy(z["cell_flat"]).long()
    frac = torch.from_numpy(z["frac"])
    kw = dict(nf=int(z["nf"]), activation=str(z["activation"]),
              negative_slope=float(z["negative_slope"]))
    c = packed["wx_feat"].shape[0]
    layout = fq.kernel_weights(packed, nf=kw["nf"])
    mm = lambda a, b, init: ts._mm_tf32x3(a, b, round_b_lo=True,
                                          promoted=True, init=init)
    emu = np.empty_like(z["kernel"])
    f32 = np.empty_like(z["kernel"])
    with torch.no_grad():
        for p0 in range(0, frac.shape[0], chunk):
            sl = slice(p0, p0 + chunk)
            feats2 = table[cells[sl]].reshape(-1, c)
            emu[sl] = ts._tile_chain(packed, feats2, frac[sl], matmul=mm,
                                     **kw).numpy()
            f32[sl] = ts._kernel_chain(layout, feats2, frac[sl],
                                       matmul=ts._mm_f32_steps,
                                       **kw).numpy()
    return emu, f32


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dump")
    ap.add_argument("--chunk", type=int, default=256,
                    help="points emulated at once")
    args = ap.parse_args()
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    z = np.load(args.dump)
    emu, f32 = emulate(z, args.chunk)
    want = z["want64"]
    scale = float(np.abs(want).max())
    near = z["near"]
    print(f"{args.dump}: C {z['w_wx_feat'].shape[0]}, nf {int(z['nf'])}, "
          f"D {z['frac'].shape[1]}, {want.shape[0]} points, card "
          f"{z['card']}; max |float64| {scale:.4e}", flush=True)
    need = lambda x, sel: cs.atol_needed(x[sel], want[sel], scale, cs.RTOL)
    runs = (("kernel", z["kernel"]), ("emulated wgmma", emu),
            ("f32 k8-step order", f32), ("card f32 twin", z["twin"]))
    rms = {}
    for what, sel in (("all points", slice(None)),
                      (f"{int((~near).sum())} points without a "
                       f"pre-activation near 0", ~near)):
        limit = cs.DECODE_SLACK * need(z["twin"], sel)
        print(f"  {what} (rule: atol need <= {limit:.3e}, twice the "
              f"card's f32 twin's):", flush=True)
        for name, x in runs:
            err = np.abs(x[sel].astype(np.float64) - want[sel]) / scale
            rms.setdefault(name, float(np.sqrt((err ** 2).mean())))
            print(f"    {name:18s} atol need {need(x, sel):.3e} "
                  f"({need(x, sel) / limit:.3f} of the rule), max "
                  f"{err.max():.3e}, rms {np.sqrt((err ** 2).mean()):.3e}",
                  flush=True)
    d = np.abs(z["kernel"].astype(np.float64) - emu) / scale
    print(f"  kernel - emulated wgmma: max {d.max():.3e}, rms "
          f"{np.sqrt((d ** 2).mean()):.3e} (x max |float64|); kernel rms "
          f"from float64 {rms['kernel'] / rms['emulated wgmma']:.3f}x the "
          f"emulation's", flush=True)
    if not rms["kernel"] <= 1.5 * rms["emulated wgmma"]:
        raise SystemExit("the kernel is farther from float64 than its "
                         "emulated arithmetic")


if __name__ == "__main__":
    main()
