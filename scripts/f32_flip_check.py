"""The f32 decode and jets at narrow widths against float64, with
LeakyReLU branch flips accounted for, on the card.

At C = nf = 16 (a random-init ImNet, seeded as ``time_bf16_decode.py``
and ``time_bf16_jet.py --widths 16:16`` make it, the turb3d export's
activation) and D = 4 (the turb3d geometry of ``chip_smoke.py`` phases 10
and 11), holds both f32 kernels to the card's float64 rule and tells a
branch flip from an arithmetic fault:

- the jets through ``chip_smoke.py::jet_vs_plain`` (phase 11's check: a
  quantity past twice the f32 twin's distance passes only if every
  branch on which the kernel and float64 differ has a float64
  pre-activation within FLIP_REL of its layer's max |pre|, and on the
  kernel's own branches, read from its workspace, the kernel meets the
  rule);
- the decode (whose branches the kernel does not expose) on all 65,536
  points and on the points none of whose corner rows has a float64
  pre-activation within FLIP_REL of 0 (of its layer's max |pre|; the
  decode's layers are the jet's primal chain): the kernel's and the f32
  twin's atol needs and the rule's limit, twice the twin's.

Prints every reading beside its limit and the card's name and power
limit; exits non-zero if a kernel fails the rule on its unflipped
points. Needs a CUDA device and ``nvcc``. ``--dump DIR`` also writes each
width's decode inputs and its kernel's, f32 twin's and float64 outputs
to ``DIR/decode_C{c}_nf{nf}.npz``, which ``scripts/f32_decode_emulation.py``
holds against the kernel's arithmetic emulated on the CPU.

    python scripts/f32_flip_check.py [--widths 16:16,32:32] [--dump DIR]
"""

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as cs  # noqa: E402
from space_time_pde_torch.ops import _build  # noqa: E402
from space_time_pde_torch.ops import fused_jet as fj  # noqa: E402
from space_time_pde_torch.ops import fused_query as fq  # noqa: E402
from time_bf16_decode import random_imnet  # noqa: E402


def near_zero_points(table, cell_flat, frac, packed, imnet, dim):
    """[N] bool: a corner row of the point has a float64 pre-activation
    within FLIP_REL of 0 (of its layer's max |pre|)."""
    feats2 = table.double()[cell_flat.long()].reshape(
        -1, imnet.in_features)
    p64 = {k: v.double() for k, v in packed.items()}
    _, pres = fj.jet_fwd_plain(
        feats2, frac.double(), p64, nf=imnet.nf, return_pre=True,
        slope=fj.jet_slope(imnet.activation, imnet.negative_slope))
    near = torch.zeros(frac.shape[0], dtype=torch.bool, device=frac.device)
    for pre in pres:
        rel = pre.abs() / pre.abs().max()
        near |= (rel <= cs.FLIP_REL).flatten(1).any(1)
    return near


def decode_check(imnet, device, spatial, dump=None, card=None):
    """The f32 gather decode against float64, unmasked and on the points
    with no pre-activation near 0; returns the masked share of the
    limit. ``dump``: a path to write the inputs and outputs to, with the
    name of the ``card`` they came from."""
    dim = len(spatial)
    cell_flat, frac, table, packed, kw, want64, _, _ = cs.decode_inputs(
        imnet, device, spatial)
    tiles = fq.decode_tiles(packed, nf=imnet.nf, dim=dim,
                            compute_dtype=torch.float32)
    with torch.no_grad():
        got = fq.decode_blend_gather(table, cell_flat, frac, packed,
                                     tiles=tiles, **kw).cpu().numpy()
        twin = fq.decode_blend_gather_plain(table, cell_flat, frac, packed,
                                            **kw).cpu().numpy()
        near = near_zero_points(table, cell_flat, frac, packed, imnet,
                                dim).cpu().numpy()
    if dump:
        np.savez_compressed(
            dump, table=table.cpu().numpy(),
            cell_flat=cell_flat.cpu().numpy(), frac=frac.cpu().numpy(),
            kernel=got, twin=twin, want64=want64, near=near,
            card=card, activation=imnet.activation,
            negative_slope=imnet.negative_slope, nf=imnet.nf,
            **{f"w_{k}": v.cpu().numpy() for k, v in packed.items()})
        print(f"  wrote {dump}", flush=True)
    scale = float(np.abs(want64).max())
    keep = ~near
    share = None
    for what, sel in (("all points", slice(None)),
                      (f"{int(keep.sum())} points without a "
                       f"pre-activation near 0", keep)):
        need_k = cs.atol_needed(got[sel], want64[sel], scale, cs.RTOL)
        need_p = cs.atol_needed(twin[sel], want64[sel], scale, cs.RTOL)
        limit = cs.DECODE_SLACK * need_p
        share = need_k / limit if limit else float("inf")
        print(f"  decode_blend_gather f32, {what}: max|ref| {scale:.4e}; "
              f"kernel needs atol {need_k:.3e}, f32 twin {need_p:.3e}; "
              f"limit {limit:.3e} ({share:.3f} of it)", flush=True)
    print(f"  {int(near.sum())} of {near.size} points have a corner row "
          f"with a float64 pre-activation within {cs.FLIP_REL:g} of 0",
          flush=True)
    return share


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--widths", default="16:16",
                    help="C:nf pairs of the random-init ImNets")
    ap.add_argument("--dump", default=None,
                    help="directory for each width's decode inputs and "
                         "outputs (npz)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    _build.load()
    device = torch.device("cuda")
    like = cs.load_imnet(cs.TURB3D_ASSET, 4, device)
    spatial = (4, 8, 8, 8)
    failed = []
    for c, nf in (tuple(int(v) for v in w.split(":"))
                  for w in args.widths.split(",")):
        imnet = random_imnet(like, c, nf, 4, device)
        print(f"C = {c}, nf = {nf}, D = 4 ({imnet.activation}), on "
              f"{card}:", flush=True)
        dump = None
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
            dump = os.path.join(args.dump, f"decode_C{c}_nf{nf}.npz")
        with torch.no_grad():
            share = decode_check(imnet, device, spatial, dump, card)
        if not share <= 1.0:
            failed.append(f"decode C {c} nf {nf}")
        try:
            cs.jet_vs_plain(imnet, device, spatial, cs.N_JET4)
        except SystemExit as e:
            print(f"  jets: {e}", flush=True)
            failed.append(f"jets C {c} nf {nf}")
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"past the rule on unflipped points: {failed}")
    print("every kernel meets the rule on its unflipped points", flush=True)


if __name__ == "__main__":
    main()
