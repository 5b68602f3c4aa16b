"""Kernel records in the traced window over its optimizer steps. The
hand-written jets' head launches in the trace must equal what the
program's ``REPLAYED`` counter says its graph replays ran; where they
do not, the reading is left out."""

import sys

from stpde_bench.harness import kernels


def read(run):
    tr = run.trace
    if tr is None or "traced_steps" not in run.rec:
        return None
    heads = tr.count_by(lambda n: (
        "jet_fwd" if "jet_head_fwd_kernel" in n and kernels.is_csrc(n) else
        "jet_bwd" if "jet_head_bwd_kernel" in n and kernels.is_csrc(n) else
        None))
    replayed = run.rec.get("replayed", {})
    for key in ("jet_fwd", "jet_bwd"):
        if heads.get(key, 0) != replayed.get(key, 0):
            print(f"launches_per_step.train: the trace holds {heads} jet "
                  f"heads, REPLAYED {replayed}: left out", file=sys.stderr)
            return None
    return len(tr.kernels()) / run.rec["traced_steps"]
