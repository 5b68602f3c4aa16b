"""The f32 jet backward's bound (``counts/kernels.py::jet_bwd`` at the
step's points, against 495 TFLOP/s and 3.35 TB/s) over its device time a
call in the trace (its kernels' summed time over its head launches)."""

from stpde_bench.harness import kernels, readers
from stpde_bench.harness.peaks import bound_s
from stpde_bench.counts import kernels as counts


def read(run):
    tr = run.trace
    if tr is None:
        return None
    fam = "jet_bwd f32"
    t = tr.seconds_by(kernels.family).get(fam, 0.0)
    calls = tr.count_by(lambda n: "head" if "jet_head_bwd_kernel" in n
                        and kernels.family(n) == fam else None).get("head", 0)
    if not calls or not t:
        return None
    flop, byts = counts.jet_bwd(readers.step_points(run.cell),
                                **readers.imnet_shape(run.cell))
    return bound_s(flop, byts) / (t / calls) * 100
