"""The f32 decode kernel's bound (``counts/kernels.py::
decode_blend_gather`` at one chunk of points, against 495 TFLOP/s and
3.35 TB/s) over its device time a launch in the trace."""

from stpde_bench.harness import kernels, readers
from stpde_bench.harness.peaks import bound_s
from stpde_bench.counts import kernels as counts


def read(run):
    tr = run.trace
    if tr is None:
        return None
    fam = "decode f32"
    t = tr.seconds_by(kernels.family).get(fam, 0.0)
    calls = tr.count_by(kernels.family).get(fam, 0)
    if not calls or not t:
        return None
    flop, byts = counts.decode_blend_gather(
        run.cell.config["decode"]["chunk"],
        n_cells=readers.decode_cells(run.cell),
        **readers.imnet_shape(run.cell))
    return bound_s(flop, byts) / (t / calls) * 100
