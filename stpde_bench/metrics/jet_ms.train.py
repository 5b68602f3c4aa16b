"""Device milliseconds a training step in the jet: the program's ``jet_fwd``
(corner gather, concatenation, jet forward kernels) and ``backward.jet``
(jet backward kernels, the gather's scatter-add) spans.

Read in the program's own session of a traced run
(``harness/program_spans.py``): the last dispatch's CUDA events, over its
steps."""

from stpde_bench.harness import program_spans


def read(run):
    s = program_spans.train(run)
    if s is None:
        return None
    return sum(s["spans"][k] for k in ("jet_fwd", "backward.jet"))
