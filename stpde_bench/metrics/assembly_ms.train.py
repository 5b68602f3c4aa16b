"""Device milliseconds a training step assembling the batch on the device:
the program's ``batch`` span (crop and point reads, normalisation).

Read in the program's own session of a traced run
(``harness/program_spans.py``): the last dispatch's CUDA events, over its
steps."""

from stpde_bench.harness import program_spans


def read(run):
    s = program_spans.train(run)
    if s is None:
        return None
    return sum(s["spans"][k] for k in ("batch",))
