"""Device milliseconds a training step in the optimizer: the program's
``optim`` span (global norm, clip, Adam with its device-side selects).

Read in the program's own session of a traced run
(``harness/program_spans.py``): the last dispatch's CUDA events, over its
steps."""

from stpde_bench.harness import program_spans


def read(run):
    s = program_spans.train(run)
    if s is None:
        return None
    return sum(s["spans"][k] for k in ("optim",))
