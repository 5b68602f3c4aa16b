"""Device milliseconds a training step in the PDE layer and the loss: the
program's ``pde`` (regression loss, PDE residuals, their sum) and
``backward.pde`` (their backward, up to the jet's outputs) spans.

Read in the program's own session of a traced run
(``harness/program_spans.py``): the last dispatch's CUDA events, over its
steps."""

from stpde_bench.harness import program_spans


def read(run):
    s = program_spans.train(run)
    if s is None:
        return None
    return sum(s["spans"][k] for k in ("pde", "backward.pde"))
