"""Device milliseconds a training step outside every child span of the
program's ``step`` span: the step's glue (zeroing and collecting the
gradients, the metrics). No two children overlap, so it is at or above 0.

Read in the program's own session of a traced run
(``harness/program_spans.py``): the last dispatch's CUDA events, over its
steps."""

from stpde_bench.harness import program_spans


def read(run):
    s = program_spans.train(run)
    if s is None:
        return None
    spans = s["spans"]
    return spans["step"] - sum(spans[k] for k in
                               program_spans.TRAIN_CHILDREN)
