"""Device milliseconds a training step in the encoder: the program's
``encode`` (UNet forward) and ``backward.encode`` (its backward) spans.

Read in the program's own session of a traced run
(``harness/program_spans.py``): the last dispatch's CUDA events, over its
steps."""

from stpde_bench.harness import program_spans


def read(run):
    s = program_spans.train(run)
    if s is None:
        return None
    return sum(s["spans"][k] for k in ("encode", "backward.encode"))
