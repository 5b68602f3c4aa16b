"""Device milliseconds a decode window from the start to the end of the
encoder's forward: the program's ``decode.encode`` span, the gaps while
the host launches the encoder's kernels included; the mean over the
windows.

Read in the program's own session of a traced run
(``harness/program_spans.py``)."""

from stpde_bench.harness import program_spans


def read(run):
    s = program_spans.decode(run)
    return None if s is None else s["spans"]["decode.encode"]
