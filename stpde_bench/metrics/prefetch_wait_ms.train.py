"""Milliseconds a dispatch the host waited in the prefetcher's ``get()``
for a batch: the seconds of the gets that found the queue empty
(``CountingPrefetcher.wait_s``) over the dispatches after the capture.

Read in the program's own session of a traced run
(``harness/program_spans.py``), which dispatches as the CLIs' loop
does."""

from stpde_bench.harness import program_spans


def read(run):
    s = program_spans.train(run)
    return None if s is None else s["wait_ms"]
