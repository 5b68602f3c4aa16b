"""The benchmark's machinery: cells and metrics resolved by name from
``BENCHMARK.json``, seeds, weights and fields made from the seed, the
two loops (training dispatches, dense-decode windows), host spans, the
device trace and its reduction, and the result line."""
