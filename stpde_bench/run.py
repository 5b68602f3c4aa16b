#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``space_time_pde_torch``.

    python3 stpde_bench/run.py --workload rb2d-train-f32 --seed 7 \
        --seconds 40 --trace 0

The cell, its configuration, traffic mix, limits and metrics are found
by name from ``BENCHMARK.json`` (``harness/spec.py``). Weights, fields
and inputs come from ``--seed``. The run sets up (counted in
``setup_s``), measures for ``--seconds``, with ``--trace 1`` traces a
short window more and reports the per-layer metrics instead of the
end-to-end ones, then checks what the timed path produced against the
plain reference (``reference/``) and prints each number compared with
its limit, on standard error and as the last key of the result, the
last line of standard output. It needs a CUDA card and exits with 1
and no result without one, or when JAX or the JAX package was loaded.
"""

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# A traced run's untraced window, which only its rates (``mfu.*``) read:
# at most this long, so that the run with its trace stays within its
# allowance.
TRACED_RUN_WINDOW_S = 10.0


def measure(cell, seed, seconds, traced, device, started, root=None,
            check=None):
    """Set up, measure, trace and check one run of ``cell``; returns the
    result dict (without ``checks``) and the numbers compared.
    ``check(rec)`` takes the place of the driver's own check (the
    readings of ``calibrate.py``)."""
    import torch

    from stpde_bench.harness import device as dev, spec, weights
    from stpde_bench.harness.seeds import Seeds
    from stpde_bench.harness.spans import Spans
    from stpde_bench.reference import compare
    from stpde_bench.reference.model import param_specs

    root = root or spec.ROOT
    phases = []

    def phase(name):
        """Note the end of a set-up phase (printed on standard error)."""
        phases.append((name, time.time() - started))

    phase("imports")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, traffic = cell.config, cell.traffic
    seeds = Seeds.of(seed)
    ctx = SimpleNamespace(
        cell=cell, seeds=seeds, device=device, spans=Spans(),
        seconds=min(seconds, TRACED_RUN_WINDOW_S) if traced else seconds,
        trace=traced, started=started, phase=phase,
        fields=spec.field_maker(cfg["data"]["fields"]["kind"], root),
        weights=weights.make(param_specs(cfg["model"], cfg["data"]["lres"]),
                             seeds.weights, device))
    driver = spec.load_module(
        root / "stpde_bench" / "harness" / f"{traffic['driver']}.py",
        "stpde_driver_" + traffic["driver"])
    phase("weights")
    rec = driver.run(ctx)
    print("set-up phases (s from the process's start): " + ", ".join(
        f"{n} {t:.2f}" for n, t in phases), file=sys.stderr, flush=True)
    info = dev.info(device, cell.entry["chips"])
    if device.type == "cuda":
        info["power_limit_w"] = dev.power_limit_w()
    if traced:
        info["busy_s"] = rec["trace"].busy_s
        info["window_s"] = rec["trace"].window_s
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(rec) if check else rec["check"]()
    run = SimpleNamespace(rec=rec, cell=cell, trace=rec.get("trace"))
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": compare.verdict(numbers, cell.limits),
              "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics, "device": info}
    if traced:
        result["breakdown"] = rec["trace"].breakdown()
    return result, numbers


def emit(result, numbers, limits) -> None:
    """The compared numbers as the last lines of standard error, and the
    result, with them under ``checks``, as the last line of standard
    output."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(dict(result, checks=checks)), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from stpde_bench.harness import device as dev, spec

    started = dev.process_start()
    cell = spec.resolve(args.workload)
    dev.require_cards(cell.entry["chips"])
    result, numbers = measure(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), started)
    loaded = dev.loaded_forbidden()
    if loaded:
        sys.exit(f"the run loaded {loaded}: nothing of JAX or the JAX "
                 "package may run here")
    emit(result, numbers, cell.limits)
    return 0


if __name__ == "__main__":
    sys.exit(main())
