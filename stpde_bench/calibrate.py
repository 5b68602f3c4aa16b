#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 stpde_bench/calibrate.py --workload rb2d-train-f32 \
        --mode sound --seeds 101,102,...   # the program, checked
    python3 stpde_bench/calibrate.py --workload rb2d-train-f32 \
        --mode control --seeds 201,202,203  # the reference in TF32

``sound``: one short run of the cell a seed, in one process, as
``run.py`` runs it (set-up, a window of ``--seconds``, the check); prints
the numbers it compares. ``control``: the reference put in the
program's place and computed one precision below the configuration's
(TF32 matrix products and convolutions for f32), against the check's
reference (float64 for training, f32 for decode), on the same seed's
weights, fields, batches and windows; prints the same numbers. For
training it follows a sound run's checked steps (its first steps from
the seed's weights, its replayed dispatch from the program's state
before it). ``half_batch`` (training): a sound run with half of each
batch left out underneath (``DeviceSampler.batch_fn`` keeps the first
half of the rows). Each seed is one JSON line on standard
output. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _tf32(on: bool) -> None:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def control(cell, seed: int, device, seconds: float = 1.0) -> dict:
    """The control's numbers for ``cell`` at ``seed``."""
    import numpy as np
    import torch

    from stpde_bench.harness import spec, weights
    from stpde_bench.harness.seeds import Seeds
    from stpde_bench.reference import compare, decode as ref_decode
    from stpde_bench.reference.model import param_specs
    from stpde_bench.run import measure

    cfg, traffic = cell.config, cell.traffic
    if traffic["driver"] == "train_loop":
        def check(rec):
            from stpde_bench.harness.train_loop import REFERENCE_DTYPE
            try:
                _tf32(True)
                low = rec["reference"](torch.float32)
            finally:
                _tf32(False)
            return compare.train_numbers(
                low, rec["reference"](REFERENCE_DTYPE), rec["weights"])
        return measure(cell, seed, seconds, False, device, time.time(),
                       check=check)[1]
    seeds = Seeds.of(seed)
    fields = spec.field_maker(cfg["data"]["fields"]["kind"])
    w = weights.make(param_specs(cfg["model"], cfg["data"]["lres"]),
                     seeds.weights, device)
    dec = cfg["decode"]
    worst = {}
    for i in range(traffic["check_windows"]):
        s = int(np.random.SeedSequence([seeds.windows, i + 1])
                .generate_state(1)[0])
        lres = fields.window(cfg["data"], s, dec["out_shape"], dec["lres"])
        try:
            _tf32(True)
            low = ref_decode.decode(w, cfg["model"], lres, dec["out_shape"],
                                    device, dtype=torch.float32)
        finally:
            _tf32(False)
        ref = ref_decode.decode(w, cfg["model"], lres, dec["out_shape"],
                                device, dtype=torch.float32)
        for k, v in compare.decode_numbers(low, ref).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


@contextlib.contextmanager
def planted(mode: str):
    """``half_batch``: the fault planted in the program."""
    from space_time_pde_torch.data.device_pipeline import DeviceSampler

    orig = DeviceSampler.batch_fn
    if mode == "half_batch":
        def batch_fn(self, origins, pts):
            keep = max(1, len(origins) // 2)
            return orig(self, origins[:keep], pts[:keep])
        DeviceSampler.batch_fn = batch_fn
    try:
        yield
    finally:
        DeviceSampler.batch_fn = orig


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True,
                   choices=("sound", "control", "half_batch"))
    p.add_argument("--seeds", required=True,
                   help="comma-separated whole numbers")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)

    import torch

    from stpde_bench.harness import device as dev, spec
    from stpde_bench.run import measure

    cell = spec.resolve(args.workload)
    dev.require_cards(cell.entry["chips"])
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        if args.mode == "control":
            numbers, extra = control(cell, seed, device, args.seconds), {}
        else:
            with planted(args.mode):
                result, numbers = measure(cell, seed, args.seconds, False,
                                          device, time.time())
            extra = {"correct": result["correct"]}
        print(json.dumps(dict(workload=args.workload, mode=args.mode,
                              seed=seed, seconds=time.time() - t0,
                              **numbers, **extra)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
