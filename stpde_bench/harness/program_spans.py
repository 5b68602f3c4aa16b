"""The program's own layer spans and prefetch counters, read in a short
session of the cell's program after a traced run's trace.

The program times its layers itself (``space_time_pde_torch/utils/
tracing.py``): with tracing on when its step is captured, the CUDA graph
holds a pair of CUDA events a span and every replay times them again;
``CountingPrefetcher`` (``data/prefetch.py``) counts the gets that found
its queue empty and the seconds they waited. The measured and traced
windows of a run keep tracing off, as the CLIs do without
``--profile_epoch``, so that nothing they read moves. So the first
reader of a traced run composes the cell's program once more, as the
run's own loop composes it (``train_loop.py``, ``decode_loop.py``), with
tracing on from before its first dispatch, and drives it for
``SESSION_S``. A composition of the train step runs in one of two
device-time modes (rb2d ~36.8 or ~41.7 ms a step on an H100), drawn
anew by each composition, so the session's mode need not be the run's.

- train: the eager dispatch and the capture, then dispatches back to
  back as the CLIs' loop does them (``step(state, upload(prefetcher.
  get()))``), ended by a synchronise; the last dispatch's device ms of
  each span over its steps, and the prefetcher's stalls and wait over
  the dispatches after the capture;
- decode: a warm window, then windows one after another, the output
  copied to the host; each window's ``decode.encode`` device ms, their
  mean.

Weights, fields and windows come from ``SEED`` (the spans' device times
do not depend on the values). The readings are kept on the run for the
other readers. Where the program has no span module, every reading is
None.
"""

from __future__ import annotations

import importlib.util
import sys
import time

import numpy as np
import torch

from stpde_bench.harness import program, spec, weights
from stpde_bench.reference.model import param_specs

MODULE = "space_time_pde_torch.utils.tracing"
SESSION_S = 3.0
SEED = 20260419
TRAIN_CHILDREN = ("batch", "encode", "jet_fwd", "pde", "backward.pde",
                  "backward.jet", "backward.encode", "optim")


def available() -> bool:
    return importlib.util.find_spec(MODULE) is not None


def train(run):
    """``{"spans": {name: device ms a step}, "wait_ms": prefetch wait ms a
    dispatch, "stalls", "gets", "step_ms": host ms a step}`` of the cell's
    program, or None."""
    return _session(run) if "traced_steps" in run.rec else None


def decode(run):
    """``{"spans": {"decode.encode": device ms a window}, "windows"}`` of
    the cell's program, or None."""
    return _session(run) if "traced_windows" in run.rec else None


def _session(run):
    """The cell's session, once a run."""
    if "program_spans" not in run.rec:
        run.rec["program_spans"] = None
        if available():
            device = torch.device("cuda", 0) if torch.cuda.is_available() \
                else torch.device("cpu")
            session = (_train if run.cell.traffic["driver"] == "train_loop"
                       else _decode)
            run.rec["program_spans"] = session(run.cell, device, SESSION_S)
    return run.rec["program_spans"]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _train(cell, device, seconds):
    from space_time_pde_torch.data.device_pipeline import DeviceSampler
    from space_time_pde_torch.data.prefetch import CountingPrefetcher
    from space_time_pde_torch.parallel.layout import Layout
    from space_time_pde_torch.train import (
        TrainState, make_loss_fn, make_optimizer)
    from space_time_pde_torch.utils import tracing

    cfg, traffic = cell.config, cell.traffic
    data, tr = cfg["data"], cfg["train"]
    inner, batch = tr["inner_steps"], tr["batch"]
    w = weights.make(param_specs(cfg["model"], data["lres"]), SEED, device)
    fields = spec.field_maker(data["fields"]["kind"])
    field, valid_t0, mean, std = fields.make(data, SEED, device)
    pcfg = program.config(cfg, traffic)
    unet, imnet = program.models(cfg, pcfg, data["lres"], w, device)
    layer = program.pde_layer(cfg, mean, std)
    opt = make_optimizer(pcfg, tr["steps_per_epoch"])
    state = TrainState(step=0, unet=unet, imnet=imnet, opt_state={},
                       generator=torch.Generator())
    state.opt_state = opt.init({k: p.detach()
                                for k, p in state.params().items()})
    sampler = DeviceSampler(
        program.sampler_source(cfg, field, valid_t0, mean, std), device)
    loss_fn = sampler.wrap_loss(make_loss_fn(pcfg, unet, imnet, layer))
    rng = np.random.RandomState(SEED)

    def make_raw():
        bs = [dict(zip(("origins", "point_coord"), sampler.draw(rng, batch)))
              for _ in range(inner)]
        return bs[0] if inner == 1 else {
            k: np.stack([b[k] for b in bs]) for k in bs[0]}

    def upload(host):
        return {k: torch.as_tensor(v, device=device) for k, v in host.items()}

    tracing.enable()
    prefetcher = CountingPrefetcher(make_raw, depth=4)
    try:
        step = Layout(1, False, False, device.type).make_step(
            pcfg, imnet, layer, loss_fn, opt, inner)
        for _ in range(2):              # eager, then the capture
            state, _ = step(state, upload(prefetcher.get()))
        _sync(device)
        gets, stalls, wait = (prefetcher.gets, prefetcher.stalls,
                              prefetcher.wait_s)
        n, t0 = 0, time.perf_counter()
        while True:
            state, _ = step(state, upload(prefetcher.get()))
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        wall = time.perf_counter() - t0
        ms = tracing.device_ms()
        out = {"spans": {k: v / ms["step"][1] for k, (v, _) in ms.items()},
               "wait_ms": (prefetcher.wait_s - wait) / n * 1e3,
               "stalls": prefetcher.stalls - stalls,
               "gets": prefetcher.gets - gets,
               "step_ms": wall / (n * inner) * 1e3, "dispatches": n}
    finally:
        tracing.disable()
        prefetcher.close()
    _report(cell, out)
    return out


def _decode(cell, device, seconds):
    from space_time_pde_torch.inference import make_dense_decoder
    from space_time_pde_torch.utils import tracing

    cfg, traffic = cell.config, cell.traffic
    dec = cfg["decode"]
    w = weights.make(param_specs(cfg["model"], dec["lres"]), SEED, device)
    pcfg = program.config(cfg, traffic)
    unet, imnet = program.models(cfg, pcfg, dec["lres"], w, device)
    unet.eval()
    decode = make_dense_decoder(unet, imnet, tuple(dec["out_shape"]),
                                chunk=dec["chunk"],
                                compute_dtype=program.compute_dtype(traffic))
    fields = spec.field_maker(cfg["data"]["fields"]["kind"])

    def window(i):
        seed = int(np.random.SeedSequence([SEED, i]).generate_state(1)[0])
        return fields.window(cfg["data"], seed, dec["out_shape"],
                             dec["lres"])

    tracing.enable()
    try:
        lres = window(0)
        decode(lres).cpu()              # warm
        ms, t0, i = [], time.perf_counter(), 0
        while True:
            i += 1
            decoded = decode(lres)
            lres = window(i)            # made while the card decodes
            decoded.cpu()
            ms.append(tracing.device_ms()["decode.encode"][0])
            if time.perf_counter() - t0 >= seconds:
                break
    finally:
        tracing.disable()
    out = {"spans": {"decode.encode": float(np.mean(ms))},
           "windows": len(ms)}
    _report(cell, out)
    return out


def _report(cell, out) -> None:
    spans = " ".join(f"{k} {v:.4f}" for k, v in out["spans"].items())
    rest = {k: v for k, v in out.items() if k != "spans"}
    print(f"program spans of {cell.name} (device ms a step / window): "
          f"{spans}; {rest}", file=sys.stderr, flush=True)
