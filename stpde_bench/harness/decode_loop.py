"""The dense-decode traffic: windows decoded back to back by one client,
as ``experiments/{rb2d,turb3d}/evaluation_torch.py`` decode them.

Set-up: the models holding the seed's weights at the window's low-res
grid, and ``inference.make_dense_decoder`` at the window's output
lattice (its weights packed and its lattice located once), warmed on
one window. Window: for ``--seconds``, a fresh low-res window made from
the seed is handed to ``decode`` and its output copied to the host
before the next is handed over (a closed loop); the client makes its
next input while the card decodes. Each window is timed from the
hand-over to its output on the host. A traced run then traces
``traced_windows`` more.

Check: ``check_windows`` windows of the run, drawn from the seed as
they come (a reservoir), are decoded again by the reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from space_time_pde_torch.inference import make_dense_decoder
from stpde_bench.harness import program, trace
from stpde_bench.reference import compare, decode as ref_decode


def run(ctx) -> dict:
    cfg, traffic, device = ctx.cell.config, ctx.cell.traffic, ctx.device
    dec = cfg["decode"]
    pcfg = program.config(cfg, traffic)
    unet, imnet = program.models(cfg, pcfg, dec["lres"], ctx.weights, device)
    unet.eval()
    ctx.phase("models")
    decode = make_dense_decoder(unet, imnet, tuple(dec["out_shape"]),
                                chunk=dec["chunk"],
                                compute_dtype=program.compute_dtype(traffic))
    ctx.phase("decoder built")
    spans = ctx.spans
    picker = np.random.RandomState(ctx.seeds.sample)
    keep = traffic["check_windows"]
    kept = []               # (window index, lres, output)

    def make_input(i):
        seed = int(np.random.SeedSequence(
            [ctx.seeds.windows, i + 1]).generate_state(1)[0])
        return ctx.fields.window(cfg["data"], seed, dec["out_shape"],
                                 dec["lres"])

    inputs = {}

    def one(i):
        """Window ``i``: hand over its input, make the next one while the
        card decodes, copy the output to the host."""
        lres = inputs.pop(i)
        t_in = time.perf_counter()
        with spans("dispatch"):
            out = decode(lres)
        with spans("window_input"):
            inputs[i + 1] = make_input(i + 1)
        with spans("window_output"):
            host = out.cpu().numpy()
        return lres, host, time.perf_counter() - t_in

    inputs[-1] = make_input(-1)
    one(-1)                            # warm every shape of the window
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    spans.clear()
    ctx.phase("warm window")
    out = {"setup_s": time.time() - ctx.started}
    latencies = []
    t0 = time.perf_counter()
    i = 0
    while True:
        lres, host, lat = one(i)
        latencies.append(lat)
        # Reservoir: every window of the run equally likely kept.
        if len(kept) < keep:
            kept.append((i, lres, host))
        else:
            j = picker.randint(i + 1)
            if j < keep:
                kept[j] = (i, lres, host)
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    wall = time.perf_counter() - t0
    points = int(np.prod(dec["out_shape"]))
    bad = sum(not np.isfinite(h).all() for _, _, h in kept)
    out.update(window_s=wall, windows=i, points=i * points,
               latencies_s=latencies, attempted=i, failed=int(bad),
               span_s=spans.totals(), span_n=len(spans.records))
    if ctx.trace:
        k = traffic["traced_windows"]
        with trace.traced(spans, device, warm=lambda: one(i)) as tr_:
            for w in range(1, k + 1):
                one(i + w)
        out.update(trace=tr_, traced_windows=k)
    del decode, unet, imnet
    out["check"] = lambda: _check(ctx, kept)
    return out


def _check(ctx, kept) -> dict:
    cfg = ctx.cell.config
    worst = {}
    for _, lres, host in kept:
        ref = ref_decode.decode(ctx.weights, cfg["model"], lres,
                                cfg["decode"]["out_shape"], ctx.device)
        for k, v in compare.decode_numbers(torch.from_numpy(host),
                                           ref).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst
