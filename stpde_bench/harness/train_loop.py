"""The training traffic: the recipe's step, dispatched back to back by
one client, as ``experiments/{rb2d,turb3d}/train_torch.py`` compose it.

Set-up: the field from the seed (uploaded once into ``DeviceSampler``),
the models holding the seed's weights, the optimizer, the PDE layer, the
loss assembled on the device from drawn origins and points, the step of
``Layout.make_step`` (``CapturedStep`` on a card: ``inner_steps``
optimizer steps a dispatch as one CUDA graph), and the batches drawn by
``DeviceSampler.draw`` from ``RandomState`` through ``BatchPrefetcher``.
Its first dispatch runs eagerly and is recorded for the check (each
step's loss, the optimizer's first moments after step 1, the parameters
after the last checked step); its second captures the graph. Nothing
compiles after that.

Window: dispatch after dispatch for ``--seconds``, as the CLIs' loop
dispatches (``step(state, upload(prefetcher.get()))``), ended by a
synchronise. ``train_step_ms`` is the window's wall time over its
optimizer steps. A traced run then traces ``traced_dispatches`` more.

Check: the reference follows the first ``check_steps`` steps from the
seed's weights on the batches it draws itself from the same seed, in
float64. After the window, one more dispatch of the same call replays
the graph from a copy of the program's state (parameters, Adam's
moments and count); the reference follows its steps from that copy, on
the batches the seed's ``RandomState`` gives that dispatch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from space_time_pde_torch.data.device_pipeline import DeviceSampler
from space_time_pde_torch.data.prefetch import BatchPrefetcher
from space_time_pde_torch.parallel.layout import Layout
from space_time_pde_torch.train import (
    REPLAYED, TrainState, make_loss_fn, make_optimizer)
from space_time_pde_torch.train.optim import counter_values
from stpde_bench.harness import program, trace
from stpde_bench.reference import compare, train as ref_train

B1 = 0.9
# The reference follows the steps in float64: in float32 its own rounding
# on a small leaf (the turb3d encoder's temporal products) read as far
# from float64 as the program's worst seeds (PERF.md, PR 21).
REFERENCE_DTYPE = torch.float64


class Recorder:
    """Pass-through wrappers of the loss and the optimizer that, while
    ``on``, keep each step's loss, the optimizer's first moments after
    the first step and the parameters after ``steps`` steps."""

    def __init__(self, steps: int):
        self.steps, self.on = steps, False
        self.loss, self.mu1, self.params = [], None, None
        self.count = 0

    def wrap_loss(self, fn):
        def loss(raw):
            out = fn(raw)
            if self.on and len(self.loss) < self.steps:
                self.loss.append(out[0].detach().clone())
            return out
        return loss

    def wrap_optimizer(self, opt):
        rec = self

        class Recording:
            def step(self, params, grads, state):
                norm = opt.step(params, grads, state)
                if rec.on:
                    rec.count += 1
                    if rec.count == 1:
                        rec.mu1 = {k: v.clone() for k, v in
                                   state["mu"].items()}
                    if rec.count == rec.steps:
                        rec.params = {k: p.detach().clone() for k, p in
                                      params.items()}
                return norm

            def __getattr__(self, name):
                return getattr(opt, name)

        return Recording()


def run(ctx) -> dict:
    cfg, traffic, device = ctx.cell.config, ctx.cell.traffic, ctx.device
    data, tr = cfg["data"], cfg["train"]
    inner, batch = tr["inner_steps"], tr["batch"]
    if traffic["check_steps"] > inner:
        raise ValueError("the checked steps must lie in the first dispatch")
    field, valid_t0, mean, std = ctx.fields.make(data, ctx.seeds.fields,
                                                 device)
    ctx.phase("fields")
    pcfg = program.config(cfg, traffic)
    unet, imnet = program.models(cfg, pcfg, data["lres"], ctx.weights, device)
    layer = program.pde_layer(cfg, mean, std)
    opt = make_optimizer(pcfg, tr["steps_per_epoch"])
    state = TrainState(step=0, unet=unet, imnet=imnet, opt_state={},
                       generator=torch.Generator())
    state.opt_state = opt.init({k: p.detach()
                                for k, p in state.params().items()})
    source = program.sampler_source(cfg, field, valid_t0, mean, std)
    sampler = DeviceSampler(source, device)
    ctx.phase("models, optimizer, field uploaded")
    rec = Recorder(traffic["check_steps"])
    loss_fn = rec.wrap_loss(sampler.wrap_loss(
        make_loss_fn(pcfg, unet, imnet, layer)))
    step = Layout(1, False, False, device.type).make_step(
        pcfg, imnet, layer, loss_fn, rec.wrap_optimizer(opt), inner)
    rng = np.random.RandomState(ctx.seeds.batches)

    def make_raw():
        bs = [dict(zip(("origins", "point_coord"), sampler.draw(rng, batch)))
              for _ in range(inner)]
        return bs[0] if inner == 1 else {
            k: np.stack([b[k] for b in bs]) for k in bs[0]}

    prefetcher = BatchPrefetcher(make_raw, depth=4)
    spans = ctx.spans

    def upload(host):
        return {k: torch.as_tensor(v, device=device) for k, v in host.items()}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    losses = []
    dispatched = 0

    def dispatch():
        nonlocal state, dispatched
        with spans("draw"):
            raw = prefetcher.get()
        with spans("upload"):
            b = upload(raw)
        with spans("dispatch"):
            state, metrics = step(state, b)
        dispatched += 1
        return metrics

    try:
        rec.on = True
        dispatch()                    # eager: the checked steps
        rec.on = False
        sync()
        ctx.phase("eager dispatch")
        dispatch()                    # captures the graph
        sync()
        ctx.phase("captured dispatch")
        spans.clear()
        out = {"setup_s": time.time() - ctx.started}
        t0 = time.perf_counter()
        n = 0
        while True:
            losses.append(dispatch()["loss"])
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        with spans("sync"):
            sync()
        wall = time.perf_counter() - t0
        finite = torch.isfinite(torch.stack(losses)).cpu().numpy()
        out.update(window_s=wall, dispatches=n, steps=n * inner,
                   attempted=n, failed=int((~finite).sum()),
                   span_s=spans.totals(), span_n=len(spans.records))
        if ctx.trace:
            k = traffic["traced_dispatches"]
            before = {}

            def warm():
                dispatch()
                before.update(REPLAYED)

            with trace.traced(spans, device, warm=warm) as tr_:
                for _ in range(k):
                    dispatch()
            out.update(trace=tr_, traced_steps=k * inner,
                       replayed={key: n_ - before[key] for key, n_ in
                                 REPLAYED.items()})
        sync()
        replay = {"start": _snapshot(state), "index": dispatched}
        replay["loss"] = float(dispatch()["loss"])
        replay["params"] = {k: p.detach().clone() for k, p in
                            state.params().items()}
    finally:
        prefetcher.close()
    prog = {"loss": [float(x) for x in rec.loss],
            "grad": {k: v / (1 - B1) for k, v in rec.mu1.items()},
            "params": rec.params, "replay": replay}
    del state, step, sampler, unet, imnet, opt, loss_fn, losses
    out["weights"] = ctx.weights
    out["reference"] = lambda dtype: _reference(ctx, prog, field, valid_t0,
                                                mean, std, dtype)
    out["check"] = lambda: compare.train_numbers(
        prog, out["reference"](REFERENCE_DTYPE), ctx.weights)
    return out


def _snapshot(state) -> dict:
    """A copy of what the next dispatch starts from: the parameters,
    Adam's moments and its count."""
    o = state.opt_state
    copy = lambda d: {k: v.detach().clone() for k, v in d.items()}
    return {"params": copy(state.params()), "mu": copy(o["mu"]),
            "nu": copy(o["nu"]), "count": counter_values(o)["count"]}


def _reference(ctx, prog, field, valid_t0, mean, std, dtype) -> dict:
    """The reference's results, shaped as ``prog``, in ``dtype``."""
    cfg = ctx.cell.config
    data, tr = cfg["data"], cfg["train"]
    origins = (len(valid_t0),) + tuple(
        g - c + 1 for g, c in zip(field.shape[1:-1], data["crop"][1:]))
    args = (cfg, field, (mean, std))
    ref = ref_train.steps(ctx.weights, *args,
                          np.random.RandomState(ctx.seeds.batches), origins,
                          valid_t0, len(prog["loss"]), ctx.device,
                          dtype=dtype)
    rp = prog["replay"]
    rng = np.random.RandomState(ctx.seeds.batches)
    inner = tr["inner_steps"]
    ref_train.skip(rng, origins, valid_t0, tr["batch"],
                   data["points_per_crop"], rp["index"] * inner)
    after = ref_train.steps(rp["start"]["params"], *args, rng, origins,
                            valid_t0, inner, ctx.device, dtype=dtype,
                            start=rp["start"])
    ref["replay"] = {"start": rp["start"], "loss": after["loss"][-1],
                     "params": after["params"]}
    return ref
