"""The port's layer spans (``utils/tracing.py``) and the prefetcher's
counters, on the CPU with tiny rb2d (UNet3d) and turb3d (UNet4d) models:
the training step of ``make_multi_step`` over batches assembled by
``DeviceSampler`` and the windows of ``make_dense_decoder``.

- tracing off records nothing and registers no autograd hook;
- a step's loss, metrics and parameters are bitwise equal with tracing
  off and on;
- each train span occurs once an inner step, in the order the step runs
  them, under ``step``, numbered by dispatch and inner step; the
  backward's spans hand over pde -> jet -> encode; no two children of a
  step overlap;
- ``decode.encode`` occurs once a window;
- every name opened is one of ``NAMES``;
- ``CountingPrefetcher`` counts stalls and their wait with a slow
  ``make_batch`` and none with a fast one once its queue is full.

The ``cuda`` test (skipped without a card) holds the captured step's
spans on the card: their events sit in the graph and every replay times
them again.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from space_time_pde_torch import physics as tphys
from space_time_pde_torch import train as ttrain
from space_time_pde_torch.data.device_pipeline import DeviceSampler
from space_time_pde_torch.data.prefetch import CountingPrefetcher
from space_time_pde_torch.inference import make_dense_decoder
from space_time_pde_torch.utils import tracing
from space_time_pde_torch.utils.config import Config

FAMILIES = ("rb2d", "turb3d")
# The spans of one optimizer step, in the order it opens them.
TRAIN = ("step", "batch", "encode", "jet_fwd", "pde", "backward.pde",
         "backward.jet", "backward.encode", "optim")
INNER = 2


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.enable()            # forgets the last dispatch's spans
    tracing.disable()
    yield
    tracing.disable()


def _family(family, device="cpu"):
    """(state, optimizer, loss over raw batches, raw batch maker) of a
    tiny seeded model whose batches ``DeviceSampler`` assembles."""
    cfg = Config()
    cfg.model.lat_dims, cfg.model.unet_nf, cfg.model.imnet_nf = 8, 4, 2
    cfg.train.alpha_pde, cfg.train.pde_loss_type = 0.1, "huber"
    rng = np.random.RandomState(3)
    stats = dict(mean=rng.randn(4), std=0.5 + rng.rand(4))
    if family == "rb2d":
        crop, lres, grid = (8, 16, 16), (4, 8, 8), (16, 24)
        pde = tphys.get_pde_layer("rb2d", t_crop=0.75, z_crop=0.5,
                                  x_crop=0.5, rayleigh=1e4, prandtl=1.0,
                                  **stats)
    else:
        cfg.model.unet_mf = 8
        cfg.physics.pde_system = "ns3d"
        crop, lres, grid = (4, 8, 8, 8), (4, 4, 4, 4), (8, 8, 10)
        pde = tphys.get_pde_layer("ns3d", t_crop=0.7, z_crop=2.0,
                                  y_crop=2.5, x_crop=3.0, viscosity=1e-2,
                                  **stats)
    frames = crop[0] + 4
    field = rng.randn(frames, *grid, 4).astype(np.float32)
    valid_t0 = np.arange(frames - crop[0] + 1)
    source = SimpleNamespace(
        lres_filter="none", lres_interp="linear", velonly=False,
        data=field, channel_mean=stats["mean"], channel_std=stats["std"],
        crop=crop, lres=lres, valid_t0=valid_t0,
        _origins=(len(valid_t0),) + tuple(
            g - c + 1 for g, c in zip(grid, crop[1:])),
        n_samp_pts_per_crop=16)
    sampler = DeviceSampler(source, device)
    unet, imnet = ttrain.build_models(cfg, lres, device)
    opt = ttrain.make_optimizer(cfg)
    state = ttrain.init_state(0, unet, imnet, opt)
    loss_fn = sampler.wrap_loss(ttrain.make_loss_fn(cfg, unet, imnet, pde))
    draws = np.random.RandomState(5)

    def raw(inner=INNER):
        bs = [sampler.draw(draws, 2) for _ in range(inner)]
        return {"origins": torch.from_numpy(np.stack([o for o, _ in bs])),
                "point_coord": torch.from_numpy(np.stack([p for _, p in
                                                          bs]))}

    return state, opt, loss_fn, raw


def _dispatch(family, n=1, on=True):
    """``n`` dispatches of ``INNER`` steps; (state, last metrics)."""
    state, opt, loss_fn, raw = _family(family)
    step = ttrain.make_multi_step(loss_fn, opt, INNER)
    if on:
        tracing.enable()
    batches = [raw() for _ in range(n)]
    for b in batches:
        state, metrics = step(state, b)
    return state, metrics


@pytest.mark.parametrize("family", FAMILIES)
def test_off_records_nothing_and_registers_no_hook(family, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a hook was registered with tracing off")

    monkeypatch.setattr(torch.autograd.graph, "register_multi_grad_hook",
                        refuse)
    _dispatch(family, on=False)
    assert not tracing.enabled()
    assert tracing.records() == [] and tracing.device_ms() == {}
    assert tracing.span("step") is tracing.span("encode") \
        is tracing.scope()


@pytest.mark.parametrize("family", FAMILIES)
def test_step_bitwise_equal_with_tracing_on(family):
    off, m_off = _dispatch(family, n=2, on=False)
    on, m_on = _dispatch(family, n=2, on=True)
    assert len(tracing.records()) == INNER * len(TRAIN)
    assert off.step == on.step == 2 * INNER
    assert sorted(m_off) == sorted(m_on)
    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k
    for k, p in off.params().items():
        assert torch.equal(p, on.params()[k]), k
    for m in ("mu", "nu"):
        for k, v in off.opt_state[m].items():
            assert torch.equal(v, on.opt_state[m][k]), (m, k)


@pytest.mark.parametrize("family", FAMILIES)
def test_train_spans_once_a_step_in_order(family):
    _dispatch(family, n=3)
    recs = tracing.records()
    assert [r.name for r in recs] == list(TRAIN) * INNER
    for g in range(INNER):
        step = recs[g * len(TRAIN):(g + 1) * len(TRAIN)]
        assert step[0].parent is None
        assert all(r.parent == "step" for r in step[1:])
        assert {r.index for r in step} == {g}
        assert {r.dispatch for r in step} == {2}      # the third dispatch
        assert all(r.start_ns <= r.end_ns for r in step)
        # The children run one after another inside the step.
        for a, b in zip(step[1:], step[2:]):
            assert a.end_ns <= b.start_ns, (a, b)
        assert step[0].start_ns <= step[1].start_ns
        assert step[-1].end_ns <= step[0].end_ns
    ms = tracing.device_ms()
    assert sorted(ms) == sorted(TRAIN)
    assert all(n == INNER and t >= 0 for t, n in ms.values())
    # On the CPU the device milliseconds are the host records'.
    assert ms["step"][0] == pytest.approx(sum(
        (r.end_ns - r.start_ns) / 1e6 for r in recs if r.name == "step"))


@pytest.mark.parametrize("family", FAMILIES)
def test_backward_spans_hand_over_pde_jet_encode(family):
    _dispatch(family)
    recs = tracing.records()
    for g in range(INNER):
        by = {r.name: r for r in recs if r.index == g}
        pde, jet, enc = (by[f"backward.{k}"] for k in ("pde", "jet",
                                                         "encode"))
        assert pde.end_ns <= jet.start_ns <= jet.end_ns <= enc.start_ns \
            <= enc.end_ns <= by["optim"].start_ns
        assert pde.parent == jet.parent == enc.parent == "step"


def test_hand_over_without_its_span_open_changes_nothing():
    """The loss alone (no step, so no backward span open): its forward
    spans record, and its hooks leave the spans as they are."""
    state, opt, loss_fn, raw = _family("rb2d")
    tracing.enable()
    with tracing.scope():
        loss, _ = loss_fn({k: v[0] for k, v in raw().items()})
        loss.backward()
    assert [r.name for r in tracing.records()] == [
        "batch", "encode", "jet_fwd", "pde"]


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_encode_once_a_window(family):
    state, _, _, _ = _family(family)
    lres = tuple(state.unet.igres)
    out_shape = tuple(2 * n for n in lres)
    decode = make_dense_decoder(state.unet.eval(), state.imnet, out_shape,
                                chunk=256)
    rng = np.random.RandomState(0)
    tracing.enable()
    for w in range(3):
        decode(rng.randn(*lres, 4).astype(np.float32))
        recs = tracing.records()
        assert [(r.name, r.parent, r.dispatch, r.index) for r in recs] == [
            ("decode.encode", None, w, 0)]
        ms = tracing.device_ms()
        assert list(ms) == ["decode.encode"] and ms["decode.encode"][1] == 1


def test_every_name_opened_is_known(monkeypatch):
    opened = []
    begin = tracing._begin
    monkeypatch.setattr(tracing, "_begin",
                        lambda name: opened.append(name) or begin(name))
    for family in FAMILIES:
        _dispatch(family)
        test_decode_encode_once_a_window(family)
    assert set(opened) == set(tracing.NAMES)
    tracing.enable()
    with pytest.raises(ValueError, match="no span"):
        with tracing.span("not_a_span"):
            pass


def _make(delay_s):
    count = iter(range(10 ** 6))

    def make_batch():
        if delay_s:
            time.sleep(delay_s)
        return {"i": np.array(next(count))}

    return make_batch


@pytest.mark.parametrize("delay_s,stalls", [(0.03, True), (0.0, False)])
def test_prefetcher_counts_stalls(delay_s, stalls):
    pf = CountingPrefetcher(_make(delay_s), depth=4)
    try:
        if not stalls:
            deadline = time.perf_counter() + 10.0
            while pf._q.qsize() < 4 and time.perf_counter() < deadline:
                time.sleep(0.005)
        got = [int(pf.get()["i"]) for _ in range(4)]
    finally:
        pf.close()
    assert got == [0, 1, 2, 3] and pf.gets == 4
    if stalls:
        assert pf.stalls >= 3 and pf.wait_s >= 0.02 * pf.stalls
    else:
        assert pf.stalls == 0 and pf.wait_s == 0.0


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_captured_step_spans_retime_every_replay(family):
    """A ``CapturedStep`` captured with tracing on: the graph holds the
    spans' events on the step's stream, two replays time them at
    different moments, the children of a step lie inside it one after
    another, and the host records name the warm-up dispatch 0 and the
    capture dispatch 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    device = torch.device("cuda")
    state, opt, loss_fn, raw = _family(family, device)
    step = ttrain.CapturedStep(loss_fn, opt, INNER, device)
    tracing.enable()
    streams = set()
    record = tracing.Record.__init__

    def on_stream(self, *a):
        record(self, *a)
        streams.add(torch.cuda.current_stream().cuda_stream)

    mark = torch.cuda.Event(enable_timing=True)
    ends = []
    for i in range(4):
        b = {k: v.to(device) for k, v in raw().items()}
        if i == 1:
            tracing.Record.__init__ = on_stream
            try:
                state, _ = step(state, b)
            finally:
                tracing.Record.__init__ = record
            recs = tracing.records()
            assert {r.dispatch for r in recs} == {1}
            assert [r.name for r in recs] == list(TRAIN) * INNER
            continue
        if i == 2:
            mark.record()
        state, _ = step(state, b)
        torch.cuda.synchronize()
        if i >= 2:
            step_end = [r for r in tracing.records()
                        if r.name == "step"][-1].events[1]
            ends.append(mark.elapsed_time(step_end))
            ms = tracing.device_ms()
            assert sorted(ms) == sorted(TRAIN)
            assert all(n == INNER and t > 0 for t, n in ms.values())
            children = sum(ms[k][0] for k in TRAIN[1:])
            assert children <= ms["step"][0]
    assert streams == {step._stream.cuda_stream}
    assert ends[1] > ends[0] > 0
