"""The readers of the program's own spans and prefetch counters
(``harness/program_spans.py``, ``metrics/<name>.py``) in traced CPU runs
of the tiny cells: every new metric is in the result line, the train
spans add up within the ``step`` span, and the run's own readings are
left as they were. On a program without the span module (the tree before
it) the readers return None and the line leaves them out."""

import pytest

from stpde_bench.harness import program_spans
from stpde_bench.tests import tiny

TRAIN = ("encoder_ms.train", "jet_ms.train", "pde_ms.train",
         "optim_ms.train", "assembly_ms.train", "unspanned_ms.train",
         "prefetch_wait_ms.train")
DECODE = ("encode_ms.decode",)


@pytest.fixture(autouse=True)
def short_session(monkeypatch):
    monkeypatch.setattr(program_spans, "SESSION_S", 0.2)


@pytest.mark.parametrize("workload", tiny.TRAIN + tiny.DECODE)
def test_traced_run_reports_the_program_spans(workload):
    cell = tiny.tiny_cell(workload)
    result, _ = tiny.run_cpu(cell, traced=True)
    metrics = result["metrics"]
    names = TRAIN if workload in tiny.TRAIN else DECODE
    assert set(names) <= set(metrics)
    assert {m["name"] for m in cell.per_layer} >= set(names)
    for name in names:
        unit = metrics[name]["unit"]
        assert metrics[name]["value"] >= 0, name
        assert unit == ("ms/dispatch" if name.startswith("prefetch")
                        else "ms/window" if name in DECODE else "ms/step")
    assert result["correct"]


def test_readers_add_the_spans_of_a_layer():
    """Each train reader sums its layer's spans a step; the unspanned one
    is ``step`` less every child. The session is kept on the run, so the
    readers share one."""
    from types import SimpleNamespace

    from stpde_bench.harness import spec

    spans = {"step": 3.0, **dict.fromkeys(program_spans.TRAIN_CHILDREN,
                                          0.25)}
    run = SimpleNamespace(cell=None, trace=None, rec={
        "traced_steps": 8, "program_spans": {"spans": spans,
                                             "wait_ms": 0.125}})
    read = lambda m: spec.reader(m)(run)
    assert read("unspanned_ms.train") == pytest.approx(1.0)
    assert read("jet_ms.train") == read("encoder_ms.train") == \
        read("pde_ms.train") == 0.5
    assert read("optim_ms.train") == read("assembly_ms.train") == 0.25
    assert read("prefetch_wait_ms.train") == 0.125
    assert read("encode_ms.decode") is None       # not a decode run


@pytest.mark.parametrize("workload", (tiny.TRAIN[0], tiny.DECODE[1]))
def test_without_the_span_module_the_readers_return_none(workload,
                                                        monkeypatch):
    monkeypatch.setattr(program_spans, "MODULE",
                        "space_time_pde_torch.utils.no_such_module")
    result, _ = tiny.run_cpu(tiny.tiny_cell(workload), traced=True)
    assert not set(TRAIN + DECODE) & set(result["metrics"])
    assert result["correct"]
