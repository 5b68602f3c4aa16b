"""The harness takes a new configuration, traffic mix, metric and cell
as files and entries alone: added to a copy of the benchmark, they are
found by name with no edit to any file that was there, and the run
prints its result line with the contract's keys."""

import io
import json
import shutil
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from stpde_bench.harness import spec
from stpde_bench.tests import tiny

METRIC = '''"""Optimizer steps a dispatch (a metric added as a file)."""


def read(run):
    rec = run.rec
    return rec["steps"] / rec["dispatches"] if "steps" in rec else None
'''


@pytest.fixture
def copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.ROOT / "stpde_bench", root / "stpde_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    base = json.loads((spec.ROOT / "stpde_bench/configs/rb2d-flagship.json")
                      .read_text())
    cfg = dict(tiny.tiny_config(base), name="rb2d-tiny")
    b = root / "stpde_bench"
    (b / "configs/rb2d-tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic/train-f32.json").read_text())
    (b / "traffic/train-f32-short.json").write_text(json.dumps(
        dict(traffic, check_steps=2, traced_dispatches=1)))
    (b / "limits/rb2d-tiny-train.json").write_text(json.dumps(
        {"loss_gap": 1e-3, "grad_gap": 3e-4, "change_gap": 2e-2}))
    (b / "metrics/steps_per_dispatch.train.py").write_text(METRIC)
    bench["configs"].append({"name": "rb2d-tiny", "source": base["source"],
                             "file": "stpde_bench/configs/rb2d-tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "rb2d-tiny-train",
                               "config": "rb2d-tiny",
                               "traffic": "train-f32-short", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_step_ms":
            m["workloads"].append("rb2d-tiny-train")
    bench["per_layer"].append({"name": "steps_per_dispatch.train",
                               "unit": "steps", "better": "higher",
                               "source": "program_counter",
                               "layer": "train step",
                               "moves": "train_step_ms",
                               "workloads": ["rb2d-tiny-train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, before


def _line(root, traced):
    from stpde_bench.run import emit

    cell = spec.resolve("rb2d-tiny-train", root)
    result, numbers = tiny.run_cpu(cell, traced=traced, root=root)
    out = io.StringIO()
    with redirect_stdout(out):
        emit(result, numbers, cell.limits)
    return cell, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("traced", [False, True])
def test_additions_resolve_by_name(copy, traced):
    root, before = copy
    cell, line = _line(root, traced)
    unchanged = {p for p, data in before.items()
                 if p.read_bytes() == data}
    edited = set(before) - unchanged - {root / "BENCHMARK.json"}
    assert not edited
    assert cell.config["name"] == "rb2d-tiny"
    assert cell.traffic["check_steps"] == 2
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if traced else []
    assert list(line) == keys + ["checks"]
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    if traced:
        assert line["metrics"]["steps_per_dispatch.train"]["value"] == 4
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"setup_s", "train_step_ms"}
