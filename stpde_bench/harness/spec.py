"""``BENCHMARK.json`` and the files it names, resolved by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's file is the entry's ``file``; the traffic mix
is ``traffic/<traffic>.json``; the cell's limits for ``correct`` are
``limits/<workload>.json``; each metric is read by ``metrics/<metric
name>.py``; the field generator of a configuration is
``fields/<kind>.py``. Adding a cell, a mix, a metric or a field kind
adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, str(path))
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lists(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"there are {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"])
                        .read_text())
    bench_dir = root / "stpde_bench"
    traffic = json.loads((bench_dir / "traffic" /
                          f"{entry['traffic']}.json").read_text())
    limits = json.loads((bench_dir / "limits" / f"{workload}.json")
                        .read_text())
    e2e = [m for m in bench["end_to_end"] if _lists(m, workload)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return Cell(workload, entry, config, traffic, limits, e2e, layer)


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` of ``metrics/<metric>.py``."""
    path = root / "stpde_bench" / "metrics" / f"{metric}.py"
    return load_module(path, "stpde_metric_" + metric.replace(".", "_")
                       .replace("-", "_")).read


def field_maker(kind: str, root: Path = ROOT):
    return load_module(root / "stpde_bench" / "fields" / f"{kind}.py",
                       "stpde_fields_" + kind.replace("-", "_"))
