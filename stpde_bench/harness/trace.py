"""The device trace of a short traced window and its reduction.

``torch.profiler`` with host and device activity; the reduction reads
the profiler's raw records (building its Python events for the hundreds
of thousands of launches of a traced training window would take tens
of seconds). The device is busy where any kernel, copy or fill runs: the
union of their intervals. An idle gap is an interval of the window that
no device record covers; it is named by the benchmark's host span that
overlaps it most (``idle`` where none does).
"""

from __future__ import annotations

import contextlib
import warnings
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

from stpde_bench.harness import kernels

WINDOW = "traced_window"


@dataclass
class Trace:
    records: List[Tuple[str, int, int]] = field(default_factory=list)
    spans: List[Tuple[str, int, int]] = field(default_factory=list)
    start_ns: int = 0
    end_ns: int = 0

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def kernels(self) -> List[Tuple[str, int, int]]:
        return [r for r in self.records
                if not r[0].startswith(("Memcpy", "Memset"))]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        out: List[Tuple[int, int]] = []
        for _, a, b in sorted(self.records, key=lambda r: r[1]):
            a, b = max(a, self.start_ns), min(b, self.end_ns)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        out, t = [], self.start_ns
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end_ns > t:
            out.append((t, self.end_ns))
        return out

    def seconds_by(self, name_of) -> Dict[str, float]:
        """Device seconds of the kernels grouped by ``name_of(name)``
        (records it maps to None are left out)."""
        out: Dict[str, float] = defaultdict(float)
        for name, a, b in self.kernels():
            key = name_of(name)
            if key is not None:
                out[key] += (b - a) / 1e9
        return dict(out)

    def count_by(self, name_of) -> Dict[str, int]:
        out: Dict[str, int] = defaultdict(int)
        for name, _, _ in self.kernels():
            key = name_of(name)
            if key is not None:
                out[key] += 1
        return dict(out)

    def idle_by_span(self) -> Dict[str, float]:
        """Idle seconds of the window by the host span open at the time."""
        spans = sorted((a, b, n) for n, a, b in self.spans)
        out: Dict[str, float] = defaultdict(float)
        first = 0
        for ga, gb in self.gaps():      # in order; the spans do not nest
            while first < len(spans) and spans[first][1] <= ga:
                first += 1
            best, name = 0, "idle"
            for a, b, n in spans[first:]:
                if a >= gb:
                    break
                over = min(b, gb) - max(a, ga)
                if over > best:
                    best, name = over, n
            out[name] += (gb - ga) / 1e9
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.seconds_by(kernels.readable).items(),
                     key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_span().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps[:top]]}


@contextlib.contextmanager
def traced(spans, device, warm=None):
    """Trace the block on ``device``; yields the :class:`Trace` that is
    filled when the block ends (ended by a synchronise). ``warm()`` runs
    first under the tracer but outside the traced window (a CUDA graph's
    first replay under the tracer is slower than the rest)."""
    result = Trace()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    names = set()
    spans.traced = True
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with torch.profiler.profile(activities=acts) as prof:
            if warm is not None:
                warm()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            with torch.profiler.record_function(WINDOW):
                yield result
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
    spans.traced = False
    names.update(n for n, _, _ in spans.records)
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            # The device side of a host range (a user annotation) is no
            # device work.
            if name not in names and name != WINDOW:
                result.records.append((name, e.start_ns(), e.end_ns()))
        elif name == WINDOW:
            result.start_ns, result.end_ns = e.start_ns(), e.end_ns()
        elif name in names:
            result.spans.append((name, e.start_ns(), e.end_ns()))
    inside = lambda r: r[1] >= result.start_ns and r[2] <= result.end_ns
    result.records = [r for r in result.records if inside(r)]
    result.spans = [r for r in result.spans if inside(r)]
