"""The benchmark's own host spans around its calls into the program:
name, start and end on the host's clock, kept in memory. While a device
trace is on, each span is also a ``record_function`` range, so that the
trace can name what the host was doing during a gap on the device."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


class Spans:
    def __init__(self):
        self.records: List[Tuple[str, float, float]] = []
        self.traced = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.traced:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.records.append((name, t0, time.perf_counter()))

    def clear(self) -> None:
        self.records.clear()

    def totals(self) -> Dict[str, float]:
        """Seconds spent in each span name."""
        out: Dict[str, float] = defaultdict(float)
        for name, a, b in self.records:
            out[name] += b - a
        return dict(out)
