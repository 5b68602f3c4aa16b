"""Metrics logging: JSONL (grep-able) + optional TensorBoard.

A copy of ``space_time_pde_tpu/utils/logging.py`` (framework-free; the
JAX package's ``utils/__init__`` imports jax). The primary sink is a
plain JSONL file (one dict per step), with TensorBoard as an optional
mirror where it is installed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a",
                        buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def log(self, step: int, metrics: Dict[str, float],
            prefix: str = "") -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            rec[key] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, float(v), int(step))
        self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
