"""The card a run uses, the process's start, and the check that nothing
of JAX was loaded."""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "space_time_pde_tpu")


def process_start() -> float:
    """The process's start on the ``time.time`` clock (from
    ``/proc/self/stat``, whose resolution is a clock tick); the first
    call's clock where that file is not there."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        started = int(fields[19]) / ticks
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return time.time()


def require_cards(n: int) -> None:
    """Exit with 3 (no result) unless ``n`` CUDA cards are here."""
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this benchmark measures the card and "
                 "reports nothing from a CPU")
    if torch.cuda.device_count() < n:
        sys.exit(f"the cell needs {n} CUDA devices, this machine has "
                 f"{torch.cuda.device_count()}")


def power_limit_w() -> str:
    """The card's power limit as ``nvidia-smi`` reads it ('' where it
    cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def info(device: torch.device, chips: int) -> dict:
    cuda = device.type == "cuda"
    return {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": chips,
        "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                              if cuda else 0),
    }


def loaded_forbidden(modules=None) -> list:
    """Top-level names of ``modules`` (default: ``sys.modules``) that are
    JAX's or the JAX package's, compared whole."""
    names = list(sys.modules if modules is None else modules)
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))
