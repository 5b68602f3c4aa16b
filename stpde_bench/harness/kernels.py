"""Kernel names: which device records come from the program's own CUDA
sources (``space_time_pde_torch/csrc``), which family of hand-written
kernel each belongs to, and a short readable name for every record.

The program's kernels live in anonymous namespaces, so the trace names
them ``(anonymous namespace)::<name>...``; the set of ``<name>`` is read
from the sources' ``__global__`` declarations. PyTorch's own kernels
live in named namespaces (``at::native::...``) or are cuBLAS's.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[2] / "space_time_pde_torch" / "csrc"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__\w+__\s*\([^)]*\)\s*)*"
                     r"(\w+)\s*\(", re.S)
_ANON = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)")

# Families of hand-written kernels by the trace's names. The f32 jet's
# forward builds its weight image, runs its layers (FwdLayer) and its
# head; its backward runs its head, its layers (the Nt / Tn products),
# the bias gradients and the split-K reductions.
FAMILIES = {
    "decode f32": r"decode_blend_kernel<\d+, true>",
    "jet_fwd f32": (r"weight_image_kernel|jet_head_fwd_kernel<\d, float>"
                    r"|FwdLayer<"),
    "jet_bwd f32": (r"jet_head_bwd_kernel<\d, float>|bias_grad_kernel<\d, "
                    r"\d, float>|reduce_kernel|::Nt<|::Tn<"),
}


@functools.lru_cache(maxsize=1)
def csrc_names() -> frozenset:
    names = set()
    for path in list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")):
        names.update(_GLOBAL.findall(path.read_text()))
    return frozenset(names)


def is_csrc(name: str) -> bool:
    m = _ANON.match(name)
    return bool(m) and m.group(1) in csrc_names()


def family(name: str) -> Optional[str]:
    """The hand-written family of a record, None for any other."""
    if not is_csrc(name):
        return None
    for fam, pattern in FAMILIES.items():
        if re.search(pattern, name):
            return fam
    return "other csrc"


def readable(name: str) -> str:
    """A short name: the family of a hand-written kernel, else the
    function's own name without namespaces, template arguments or
    parameters (cuBLAS's kernels by their first 48 characters)."""
    fam = family(name)
    if fam is not None:
        return fam
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    core = name[5:] if name.startswith("void ") else name
    core = core.replace("(anonymous namespace)", "anon")
    cut = min((i for i in (core.find("<"), core.find("(")) if i >= 0),
              default=len(core))
    core = core[:cut].split("::")[-1].strip()
    return (core or name)[:48]
