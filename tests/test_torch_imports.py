"""Import hygiene of the port: no JAX stack and no JAX package.

Walks the AST of every ``.py`` under ``space_time_pde_torch/`` plus
``chip_smoke.py`` and ``experiments/rb2d/evaluation_torch.py``. (A
``sys.modules`` check cannot work: the test process imports jax for the
parity tests.) Also holds the port's copy of the config to the JAX
package's fields.
"""

import ast
import dataclasses
import os

import pytest

from space_time_pde_torch.utils import config as tcfg
from space_time_pde_tpu.utils import config as jcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "space_time_pde_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "experiments", "rb2d",
                          "evaluation_torch.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "space_time_pde_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{os.path.relpath(path, ROOT)}:{node.lineno} imports "
                f"{name}")


def test_config_copy_matches_jax():
    for name in ("ModelConfig", "DataConfig", "PhysicsConfig",
                 "TrainConfig", "Config"):
        t = [(f.name, f.default) for f in
             dataclasses.fields(getattr(tcfg, name))]
        j = [(f.name, f.default) for f in
             dataclasses.fields(getattr(jcfg, name))]
        assert t == j, name
    assert tcfg._FLAG_MAP == jcfg._FLAG_MAP
