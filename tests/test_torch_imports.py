"""Import hygiene of the port: no JAX stack and no JAX package.

Walks the AST of every ``.py`` under ``space_time_pde_torch/`` plus
``chip_smoke.py``, ``experiments/{rb2d,turb3d}/{evaluation,train,
generate_data}_torch.py`` and the port's scripts
(``scripts/profile_torch_step.py``, ``scripts/time_bf16_{decode,jet}.py``,
``scripts/rb2d_stats.py``, ``scripts/f32_{flip_check,decode_emulation}.py``,
``scripts/train_{curve,from_scratch,bf16_products}.py``,
``scripts/turb3d_grad_attribution.py``).
(A ``sys.modules`` check cannot work: the test process imports jax for
the parity tests.) Also holds the port's copies of JAX-free modules (the
config's fields; the prefetcher, metrics logger, cliff detector and 4-D
dataset, class for class) to the JAX package's.
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
    files = [os.path.join(ROOT, "chip_smoke.py")]
    files += [os.path.join(ROOT, "experiments", family, f"{name}_torch.py")
              for family in ("rb2d", "turb3d")
              for name in ("evaluation", "train")]
    files += [os.path.join(ROOT, "experiments", family,
                           "generate_data_torch.py")
              for family in ("rb2d", "turb3d")]
    files += [os.path.join(ROOT, "scripts", name) for name in (
        "profile_torch_step.py", "time_bf16_decode.py", "time_bf16_jet.py",
        "rb2d_stats.py", "f32_flip_check.py", "f32_decode_emulation.py",
        "train_curve.py", "train_from_scratch.py",
        "turb3d_grad_attribution.py", "train_bf16_products.py")]
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


COPIES = [("data/prefetch.py", "data/prefetch.py", "BatchPrefetcher"),
          ("utils/logging.py", "utils/logging.py", "MetricsLogger"),
          ("train/recovery.py", "train/recovery.py", "CliffDetector"),
          ("data/dataset4d.py", "data/dataset4d.py", "Field4DDataset")]


@pytest.mark.parametrize("port,jax_path,cls", COPIES,
                         ids=[c[2] for c in COPIES])
def test_framework_free_copies_match_jax(port, jax_path, cls):
    """The copied classes are the JAX package's, statement for
    statement."""
    def class_ast(pkg, rel):
        with open(os.path.join(ROOT, pkg, rel)) as f:
            tree = ast.parse(f.read())
        node = next(n for n in tree.body
                    if isinstance(n, ast.ClassDef) and n.name == cls)
        return ast.dump(node)

    assert class_ast("space_time_pde_torch", port) == \
        class_ast("space_time_pde_tpu", jax_path)
