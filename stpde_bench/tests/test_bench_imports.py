"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program either (top-level module names
compared whole: the program's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "space_time_pde_tpu"}
PROGRAM = "space_time_pde_torch"


def _sources():
    return sorted(p for p in BENCH.rglob("*.py")
                  if "tests" not in p.relative_to(BENCH).parts)


def _top_names(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_the_benchmark_has_sources():
    names = {p.relative_to(BENCH).as_posix() for p in _sources()}
    assert {"run.py", "reference/train.py", "harness/trace.py"} <= names


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax(path):
    bad = set(_top_names(path)) & JAX
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(_top_names(path))
    assert PROGRAM not in names and not names & JAX, names


def test_the_check_compares_whole_names():
    """``space_time_pde_torch`` begins with the JAX package's name's
    first letters but is not it; ``jaxtyping`` is not ``jax``."""
    from stpde_bench.harness.device import loaded_forbidden

    assert loaded_forbidden(["space_time_pde_torch.ops", "jaxtyping",
                             "numpy"]) == []
    assert loaded_forbidden(["jax.numpy", "space_time_pde_tpu.models",
                             "flax"]) == ["flax", "jax",
                                          "space_time_pde_tpu"]
