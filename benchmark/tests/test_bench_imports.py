"""What the benchmark may import: no module under ``benchmark/`` imports
JAX, its libraries or the JAX package, and no module of the reference
imports the port. Top-level names are compared whole: the port's name
begins with the JAX package's."""
import ast
import os
import sys
import types

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "drawingspinup_tpu"}
BENCH_DIR = os.path.join(ROOT, "benchmark")


def _modules(top):
    for dirpath, dirs, files in os.walk(top):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    """Top-level names of every import in the file (at any depth)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_modules(BENCH_DIR)),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_modules(os.path.join(
    BENCH_DIR, "reference"))), ids=lambda p: os.path.relpath(p, ROOT))
def test_reference_imports_nothing_of_the_port(path):
    assert "drawingspinup_torch" not in _imports(path)
    assert _imports(path) <= {"__future__", "functools", "typing", "numpy",
                              "torch", "benchmark"}


def test_guard_compares_whole_top_level_names(monkeypatch):
    import drawingspinup_torch  # noqa: F401  (a prefix of nothing forbidden)

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "drawingspinup_tpu.core",
                        types.ModuleType("drawingspinup_tpu.core"))
    monkeypatch.setitem(sys.modules, "jaxlib",
                        types.ModuleType("jaxlib"))
    assert harness.forbidden_modules() == ["drawingspinup_tpu", "jaxlib"]


def test_run_with_jax_loaded_gives_no_result(run_tiny, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(RuntimeError, match="jax"):
        run_tiny("style2_plain.serve")
