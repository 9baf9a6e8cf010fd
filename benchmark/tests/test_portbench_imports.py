"""The import guard: nothing under benchmark/ imports JAX or the JAX
package, and the plain reference imports nothing of the program.  Each
import's top-level name (before the first dot) is compared whole:
``kmeans_tpu_torch`` begins with ``kmeans_tpu`` and is not it."""

import ast

import pytest

from benchmark import spec

JAX = {"jax", "jaxlib", "flax", "kmeans_tpu"}
PROGRAM = {"kmeans_tpu_torch"}


def top_level_imports(source: str) -> set:
    """Top-level module names a source imports: ``import a.b``, ``from a.b
    import c``, ``importlib.import_module("a.b")`` and ``__import__``
    with a literal name.  Relative imports name no top-level module."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call):
            fn = node.func
            called = (fn.attr if isinstance(fn, ast.Attribute)
                      else getattr(fn, "id", None))
            if (called in ("import_module", "__import__") and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                names.add(node.args[0].value.split(".", 1)[0])
    return names


def _sources(sub=""):
    root = spec.BENCH_DIR / sub
    return sorted(p for p in root.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(spec.BENCH_DIR)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path.read_text()) & JAX


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: str(
    p.relative_to(spec.BENCH_DIR)))
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path.read_text())
    assert not names & (JAX | PROGRAM)
    assert "benchmark" not in names


@pytest.mark.parametrize("snippet,found", [
    ("import kmeans_tpu_torch", {"kmeans_tpu_torch"}),
    ("import kmeans_tpu", {"kmeans_tpu"}),
    ("from kmeans_tpu.ops import lloyd", {"kmeans_tpu"}),
    ("from kmeans_tpu_torch.ops import lloyd", {"kmeans_tpu_torch"}),
    ("import jax.numpy as jnp", {"jax"}),
    ("importlib.import_module('jaxlib.xla')", {"jaxlib"}),
    ("__import__('flax')", {"flax"}),
    ("from . import data", set()),
])
def test_guard_compares_whole_top_level_names(snippet, found):
    names = top_level_imports(snippet)
    assert names & (JAX | PROGRAM) == found
