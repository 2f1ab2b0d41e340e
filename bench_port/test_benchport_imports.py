"""What the benchmark may import: never JAX nor the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and the
reference nothing of the program either."""

import ast
import pathlib

import pytest

from bench_port import harness

BANNED = set(harness.FORBIDDEN_MODULES)
FILES = sorted(p for p in harness.BENCH.rglob("*.py")
               if "__pycache__" not in p.parts)
#: The yardstick: it takes nothing from the program.
YARDSTICK = [harness.BENCH / "judge.py", *(harness.BENCH / "reference").glob(
    "*.py"), *(harness.BENCH / "work").glob("*.py"),
    *(harness.BENCH / "data").glob("*.py")]


def _roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(harness.ROOT).as_posix())
def test_no_jax_and_no_jax_package(path):
    assert not set(_roots(path)) & BANNED


@pytest.mark.parametrize("path", YARDSTICK,
                         ids=lambda p: p.relative_to(harness.ROOT).as_posix())
def test_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(_roots(path))
    assert set(_roots(path)) <= {"__future__", "contextlib", "math", "numpy",
                                 "torch", "bench_port"}


def test_forbidden_names_are_compared_whole():
    assert "repro_torch" not in BANNED and "repro" in BANNED
    assert set(harness.FORBIDDEN_MODULES) == {"jax", "jaxlib", "flax",
                                              "repro"}


def test_harness_finds_a_loaded_forbidden_module(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro.fake", types.ModuleType("x"))
    assert "repro" in harness.forbidden_loaded()
