"""Nothing under perfbench/ imports JAX or the JAX package, the reference
and the comparison import nothing of the program, and no file reads the
JAX package's benchmark files.  Modules are compared by their top-level
name, whole: ``vector_db_torch`` begins with ``vector_db_t``."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HARNESS = Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "flax", "vector_db_tpu"}
SOURCES = sorted(HARNESS.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    HARNESS)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("name", ["reference.py", "check.py"])
def test_the_reference_imports_nothing_of_the_program(name):
    names = top_level_imports(HARNESS / name)
    assert "vector_db_torch" not in names
    assert names <= {"__future__", "collections", "contextlib", "numpy",
                     "torch"}


def test_no_file_reads_the_jax_benchmark_files():
    for path in HARNESS.rglob("*"):
        if path.is_file() and path.suffix in (".py", ".json") \
                and "tests" not in path.parts:
            text = path.read_text()
            for banned in ("BENCH_LAST_GOOD", "BASELINE.json", "benchmarks/"):
                assert banned not in text, (path, banned)


def test_top_level_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import vector_db_torch.ops\nfrom jaxtyping import X\n"
                 "import numpy as jax\n")
    assert not top_level_imports(f) & BANNED
    f.write_text("from jax import numpy\n")
    assert top_level_imports(f) & BANNED == {"jax"}
