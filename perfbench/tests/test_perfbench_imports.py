"""No module of the benchmark imports `jax`, `jaxlib`, `flax` or `repro`
(whole top-level names: `repro_torch` is not `repro`), and the frozen
design, the work counts and the reference import nothing of the program
(an AST walk; nothing is imported)."""
from __future__ import annotations

import ast

import pytest

import _cells
from perfbench.harness import FORBIDDEN, forbidden_modules

BENCH = _cells.ROOT / "perfbench"
SOURCES = sorted(BENCH.rglob("*.py"))
STANDALONE = ("design.py", "reference.py", "work.py")


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_sources_found():
    names = {p.relative_to(BENCH).as_posix() for p in SOURCES}
    assert {"run.py", "harness.py", *STANDALONE} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_or_reference_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", STANDALONE)
def test_yardstick_imports_nothing_of_the_program(name):
    imports = top_level_imports(BENCH / name)
    assert "repro_torch" not in imports and "perfbench" not in imports


def test_forbidden_names_are_whole():
    mods = ["repro_torch", "repro_torch.kernels", "reprox", "jaxtyping",
            "numpy"]
    assert forbidden_modules(mods) == []
    assert forbidden_modules(mods + ["repro.core", "jax", "flax.linen",
                                     "jaxlib"]) == [
        "flax.linen", "jax", "jaxlib", "repro.core"]
