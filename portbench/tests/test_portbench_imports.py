"""Nothing under ``portbench/`` imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level names are compared
whole: the program's name begins with the JAX package's."""

from __future__ import annotations

import ast

import pytest

from portbench import run, spec

SOURCES = sorted(spec.HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "srcnn_cpp_tpu"}


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(spec.HERE)) for p in SOURCES])
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((spec.HERE / "reference").rglob("*.py")):
        assert "srcnn_cpp_tpu_torch" not in top_level_imports(path), path


def test_whole_names_are_compared(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "srcnn_cpp_tpu_torch_like",
                        types.ModuleType("srcnn_cpp_tpu_torch_like"))
    assert "srcnn_cpp_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla",
                        types.ModuleType("jaxlib.xla"))
    assert run.forbidden_modules() == ["jaxlib"]
