"""Nothing under ``benchmark/`` imports JAX or the JAX package, compared by whole top-level
name (``aurora_tpu_torch`` begins with ``aurora_tpu``); ``benchmark/reference/`` imports
nothing of the port either; the run's own look at ``sys.modules`` compares the same way."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark import run

HERE = Path(run.__file__).resolve().parent
JAX = {"jax", "jaxlib", "flax", "aurora_tpu"}


def imported(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imported(path) & JAX


def test_the_reference_imports_nothing_of_the_port():
    for path in (HERE / "reference").rglob("*.py"):
        assert not imported(path) & (JAX | {"aurora_tpu_torch"}), path


def test_the_run_s_look_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "aurora_tpu_torch_fake", object())
    assert "aurora_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "aurora_tpu.fake", object())
    assert "aurora_tpu.fake" in run.forbidden_modules()
