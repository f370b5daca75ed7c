"""No module of the benchmark imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is the port), and the
reference imports nothing of the port either.  A run on a machine
without the card exits non-zero and prints no result."""

from __future__ import annotations

import ast
import subprocess
import sys
import types
from pathlib import Path

import pytest

from causal_bench.harness.main import BANNED, banned_modules

BENCH = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_module_imports_jax_or_the_jax_package(path):
    names = set(_imports(path))
    assert not names & {"jax", "jaxlib", "flax", "repro"}, names
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in names and "causal_bench" not in names


def test_banned_names_are_compared_whole(monkeypatch):
    assert BANNED == {"jax", "jaxlib", "flax", "repro"}
    before = set(banned_modules())
    monkeypatch.setitem(sys.modules, "repro_torch.x", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert set(banned_modules()) == before
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert "repro" in banned_modules()


def test_no_card_no_result(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "kreg10k.poisson", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0
    assert "correct" not in proc.stdout
