"""Nothing under gpubench/ imports JAX, flax or the JAX package
(`poco_tpu`), by top-level module name compared whole, and the reference
imports nothing of the port (`poco_tpu_torch`) either."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

import run
from conftest import GPUBENCH, REPO

SOURCES = sorted(GPUBENCH.rglob("*.py"))


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(GPUBENCH)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "poco_tpu"}


def test_reference_imports_nothing_of_the_port():
    for path in sorted((GPUBENCH / "reference").rglob("*.py")):
        assert "poco_tpu_torch" not in top_level_imports(path), path


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "poco_tpu_torch_lookalike", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert run.forbidden_modules() == ["flax"]


def test_no_card_no_result():
    """Without a CUDA card the run prints nothing on standard output and
    exits with another code than 0."""
    done = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "cliff_frames_b128",
                           "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert done.returncode != 0 and done.stdout == ""
    assert "CUDA card" in done.stderr
