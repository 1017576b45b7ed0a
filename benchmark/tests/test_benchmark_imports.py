"""What the benchmark imports, and how it fails without a card or
without the system under test."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = ROOT / "benchmark"
JAX_SIDE = {"jax", "jaxlib", "flax", "casualhdrsplat_tpu"}


def _imports(path):
    """Top-level names of every module a source file imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & JAX_SIDE


@pytest.mark.parametrize("sub", ["reference", "counts"])
def test_reference_and_counts_import_nothing_of_the_program(sub):
    for path in (BENCH / sub).rglob("*.py"):
        assert "casualhdrsplat_torch" not in set(_imports(path)), path


def test_top_level_names_compare_whole(monkeypatch):
    """The port's name begins with the JAX package's: only whole top-level
    names count."""
    import casualhdrsplat_torch  # noqa: F401

    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "casualhdrsplat_tpu.ops", sys)
    assert harness.forbidden_modules() == ["casualhdrsplat_tpu"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ladder4.train",
                           "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


def _no_result(out: str) -> bool:
    for line in out.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return False
        except ValueError:
            pass
    return True


def test_run_fails_without_a_card():
    proc = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and _no_result(proc.stdout)
    assert "CUDA" in proc.stderr


def test_run_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark")
    proc = _run(tmp_path, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and _no_result(proc.stdout)
