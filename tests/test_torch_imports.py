"""The port stands alone: no module of casualhdrsplat_torch/, and not
chip_smoke.py, imports JAX, its libraries or the JAX package (not even a
module there that imports no JAX).  Parsed with `ast`, so a guarded or
lazy import inside a function counts as well; and one real import of the
command line in a fresh interpreter leaves `jax` out of sys.modules."""

import ast
import os
import subprocess
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "casualhdrsplat_tpu")


def _sources():
    out = [os.path.join(REPO_ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(REPO_ROOT, "casualhdrsplat_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_walk_finds_the_port():
    names = {os.path.relpath(p, REPO_ROOT) for p in _sources()}
    assert {"chip_smoke.py", "casualhdrsplat_torch/cli.py",
            "casualhdrsplat_torch/train/trainer.py"} <= names
    assert len(names) > 40


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO_ROOT))
def test_no_jax_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_cli_import_leaves_jax_out():
    code = ("import sys, casualhdrsplat_torch.cli, casualhdrsplat_torch.viewer.server, "
            "casualhdrsplat_torch.train.pose_align; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in %r))" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=REPO_ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


def test_parallel_import_leaves_jax_out():
    """parallel/ (the mesh, the collectives, the sharded rasterizer, the
    launcher) and the modules that reach it load without JAX."""
    names = {os.path.relpath(p, REPO_ROOT) for p in _sources()}
    parallel = {f"casualhdrsplat_torch/parallel/{m}.py" for m in
                ("distributed", "mesh", "collectives", "sharding", "render", "launch")}
    assert parallel <= names
    code = ("import sys, casualhdrsplat_torch.parallel.render, "
            "casualhdrsplat_torch.parallel.launch, casualhdrsplat_torch.parallel.sharding, "
            "casualhdrsplat_torch.train.densify, casualhdrsplat_torch.entry, "
            "casualhdrsplat_torch.bench; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in %r))" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=REPO_ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"
