"""The command line on a mesh, launched as the README says: `torchrun
--standalone --nproc_per_node=2 -m casualhdrsplat_torch.cli train
--device cpu parallel.gauss=2 ...`, two gloo ranks on CPU processes.

It runs what a multi-card launch runs: `cli._world_device` ->
`parallel.distributed.initialize` (torchrun's RANK / WORLD_SIZE /
MASTER_ADDR / MASTER_PORT / LOCAL_RANK through env://) -> a Trainer taking
its mesh from `cfg.parallel` -> `train()` with rank 0's logger, `save`'s
gather and barrier, and `train --resume` through `resume_or_start`.  Then
the checkpoints load into a one-device trainer.

Tolerances.  The one-device trainer loaded from the mesh's step-4
checkpoint takes steps 5 and 6: its step-6 loss within atol 1e-5 of the
one the mesh run logged (the mesh's gradient all-reduces sum in another
order; tests/test_torch_trainer_sharded.py holds the two trainers to the
same); the restored store equals the checkpoint bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch.train import checkpoint as ckpt
from casualhdrsplat_torch.train.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_cli.py's model on a (1, 2) mesh; density control off.
# The mesh bins each view whatever shared_binning says: asking for per-view
# binning makes the one-device trainer below its yardstick.
OVERRIDES = [
    "data.source=synthetic",
    "model.max_gaussians=128",
    "model.num_virtual_views=2",
    "model.sh_degree=1",
    "model.rasterize.tile_h=8",
    "model.rasterize.tile_w=16",
    "model.rasterize.tile_capacity=64",
    "model.rasterize.chunk=32",
    "model.rasterize.shared_binning=false",
    "densify.enabled=false",
    "log_every=2",
    "eval_every=4",
    "checkpoint_every=2",
    "parallel.gauss=2",
]
RANKS = 2


def torchrun(*args, cwd):
    """`torchrun --standalone --nproc_per_node=RANKS -m
    casualhdrsplat_torch.cli <args>` (the standalone rendezvous picks a
    free local port); returns the completed process."""
    env = dict(os.environ, PYTHONPATH=REPO_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={RANKS}", "-m", "casualhdrsplat_torch.cli", *args],
        capture_output=True, text=True, timeout=300, cwd=str(cwd), env=env)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """`train` to step 4, then `train --resume` to step 6, each in a world of
    RANKS launched by torchrun: (checkpoint root, the two processes)."""
    tmp = tmp_path_factory.mktemp("cli_mesh")
    out = tmp / "out"
    common = ["--device", "cpu", *OVERRIDES, f"out_dir={out}"]
    first = torchrun("train", *common, "optim.max_steps=4", cwd=tmp)
    assert first.returncode == 0, first.stderr[-4000:]
    again = torchrun("train", "--resume", *common, "optim.max_steps=6", cwd=tmp)
    assert again.returncode == 0, again.stderr[-4000:]
    return out / "casual-hdr-splat", first, again


def test_mesh_train_writes_one_run(mesh_run):
    """Every rank ran to the end; rank 0 alone wrote the logs, in the
    one-device layout."""
    root, first, again = mesh_run
    assert first.stdout.count("final:") == RANKS
    assert again.stdout.count("resumed from step 4") == RANKS
    assert sorted(os.listdir(root)) == ["config.json", "metrics.jsonl", "step_2", "step_4",
                                        "step_6"]
    with open(root / "config.json") as f:
        cfg = t_config.from_dict(json.load(f))
    assert (cfg.parallel.data, cfg.parallel.gauss) == (1, RANKS)
    with open(root / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    train_rows = [r["step"] for r in rows if "loss" in r]
    eval_rows = [r["step"] for r in rows if "eval_psnr" in r]
    assert train_rows == [2, 4, 6] and eval_rows == [4]  # once each, not once per rank
    assert all(np.isfinite(r["loss"]) for r in rows if "loss" in r)
    assert ckpt.restore(str(root / "step_6"))["step"] == 6


def test_mesh_checkpoint_loads_into_one_device_trainer(mesh_run):
    """The mesh's step-4 checkpoint restores a one-device trainer bit for
    bit, and its steps 5-6 reach the loss the resumed mesh run logged."""
    root, _, _ = mesh_run
    with open(root / "config.json") as f:
        cfg = t_config.from_dict(json.load(f))
    cfg.parallel = t_config.ParallelConfig()  # one process, one device
    one = Trainer(cfg, device="cpu")
    one.load(str(root / "step_4"))
    saved = ckpt.restore(str(root / "step_4"))["params"]["gaussians"]
    for k, v in saved.items():
        assert torch.equal(one.params["gaussians"][k], v), k
    assert one.step == 4
    one.run_step()
    step6 = one.run_step()
    with open(root / "metrics.jsonl") as f:
        logged = next(r for r in map(json.loads, f) if r["step"] == 6 and "loss" in r)
    assert abs(step6["loss"] - logged["loss"]) <= 1e-5, (step6["loss"], logged["loss"])
