"""Multi-process start-up and failure recovery.  Counterpart of
casualhdrsplat_tpu/parallel/distributed.py.

One process per rank, SPMD: `initialize` joins the process group that a
launcher described in the environment, and `resume_or_start` restores the
latest periodic checkpoint (train/checkpoint.py), so a crashed or
preempted job restarted with the same command recovers to it on every
rank.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from casualhdrsplat_torch.train import checkpoint as ckpt_mod


def launched_world() -> bool:
    """Whether a launcher described a world in the environment: torchrun's
    RANK / WORLD_SIZE, or the reference's COORDINATOR_ADDRESS."""
    return "WORLD_SIZE" in os.environ or "COORDINATOR_ADDRESS" in os.environ


def backend_for(device: torch.device, backend: Optional[str] = None) -> str:
    """The process-group backend: `backend` when given, else nccl for a
    CUDA device and gloo for the CPU.  Nothing switches silently: NCCL
    refuses two ranks on one card, and a caller that wants that (one card,
    several ranks) asks for gloo."""
    return backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")


def rank_device(device, rank: int) -> torch.device:
    """The device of a rank: `device` as given, and a CUDA device without
    an index becomes card `rank % cards` (made current)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def initialize(backend: Optional[str] = None, device=None) -> Optional[torch.device]:
    """Join the process group a launcher described; returns this rank's
    device, or None in a single process (nothing to join).

    torchrun's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT / LOCAL_RANK
    are read through `env://`; the reference's COORDINATOR_ADDRESS
    (host:port) / NUM_PROCESSES / PROCESS_ID through `tcp://`.  `device`
    defaults to the card of LOCAL_RANK; the backend is `backend_for` it.
    """
    if not launched_world():
        return None
    if "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        init = "env://"
    else:
        rank = int(os.environ.get("PROCESS_ID", 0))
        world = int(os.environ.get("NUM_PROCESSES", 1))
        local = rank
        init = f"tcp://{os.environ['COORDINATOR_ADDRESS']}"
    dev = rank_device(device or "cuda", local)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(dev, backend), init_method=init,
                                world_size=world, rank=rank)
    return dev


def resume_or_start(trainer, ckpt_root: str) -> int:
    """Restore the latest checkpoint under `ckpt_root` if one exists.

    Returns the step resumed from (0 for a fresh start).  With periodic
    `trainer.save`, a crashed or preempted job restarted with the same
    command recovers to its last checkpoint."""
    latest = ckpt_mod.latest_step_dir(ckpt_root)
    if latest is None:
        return 0
    trainer.load(latest)
    return trainer.step
