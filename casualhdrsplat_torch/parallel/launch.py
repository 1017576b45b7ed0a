"""Start a world of ranks in this machine's processes and collect what each
returns.  The one launcher of the tests, `entry.dryrun_multichip` and
chip_smoke.py (a multi-card run launches with torchrun instead).

    results = spawn(fn, world=4, backend="gloo", device="cpu", args=(...))

Each rank runs `fn(rank, device, *args)` in a fresh process (the `spawn`
start method, so `fn` must be importable by name), in a process group
initialized through a `file://` rendezvous in a temporary directory: no
port to pick, so parallel test workers never collide.  What `fn` returns is
written with `torch.save` and read back, in rank order.  A rank that
raises fails the launch: the others are stopped and the error is raised
here.  The reference runs its mesh on virtual CPU devices in one process
instead.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from casualhdrsplat_torch.parallel.distributed import backend_for, rank_device


def _rank_main(rank, fn, world, backend, device, init, out_dir, args, threads):
    if threads:
        torch.set_num_threads(threads)
    dev = rank_device(device, rank)
    dist.init_process_group(backend_for(dev, backend), init_method=init, world_size=world,
                            rank=rank)
    try:
        result = fn(rank, dev, *args)
        torch.save(result, os.path.join(out_dir, f"rank_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, backend: str, device, args=(), threads: int = 1,
          timeout: float = 1800.0) -> list:
    """Run `fn(rank, device, *args)` on `world` ranks; returns their results
    in rank order.  `backend` is required ("gloo" or "nccl"); `device`
    "cpu", or "cuda" (rank r on card r % cards).  Each rank runs
    `threads` torch threads (0: torch's default).  Raises TimeoutError,
    after stopping every rank, when the world is not done in `timeout`
    seconds."""
    with tempfile.TemporaryDirectory(prefix="chs-world-") as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, backend, str(device), init, tmp, tuple(args), threads),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"world of {world} not done in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(10)
        return [torch.load(os.path.join(tmp, f"rank_{r}.pt"), weights_only=False)
                for r in range(world)]
