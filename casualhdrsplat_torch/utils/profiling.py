"""Tracing and timing helpers.  Counterpart of casualhdrsplat_tpu/utils/
profiling.py: per-section wall-clock timers, a completion-forced timing
helper, and a torch.profiler trace (Chrome trace format, for Perfetto or
chrome://tracing).

PyTorch returns from a CUDA call before the card has finished it, so every
measurement here ends in `sync`, which waits for the card when the result
lies on one (`torch.cuda.synchronize()`) and costs nothing on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def sync(tree) -> None:
    """Wait until the card has computed every tensor of `tree` (nested
    dicts, lists and tuples); a no-op for CPU tensors."""
    for t in _tensors(tree):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1) -> float:
    """Wall-clock seconds per call, completion-forced."""
    for _ in range(warmup):
        sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    sync(out)
    return (time.perf_counter() - t0) / iters


def mpix_per_s(fn: Callable, *args, pixels: int, iters: int = 10) -> float:
    """Megapixels rendered per second."""
    return pixels / time_fn(fn, *args, iters=iters) / 1e6


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (host and, where there is one, the
    card), written as a Chrome trace into `log_dir`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


class SectionTimers:
    """Named wall-clock section accumulators (per-section means)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, tree=None):
        """Time the block; with `tree`, wait for its tensors first."""
        t0 = time.perf_counter()
        yield
        if tree is not None:
            sync(tree)
        self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1) for k in sorted(self.totals)}
