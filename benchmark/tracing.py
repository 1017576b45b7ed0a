"""The traced run: torch.profiler over a bounded slice of steps or
requests (each inside a `bench.*` range of the benchmark's own), read
back from its Chrome trace, and the per-layer metric readers
(benchmark/metrics/<name>.py) that take their numbers from it.

The slice's window is the span from the first `bench.*` range's start to
the last one's end: each range ends in a host read, so the device work it
started lies inside it.  Busy time is the union of the device's kernel,
copy and set intervals inside the window; an idle gap is named by the
innermost host event (an operator, a runtime call or a benchmark range)
under its start.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import tempfile
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from benchmark.counts import work as work_mod

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
MARK = "bench."
TOP = 10


@contextlib.contextmanager
def profile(device: torch.device):
    """torch.profiler over the block, host and (on a CUDA device) card."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with torch_profile(activities=acts) as prof:
        yield prof
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _events(prof) -> List[dict]:
    """The profile's complete events, through a Chrome trace in TMPDIR."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


class TraceReading:
    """What the readers see: the slice's window and busy time, the device
    time of kernels by name, and the work the slice's inputs needed
    (counted once, on first use)."""

    def __init__(self, kind: str, units: int, prof, work: Callable[[], work_mod.Work],
                 model: dict):
        self.kind, self.units, self.model = kind, units, model
        self._work_fn, self._work = work, None
        ev = _events(prof)
        marks = [e for e in ev if e.get("cat") == "user_annotation"
                 and e["name"].startswith(MARK)]
        self.lo = min(e["ts"] for e in marks)
        self.hi = max(e["ts"] + e["dur"] for e in marks)
        self.device = sorted(
            (e["name"], max(e["ts"], self.lo), min(e["ts"] + e["dur"], self.hi))
            for e in ev if e.get("cat") in DEVICE_CATS)
        self.device = [d for d in self.device if d[2] > d[1]]
        self.device.sort(key=lambda d: d[1])
        # host events by the 1 ms bins they overlap, to name a gap quickly
        self.host: Dict[int, list] = defaultdict(list)
        for e in ev:
            if e.get("cat") in HOST_CATS:
                for b in range(int(e["ts"] // 1000), int((e["ts"] + e["dur"]) // 1000) + 1):
                    self.host[b].append((e["name"], e["ts"], e["ts"] + e["dur"]))
        self.window_s = (self.hi - self.lo) * 1e-6
        self.busy_s, self._gaps = self._union()

    def _union(self) -> Tuple[float, List[Tuple[float, float]]]:
        busy, gaps, end = 0.0, [], self.lo
        for _, s, e in self.device:
            if s > end:
                gaps.append((end, s))
            if e > end:
                busy += e - max(s, end)
                end = e
        if self.hi > end:
            gaps.append((end, self.hi))
        return busy * 1e-6, gaps

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose name contains one of `names`."""
        return sum(e - s for n, s, e in self.device if any(k in n for k in names)) * 1e-6

    def work(self) -> work_mod.Work:
        if self._work is None:
            self._work = self._work_fn()
        return self._work

    def breakdown(self) -> Dict[str, list]:
        by_op: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            by_op[n[:120]] += (e - s) * 1e-6
        by_host: Dict[str, float] = defaultdict(float)
        for s, e in self._gaps:
            by_host[self._host_at(s)] += (e - s) * 1e-6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [list(kv) for kv in top], "idle_gaps": [list(kv) for kv in gaps]}

    def _host_at(self, t: float) -> str:
        inner: Optional[Tuple[str, float]] = None
        for n, s, e in self.host.get(int(t // 1000), ()):
            if s <= t < e and (inner is None or e - s < inner[1]):
                inner = (n, e - s)
        return inner[0][:120] if inner else "host: between traced calls"


def load_reader(root: Path, name: str):
    """The `read` function of benchmark/metrics/<name>.py."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(root: Path, metrics, reading: TraceReading) -> Dict[str, dict]:
    """Each per-layer metric's value; a reader that finds nothing to read
    returns None and its metric is left out."""
    out = {}
    for m in metrics:
        value = load_reader(root, m["name"])(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
