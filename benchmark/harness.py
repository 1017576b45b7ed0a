"""The benchmark's driver: finds a cell's configuration, traffic mix,
limits and metrics by the names BENCHMARK.json gives, runs the cell once
and prints the result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell `w` of BENCHMARK.json names its configuration (a `configs` entry,
whose `file` is benchmark/configs/<config>.json) and its traffic mix
(benchmark/traffic/<traffic>.json, whose `kind` names the loop that
drives it, the class `Loop` of benchmark/kinds/<kind>.py); its limits are benchmark/limits/<w>.json; each
per-layer metric `m` it reports is read by benchmark/metrics/<m>.py.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import List, NamedTuple

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that the run's process must not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "casualhdrsplat_tpu")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]  # metric specs this cell reports with --trace 0
    per_layer: List[dict]  # and with --trace 1


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(spec: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell `workload` with everything it reads, found by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "benchmark" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(root / "benchmark" / "limits" / f"{workload}.json") as f:
        limits = json.load(f)
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, workload) and m["moves"] in names]
    return Cell(workload, w["chips"], config, traffic, limits, e2e, per_layer)


def forbidden_modules() -> List[str]:
    """The forbidden packages loaded in this process, by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             process_start: float, root: Path = ROOT, log=print) -> dict:
    """Set up, run the window (or the traced slice), compare with the
    reference: the result line's fields, and the readings."""
    import torch

    from benchmark import compare, loops, tracing

    loop = loops.load_kind(cell.traffic["kind"], root)(cell, seed, device)
    loop.setup()
    setup_s = time.time() - process_start
    result = {"attempted": 0, "failed": 0}
    if trace:
        sl = loop.traced_slice(lambda: tracing.profile(device))
        # the program's peak, before the readers count the slice's work on the card
        peak = loops.peak_bytes(device)
        reading = tracing.TraceReading(sl["kind"], sl["units"], sl["trace"], sl["work"],
                                       loop.model)
        metrics = tracing.read_metrics(root, cell.per_layer, reading)
        extra = {"busy_s": reading.busy_s, "window_s": reading.window_s}
        result["breakdown"] = reading.breakdown()
        log(f"traced slice: {sl['units']} {sl['kind']} units, window {reading.window_s:.6f} s, "
            f"busy {reading.busy_s:.6f} s, work {reading._work}", file=sys.stderr)
    else:
        e2e = loop.window(seconds)
        peak = loops.peak_bytes(device)
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        extra = {}
        log(f"window: {e2e}", file=sys.stderr)
    result["attempted"] = getattr(loop, "attempted", 0)
    result["failed"] = getattr(loop, "failed", 0)
    log(f"counters: {loop.counters_line()} {loop.counters}; set-up phases (s): {loop.phases}",
        file=sys.stderr)
    loop.release()
    t0 = time.perf_counter()
    readings = loop.readings()
    log(f"reference: {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    correct, checks = compare.judge(readings, cell.limits)
    log(f"readings: {readings}", file=sys.stderr)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    result.update(
        correct=bool(correct and result["failed"] == 0), metrics=metrics,
        device={"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
                "count": cell.chips, "memory_peak_bytes": peak, **extra},
        checks={k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()})
    return result


def main(argv, process_start: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        cell = resolve(load_spec(), args.workload)
    except (KeyError, OSError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import casualhdrsplat_torch  # noqa: F401 (the system under test)
    except ImportError as e:
        print(f"benchmark: the system under test is missing: {e}", file=sys.stderr)
        return 4
    print(f"card: {card_line()}", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      process_start)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {found}", file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    checks = result.pop("checks")
    line = {k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = {k: [v["value"], v["limit"]] for k, v in checks.items()}
    print(json.dumps(line, allow_nan=True))
    return 0 if all(math.isfinite(v["value"]) for v in line["metrics"].values()) else 6
