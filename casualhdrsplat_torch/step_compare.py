"""The packed training step and bench's step of two trees of the port, in
turns on one card: card busy time, wall and largest kernels of each, and
bench's Mpix/s.

    python -m casualhdrsplat_torch.step_compare --parent DIR [--out FILE]

DIR is another checkout of the repository (`git archive <commit>` unpacked
into a git-ignored directory such as `_checkout/`).  One worker process per
turn, in the order parent, this tree, this tree, parent, each importing its
own tree's package:
- the packed training step of chip_smoke.py at ladder4's full width
  (131,072 Gaussians, SH 3, 8 virtual views of 800x800, shared binning,
  density control off) on the synthetic video chip_smoke.py trains on (4
  frames, made on the card from seed 0), replayed as a CUDA graph
  (`Trainer.run_step`: warm-up, capture, one replay), then WINDOW replays
  under torch.profiler;
- bench's step (`bench.build()`'s defaults: 100,000 Gaussians, 4 views,
  16x16 tiles), replayed likewise;
- `bench.main`: Mpix/s, the median of its 3 windows of 12 graphed steps,
  and their spread.
For each profiled window: the host wall and the card's busy time (the sum
of the kernels' device time) per step, launches per step and the largest
kernels by device time.  Prints one JSON object, and writes it to FILE when
given.  Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
WINDOW = 5  # replays profiled per window
TOP = 12  # kernels listed per window


def _profile(fn) -> dict:
    """WINDOW calls of fn() under torch.profiler: wall and busy ms per call,
    launches per call, the TOP largest kernels (ms per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(WINDOW):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / WINDOW * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / WINDOW
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP]
    return {"wall_ms": wall, "busy_ms": busy,
            "launches": sum(e.count for e in kernels) // WINDOW,
            "largest": [[e.key[:160], e.self_device_time_total / 1e3 / WINDOW,
                         e.count // WINDOW] for e in top]}


def _worker(root: str) -> dict:
    sys.path[0] = root
    import torch

    from casualhdrsplat_torch import bench, config
    from casualhdrsplat_torch.data import dataset as dataset_mod
    from casualhdrsplat_torch.train.trainer import Trainer

    dev = torch.device("cuda", 0)
    cfg = config.PRESETS["ladder4"]()
    cfg.densify.enabled = False
    cfg.eval_every = 0
    cfg.data.eval_every = 0
    m = cfg.model
    dataset = dataset_mod.make_synthetic_dataset(
        seed=0, device=dev, renderer="fast", n_gaussians=m.max_gaussians, n_frames=4,
        n_virtual=m.num_virtual_views, size=800, scale_range=(0.004, 0.02), angle_span=0.12,
        exposure_range=(0.4, 0.8))
    trainer = Trainer(cfg, dataset, device=dev)
    for _ in range(3):  # warm-up, capture, a replay
        trainer.run_step()
    out = {"packed_step": _profile(trainer.run_step)}
    del trainer, dataset
    torch.cuda.empty_cache()

    step, args, _ = bench.build(device=dev)
    for _ in range(3):
        step(*args)
    out["bench_step"] = _profile(lambda: step(*args))
    del step, args
    torch.cuda.empty_cache()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        bench.main(["--device", "cuda"])
    out["bench"] = json.loads(text.getvalue().strip().splitlines()[-1])
    return out


def _turn(root: Path) -> dict:
    proc = subprocess.run([sys.executable, str(HERE), "--worker", str(root)], cwd=root,
                          env=dict(os.environ, PYTHONPATH=str(root)),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {root} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout of the repository")
    ap.add_argument("--out", help="also write the JSON object to this file")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker(args.worker)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("step_compare: no CUDA device; the steps run only on the card", file=sys.stderr)
        return 2
    if not args.parent:
        ap.error("--parent is required")
    this, parent = HERE.parents[1], Path(args.parent).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    turns = []
    for i, (label, root) in enumerate((("parent", parent), ("this", this), ("this", this),
                                       ("parent", parent))):
        turn = _turn(root)
        turn["tree"] = label
        turns.append(turn)
        print(f"turn {i} ({label}): packed step busy {turn['packed_step']['busy_ms']:.3f} ms, "
              f"bench step busy {turn['bench_step']['busy_ms']:.3f} ms, bench "
              f"{turn['bench']['value']} Mpix/s (spread {turn['bench']['spread_pct']}%)",
              flush=True)
    summary = {label: {
        "packed_step_busy_ms": [t["packed_step"]["busy_ms"] for t in turns if t["tree"] == label],
        "packed_step_wall_ms": [t["packed_step"]["wall_ms"] for t in turns if t["tree"] == label],
        "bench_step_busy_ms": [t["bench_step"]["busy_ms"] for t in turns if t["tree"] == label],
        "bench_step_wall_ms": [t["bench_step"]["wall_ms"] for t in turns if t["tree"] == label],
        "bench_mpix_s": [t["bench"]["value"] for t in turns if t["tree"] == label],
        "bench_spread_pct": [t["bench"]["spread_pct"] for t in turns if t["tree"] == label],
    } for label in ("parent", "this")}
    result = {"card": smi, "window": WINDOW, "summary": summary, "turns": turns}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
