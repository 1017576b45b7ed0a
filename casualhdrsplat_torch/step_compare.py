"""The packed training step and bench's step of two trees of the port, in
turns on one card: card busy time, wall and largest kernels of each, and
bench's Mpix/s.

    python -m casualhdrsplat_torch.step_compare --parent DIR [--out FILE]
        [--g1-inputs DIR [--g1-only]] [--memory]

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
  and their spread;
- with --g1-inputs (the inputs `python3 chip_smoke.py --g1-inputs DIR`
  saved: G1's calls on the packed training step, bench's step, an aligner
  step and rank 1's sharded step), first G1 on each of them, timed with
  CUDA events around a CUDA graph of G1_REPS calls (`graph_ms`: the
  device time a graphed step pays): its index alone (`slot_index`, or the
  parent's `inverse_index`), the kernel alone on that index, and the
  backward as the path runs it (also eagerly, host launches included),
  the index's kernels by device time (torch.profiler), with a digest of
  its output's bits (equal across the trees: both add each row's slots in
  slot order).  --g1-only skips the steps and bench;
- with --memory, instead of the steps and bench: the packed trainer with
  frames 0 and 2 of the 4 held out and a density-control round every
  second step, on one device and then on a (1, 1) mesh over an NCCL world
  of one.  Each runs MEMORY_ROUNDS rounds' steps (the step's and the
  round's warm-ups, captures and replays, where the tree graphs them), on
  the mesh then the rebalance MEMORY_ROUNDS times, then `evaluate()`
  three times (its warm-ups and captures) and MEMORY_EVALS more, timed.
  After the steps and again after the evaluations: the peak and current
  device memory, both allocated (live tensors) and reserved (the caching
  allocator's segments, the graphs' private pools included); the
  evaluations' host-clock walls and their metrics.
For each profiled window: the host wall and the card's busy time (the sum
of the kernels' device time) per step, launches per step and the largest
kernels by device time.  Prints one JSON object, and writes it to FILE when
given.  Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
WINDOW = 5  # replays profiled per window
TOP = 12  # kernels listed per window
G1_REPS = 20  # launches a G1 time averages over
MEMORY_EVALS = 5  # timed evaluations of the --memory turn
MEMORY_ROUNDS = 3  # density-control rounds of the --memory turn: warm-up, capture, replay


def _event_ms(fn, reps: int = G1_REPS) -> float:
    """Mean device time of fn() in ms, by CUDA events around `reps` calls
    after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = G1_REPS) -> float:
    """Device time of fn() in ms as a CUDA graph replays it: `reps` calls
    captured in one graph (after a warm-up call on a side stream), one
    replay under CUDA events, per call.  No host launch cost is in it, as
    none is in a graphed step."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def _g1_turn(inputs: Path) -> dict:
    """G1 on each saved input: index, kernel and backward ms in a CUDA
    graph, the backward's eager ms, the index's kernels, the output's
    digest."""
    import torch

    from casualhdrsplat_torch.ops import stream_gather as sg

    index_fn = getattr(sg, "slot_index", sg.inverse_index)
    out = {}
    for path in sorted(inputs.glob("*.pt")):
        grad, ids, rows = torch.load(path, map_location="cuda")
        shared = ids.dim() == 1
        offsets, slots = index_fn(ids, rows)
        out[path.stem] = {
            "index": index_fn.__name__,
            "index_ms": graph_ms(lambda: index_fn(ids, rows)),
            "kernel_ms": graph_ms(lambda: sg._launch(grad, offsets, slots, rows, shared)),
            "ms": graph_ms(lambda: sg._backward_cuda(grad, ids, rows)),
            "eager_ms": _event_ms(lambda: sg._backward_cuda(grad, ids, rows)),
            "index_kernels": _profile(lambda: index_fn(ids, rows))["largest"],
            "digest": _digest(sg._backward_cuda(grad, ids, rows))}
        del grad, ids, offsets, slots
        torch.cuda.empty_cache()
    return out


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


def _synthetic_video():
    """chip_smoke.py's synthetic video at ladder4's full width: 4 frames
    of 800x800."""
    import torch

    from casualhdrsplat_torch import config
    from casualhdrsplat_torch.data import dataset as dataset_mod

    m = config.PRESETS["ladder4"]().model
    return dataset_mod.make_synthetic_dataset(
        seed=0, device=torch.device("cuda", 0), renderer="fast", n_gaussians=m.max_gaussians,
        n_frames=4, n_virtual=m.num_virtual_views, size=800, scale_range=(0.004, 0.02),
        angle_span=0.12, exposure_range=(0.4, 0.8))


def _packed_trainer(eval_every: int, dataset=None, rounds_every: int = 0, mesh=None):
    """The packed trainer of chip_smoke.py at ladder4's full width on its
    synthetic video, frames `eval_every` apart held out (0: none), a
    density-control round every `rounds_every` steps (0: none)."""
    import torch

    from casualhdrsplat_torch import config
    from casualhdrsplat_torch.train.trainer import Trainer

    cfg = config.PRESETS["ladder4"]()
    cfg.densify.enabled = rounds_every > 0
    cfg.densify.start_iter = cfg.densify.interval = max(rounds_every, 1)
    cfg.eval_every = 0
    cfg.data.eval_every = eval_every
    return Trainer(cfg, _synthetic_video() if dataset is None else dataset,
                   device=torch.device("cuda", 0), mesh=mesh)


def _memory(stage: str) -> dict:
    """The device memory now and at its peak since the last reset, GiB."""
    import torch

    torch.cuda.synchronize()
    return {f"{stage}_peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            f"{stage}_peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
            f"{stage}_allocated_gib": torch.cuda.memory_allocated() / 2**30,
            f"{stage}_reserved_gib": torch.cuda.memory_reserved() / 2**30}


def _memory_window(trainer, rebalances: int) -> dict:
    """Memory after the steps with their rounds (and `rebalances`
    rebalances), then after the evaluations; the evaluations' walls."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(MEMORY_ROUNDS * trainer.cfg.densify.interval + 1):
        trainer.run_step()
    for _ in range(rebalances):
        trainer._rebalance()
    out = _memory("steps")
    for _ in range(3):
        metrics = trainer.evaluate()
    walls = []
    for _ in range(MEMORY_EVALS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.evaluate()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out.update(_memory("evaluate"))
    out.update(evaluate_ms=walls, evaluate_median_ms=sorted(walls)[len(walls) // 2],
               frames=len(trainer.dataset.eval_indices), metrics=metrics)
    return out


def _memory_turn() -> dict:
    """Device memory of the packed trainer's steps, density-control rounds
    and `evaluate`, on one device and on a (1, 1) mesh (see the module's
    docstring)."""
    import gc
    import tempfile

    import torch
    import torch.distributed as dist

    from casualhdrsplat_torch.parallel.mesh import Mesh

    dataset = _synthetic_video()
    out = {"one_device": _memory_window(_packed_trainer(2, dataset, rounds_every=2), 0)}
    gc.collect()  # the trainer's graphs and their pools
    torch.cuda.empty_cache()
    out["mesh_baseline"] = _memory("before")
    with tempfile.TemporaryDirectory(prefix="chs-memory-") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1,
                                rank=0)
        try:
            trainer = _packed_trainer(2, dataset, rounds_every=2, mesh=Mesh(1, 1))
            out["mesh"] = _memory_window(trainer, MEMORY_ROUNDS)
            del trainer
            gc.collect()
        finally:
            dist.destroy_process_group()
    return out


def _worker(root: str, g1_inputs: str | None, g1_only: bool, memory: bool) -> dict:
    sys.path[0] = root
    import torch

    out = {}
    if g1_inputs:
        out["g1"] = _g1_turn(Path(g1_inputs))
    if memory:
        out["memory"] = _memory_turn()
    if g1_only or memory:
        return out

    from casualhdrsplat_torch import bench

    dev = torch.device("cuda", 0)
    trainer = _packed_trainer(eval_every=0)
    for _ in range(3):  # warm-up, capture, a replay
        trainer.run_step()
    out["packed_step"] = _profile(trainer.run_step)
    del trainer
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


def _turn(root: Path, g1_inputs, g1_only: bool, memory: bool) -> dict:
    extra = (["--g1-inputs", str(g1_inputs)] if g1_inputs else []) + (
        ["--g1-only"] if g1_only else []) + (["--memory"] if memory else [])
    proc = subprocess.run([sys.executable, str(HERE), "--worker", str(root), *extra], cwd=root,
                          env=dict(os.environ, PYTHONPATH=str(root)),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {root} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout of the repository")
    ap.add_argument("--out", help="also write the JSON object to this file")
    ap.add_argument("--g1-inputs", help="G1's inputs saved by chip_smoke.py --g1-inputs")
    ap.add_argument("--g1-only", action="store_true", help="time G1 alone: no steps, no bench")
    ap.add_argument("--memory", action="store_true",
                    help="device memory of the packed step, its density-control rounds and "
                         "evaluate, and evaluate's walls, instead of the steps and bench")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker(args.worker, args.g1_inputs, args.g1_only, args.memory)),
              flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("step_compare: no CUDA device; the steps run only on the card", file=sys.stderr)
        return 2
    if not args.parent:
        ap.error("--parent is required")
    if args.g1_only and not args.g1_inputs:
        ap.error("--g1-only needs --g1-inputs")
    g1_inputs = Path(args.g1_inputs).resolve() if args.g1_inputs else None
    this, parent = HERE.parents[1], Path(args.parent).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    turns = []
    for i, (label, root) in enumerate((("parent", parent), ("this", this), ("this", this),
                                       ("parent", parent))):
        turn = _turn(root, g1_inputs, args.g1_only, args.memory)
        turn["tree"] = label
        turns.append(turn)
        parts = []
        if "g1" in turn:
            parts.append("G1 ms " + json.dumps({c: r["ms"] for c, r in turn["g1"].items()}))
        for part in ("one_device", "mesh") if "memory" in turn else ():
            mem = turn["memory"][part]
            parts.append(f"{part}: peak allocated / reserved "
                         f"{mem['steps_peak_allocated_gib']:.3f} / "
                         f"{mem['steps_peak_reserved_gib']:.3f} GiB after the steps and rounds, "
                         f"{mem['evaluate_peak_allocated_gib']:.3f} / "
                         f"{mem['evaluate_peak_reserved_gib']:.3f} GiB after evaluate, reserved "
                         f"then {mem['evaluate_reserved_gib']:.3f} GiB; evaluate median "
                         f"{mem['evaluate_median_ms']:.2f} ms")
        if "packed_step" in turn:
            parts.append(f"packed step busy {turn['packed_step']['busy_ms']:.3f} ms, bench step "
                         f"busy {turn['bench_step']['busy_ms']:.3f} ms, bench "
                         f"{turn['bench']['value']} Mpix/s (spread {turn['bench']['spread_pct']}%)")
        print(f"turn {i} ({label}): " + "; ".join(parts), flush=True)
    summary = {}
    for label in ("parent", "this"):
        mine = [t for t in turns if t["tree"] == label]
        summary[label] = {key: [t[name][field] for t in mine] for key, name, field in (
            ("packed_step_busy_ms", "packed_step", "busy_ms"),
            ("packed_step_wall_ms", "packed_step", "wall_ms"),
            ("bench_step_busy_ms", "bench_step", "busy_ms"),
            ("bench_step_wall_ms", "bench_step", "wall_ms"),
            ("bench_mpix_s", "bench", "value"),
            ("bench_spread_pct", "bench", "spread_pct")) if name in mine[0]}
        if "memory" in mine[0]:
            summary[label]["memory"] = {
                part: {k: [t["memory"][part][k] for t in mine] for k in mine[0]["memory"][part]
                       if k not in ("evaluate_ms", "metrics")}
                for part in ("one_device", "mesh")}
        if g1_inputs:
            summary[label]["g1"] = {
                case: {k: [t["g1"][case][k] for t in mine] for k in mine[0]["g1"][case]}
                for case in mine[0]["g1"]}
    if g1_inputs:
        summary["g1_bits_equal_across_trees"] = all(
            len({t["g1"][case]["digest"] for t in turns}) == 1 for case in turns[0]["g1"])
    result = {"card": smi, "window": WINDOW, "summary": summary, "turns": turns}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
