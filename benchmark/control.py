"""The readings the limits of `correct` are set from, on the card at a
cell's own size: for each seed the program's readings (against the
reference in float32), the control's (the reference in TF32 put in the
program's place) and, for a training cell, a planted fault's (the
reference blurring half of the virtual views).  The benchmark's own runs
do not run this.

    python benchmark/control.py --workload <name> --seeds 11,12,13 [--seconds 3] [--out f.jsonl]
    python benchmark/control.py --workload <serving cell> --seeds 11 --sweep 150,200,250

With --sweep, the serving cell's requests run as an open loop at each
rate in turn on the first seed's set-up (request i due i / rate seconds
after the start, its latency counted from when it was due): requests
completed, latency quantiles, and how late the generator ran in the first
and last tenth of the requests (a backlog that grows shows as the last
tenth running later).  The cells time a closed loop (PERF.md section 2
says why); the sweep is the evidence for that choice.

Seeds run in one process, one after another, each with its own inputs
and trainer; a serving cell runs a short window at its own load first,
so that the kept requests are the window's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    sys.path[0] = ROOT
    import torch

    from benchmark import harness, loops

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--control-seeds", type=int, default=None,
                   help="run the control and the fault on the first so many seeds only")
    p.add_argument("--fault", action="store_true",
                   help="training: also the planted fault (half of the views)")
    p.add_argument("--look", action="store_true",
                   help="training: where each Gaussian leaf's element-wise gap lies")
    p.add_argument("--sweep", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    cell = harness.resolve(harness.load_spec(), args.workload)
    device = torch.device("cuda", 0)
    if args.sweep:
        return sweep(cell, int(args.seeds.split(",")[0]), args, device)
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        loop = loops.load_kind(cell.traffic["kind"])(cell, seed, device)
        loop.setup()
        if cell.traffic["kind"] == "serve":
            loop.window(args.seconds)
        loop.release()
        reference = loop.reference()
        row = {"workload": args.workload, "seed": seed, "program": loop.readings(reference)}
        controlled = not args.no_control and (args.control_seeds is None
                                               or n < args.control_seeds)
        train = cell.traffic["kind"] == "train"
        if args.look and train:
            row["look_program"] = _look(loop.program["grads"], reference["grads"])
        if controlled and train:
            from benchmark import compare

            ctrl = loop.reference(tf32=True)
            row["control"] = compare.train_gaps(ctrl, reference)
            if args.look:
                row["look_control"] = _look(ctrl["grads"], reference["grads"])
            del ctrl
        elif controlled:
            row["control"] = loop.control_readings(reference)
        if controlled and train and args.fault:
            half = cell.config["config"]["model"]["num_virtual_views"] // 2
            row["fault_half_views"] = compare.train_gaps(loop.reference(views=half), reference)
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del loop, reference
        loops.free(device)
    return 0


def _look(program: dict, reference: dict) -> dict:
    from benchmark import compare

    return {k: compare.look(program[k], reference[k]) for k in compare.gaussian_leaves(reference)}


def sweep(cell, seed: int, args, device) -> int:
    import numpy as np

    from benchmark import loops

    loop = loops.load_kind("serve")(cell, seed, device)
    loop.setup()
    for rate in (float(r) for r in args.sweep.split(",")):
        lat, late = open_loop(loop, rate, args.seconds)
        tenth = max(len(late) // 10, 1)
        row = {"workload": args.workload, "rate_per_s": rate, "requests": len(lat),
               "p50_ms": float(np.percentile(lat, 50) * 1e3),
               "p95_ms": float(np.percentile(lat, 95) * 1e3),
               "late_ms_first_tenth": float(late[:tenth].mean() * 1e3),
               "late_ms_last_tenth": float(late[-tenth:].mean() * 1e3)}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


def open_loop(loop, rate: float, seconds: float):
    """The serving loop's requests, request i due i / rate seconds after the
    start: (latencies from when each was due, lateness of each start), in
    seconds."""
    import numpy as np

    latencies, lateness = [], []
    t0 = time.perf_counter()
    i = 0
    while i / rate < seconds:
        req = loop._request()
        due = t0 + i / rate
        while True:  # sleep, then spin, until the request is due
            left = due - time.perf_counter()
            if left <= 0:
                break
            if left > 1e-3:
                time.sleep(left - 5e-4)
        start = time.perf_counter()
        loop.render(*req)
        latencies.append(time.perf_counter() - due)
        lateness.append(start - due)
        i += 1
    return np.asarray(latencies), np.asarray(lateness)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
