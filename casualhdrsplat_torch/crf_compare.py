"""Kernel T1 (ops/crf_fused.py) of two trees of the port, in turns on one
card: its times at the main path's shapes and the instruction mix of its
built kernels.

    python -m casualhdrsplat_torch.crf_compare --parent DIR [--out FILE]

DIR is another checkout of the repository (`git archive <commit>` unpacked
into a git-ignored directory such as `_checkout/`).  One worker process
per turn, in the order parent, this tree, this tree, parent, each
importing its own tree's package, times T1's forward on a packed frame
(8 x 800^2 pixels), on bench.py's frame (4 x 800^2) and on one 800x800
view, and its backward on the frame and on bench's frame, with CUDA events,
hidden 32, after checking both against the plain versions (forward atol
1e-5, backward within 1e-4 of each group's largest + rtol 1e-3; where
that fails, again with the upstream gradient zeroed at the clip's ties,
`clip_ties`, as chip_smoke.py checks it).  The
inputs are the same in every turn: `crf.create`'s parameters made on the
CPU from seed 0, exposed radiance and upstream gradients drawn on the card
from seed 1.  Then the SASS of each tree's kernels (cuobjdump; a Triton
kernel's cubin from the turn's TRITON_CACHE_DIR) gives the instructions
per element of each kernel's hot loop and the least time the MUFU pipes
and the issue slots need for a frame (utils/sass.py).  Prints one JSON
object, and writes it to FILE when given.  Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve()
SHAPES = {"frame": 8 * 800 * 800, "bench": 4 * 800 * 800, "pose": 800 * 800}
BACKWARD = ("frame", "bench")
HIDDEN = 32
REPS = 20


def cuda_passes(hp: int) -> dict:
    """(elements one thread's pass of the hot loop serves, trips of the
    loops nested in it) of this tree's CUDA kernels at hp padded units, by
    the kernel's name in its SASS: forward 2 pixels x 3 channels a pass,
    its units in fours, two a loop pass; backward `_bwd_lanes` lanes an
    element."""
    from casualhdrsplat_torch.ops import crf_fused

    return {f"crf_mlp_fwd_kernelILi{hp}E": (6, hp // 8 if hp > 8 else 2),
            f"crf_mlp_bwd_kernelILi{hp}E": (1 / crf_fused._bwd_lanes(hp), 1)}


def _passes() -> dict:
    """cuda_passes at HIDDEN units, and the same for the Triton kernels of
    the tree before them: 64 pixels of a channel over 128 threads forward,
    32 a pass backward."""
    return {**cuda_passes(HIDDEN), "_crf_fwd": (64 / 128, 1), "_crf_bwd": (32 / 128, 1)}


# how near the clip's bounds, in float64, an output before the clip lies
# where two float32 evaluations may take either side of it
CLIP_TIE = 1e-6


def clip_ties(x, k, c, w, g, bias, log_min: float, span: float):
    """Elements [B, 3] of x whose output before the clip, evaluated in
    float64, lies within CLIP_TIE of 0 or 1.  There the clip's subgradient
    switches (1 inside, 0.5 at the bound, 0 outside), so a float32 kernel
    and a float32 plain version may each take either side: their d x at
    such an element may differ by its whole value."""
    import torch

    ties = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    kd, cd, wd = (p.double()[:, None, :] for p in (k, c, w))
    for lo in range(0, x.shape[0], 1 << 19):
        xs = x[lo:lo + (1 << 19)].double()
        u = ((torch.log(torch.clamp(xs, min=0.0) + 1e-8) - log_min) / span).T  # [3, b]
        y = (wd * torch.sigmoid(kd * (u[:, :, None] - cd))).sum(-1)
        o = torch.sigmoid(y + g.double()[:, None] * u + bias.double()[:, None]) * 1.004 - 0.002
        ties[lo:lo + (1 << 19)] = ((o.abs() <= CLIP_TIE) | ((o - 1.0).abs() <= CLIP_TIE)).T
    return ties


def backward_outliers(got, want, atol_rel=1e-4, rtol=1e-3) -> dict:
    """Per gradient group, the elements of `got` outside atol_rel x the
    group's largest + rtol of `want`, and the largest error over that
    largest."""
    out = {}
    for name, a, r in zip(("x", "k", "c", "w", "g", "bias"), got, want):
        scale = float(r.abs().max()) if r.numel() else 0.0
        diff = (a.reshape(r.shape) - r).abs()
        out[name] = (int((diff > atol_rel * scale + rtol * r.abs()).sum()),
                     float(diff.max()) / max(scale, 1e-30) if r.numel() else 0.0)
    return out


def _worker(root: str) -> dict:
    sys.path[0] = root
    import torch
    import torch.nn.functional as F

    from casualhdrsplat_torch import config
    from casualhdrsplat_torch.models import crf
    from casualhdrsplat_torch.ops import crf_fused

    dev = torch.device("cuda", 0)
    cfg = config.CRFConfig(hidden=HIDDEN)
    raw = crf.create(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = [p.to(dev).contiguous() for p in (
        F.softplus(raw["unit_k"]) * 20.0, raw["unit_c"], F.softplus(raw["unit_w"]),
        F.softplus(raw["gain"]), raw["bias"])]
    log_min, span = cfg.log_min, cfg.log_max - cfg.log_min
    gen = torch.Generator(device=dev).manual_seed(1)
    n = max(SHAPES.values())
    # radiance over the log range and a stop past it each side; a tenth 0
    x_all = torch.exp(torch.rand((n, 3), device=dev, generator=gen) * (span + 2) + log_min - 1)
    x_all[torch.rand((n, 3), device=dev, generator=gen) < 0.1] = 0.0
    go_all = torch.randn((n, 3), device=dev, generator=gen) * 1e-3

    def event_ms(fn):
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPS

    times, errors = {}, {}
    with torch.no_grad():
        for label, pixels in SHAPES.items():
            x, go = x_all[:pixels].contiguous(), go_all[:pixels].contiguous()
            out = crf_fused._forward_cuda(x, *params, log_min, span)
            ref = crf_fused.monotone_crf_reference(x, *params, log_min, log_min + span)
            errors[f"{label}_forward"] = err = float((out - ref).abs().max())
            if not err <= 1e-5:
                raise AssertionError(f"{root}: forward[{label}] max abs err {err}")
            times[f"{label}_forward_ms"] = event_ms(
                lambda: crf_fused._forward_cuda(x, *params, log_min, span))
            if label not in BACKWARD:
                continue
            worst, ties = backward_check(crf_fused, x, go, params, log_min, span)
            if worst is None:
                raise AssertionError(f"{root}: backward[{label}] disagrees")
            errors[f"{label}_backward_rel"], errors[f"{label}_clip_ties"] = worst, ties
            if ties:
                errors[f"{label}_tie_witness"] = tie_witness(crf_fused, x, go, params,
                                                             log_min, span)
            times[f"{label}_backward_ms"] = event_ms(
                lambda: crf_fused._backward_cuda(x, go, *params, log_min, span))
    binaries = [str(k.library_path) for k in (crf_fused.FWD_KERNEL, crf_fused.BWD_KERNEL)
                if getattr(k, "library_path", None)]
    return {"root": root, "times": times, "errors": errors, "binaries": binaries,
            "device": torch.cuda.get_device_name(0)}


def backward_check(crf_fused, x, go, params, log_min, span):
    """T1's backward against its plain version, every group within 1e-4 of
    its largest + rtol 1e-3; where that fails, again with the upstream
    gradient zeroed at the clip's ties (`clip_ties`), whose elements alone
    may differ.  (largest error over the group's largest, or None where
    the second comparison fails too; the ties zeroed, or 0.)"""
    def compare(g):
        got = crf_fused._backward_cuda(x, g, *params, log_min, span)
        want = crf_fused.monotone_crf_backward_reference(x, g, *params, log_min,
                                                         log_min + span)
        return backward_outliers(got, want)

    res = compare(go)
    if not any(n for n, _ in res.values()):
        return max(e for _, e in res.values()), 0
    ties = clip_ties(x, *params, log_min, span)
    res = compare(go * ~ties)
    ok = not any(n for n, _ in res.values())
    return (max(e for _, e in res.values()) if ok else None), int(ties.sum())


def tie_witness(crf_fused, x, go, params, log_min, span, limit=4):
    """Where kernel and plain version disagree on d x beyond the backward
    tolerance: (pixel, channel, kernel, plain float32, plain float64) for
    up to `limit` elements, the float64 one the closed form on that pixel
    alone with float64 inputs."""
    import torch

    got = crf_fused._backward_cuda(x, go, *params, log_min, span)[0]
    want = crf_fused.monotone_crf_backward_reference(x, go, *params, log_min,
                                                     log_min + span)[0]
    bad = ((got - want).abs() > 1e-4 * want.abs().max() + 1e-3 * want.abs()).nonzero()
    out = []
    for p, ch in bad[:limit].tolist():
        exact = crf_fused.monotone_crf_backward_reference(
            x[p:p + 1].double(), go[p:p + 1].double(), *(t.double() for t in params),
            log_min, log_min + span)[0]
        out.append((p, ch, float(got[p, ch]), float(want[p, ch]), float(exact[0, ch])))
    return out


def _turn(root: Path, cache: str) -> dict:
    env = dict(os.environ, TRITON_CACHE_DIR=cache, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, str(HERE), "--worker", str(root)], cwd=root,
                          env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {root} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _mixes(binaries, sms: int, clock_hz: float) -> dict:
    """Per element instruction mix and floors of each T1 kernel found."""
    from casualhdrsplat_torch.utils import sass

    out = {}
    for path in binaries:
        for name, instrs in sass.functions(path).items():
            for key, (per_pass, trips) in _passes().items():
                if key in name:
                    mix = sass.element_mix(instrs, per_pass, trips)
                    out[key] = dict(per_element=mix,
                                    per_element_unit={k: v / HIDDEN for k, v in mix.items()},
                                    **sass.floors_ms(mix, 3 * SHAPES["frame"], sms, clock_hz))
    return out


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
        print("crf_compare: no CUDA device; T1 runs only on the card", file=sys.stderr)
        return 2
    if not args.parent:
        ap.error("--parent is required")
    this, parent = HERE.parents[1], Path(args.parent).resolve()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    clock_hz = float(smi.strip().split(",")[-1].split()[0]) * 1e6
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, root) in enumerate((("parent", parent), ("this", this), ("this", this),
                                           ("parent", parent))):
            cache = os.path.join(tmp, f"triton-{i}")
            turn = _turn(root, cache)
            turn["tree"] = label
            turn["binaries"] += [str(p) for p in Path(cache).rglob("*.cubin")]
            turns.append(turn)
            print(f"turn {i} ({label}): {json.dumps(turn['times'])}", flush=True)
        mixes = {label: _mixes(next(t["binaries"] for t in turns if t["tree"] == label), sms,
                               clock_hz) for label in ("parent", "this")}
    times = {label: {k: [t["times"][k] for t in turns if t["tree"] == label]
                     for k in turns[0]["times"]} for label in ("parent", "this")}
    result = {"card": smi.strip(), "sms": sms, "clock_hz": clock_hz, "times_ms": times,
              "errors": {t["tree"]: t["errors"] for t in turns}, "sass": mixes}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
