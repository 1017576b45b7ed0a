#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (casualhdrsplat_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--g1-inputs DIR]

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every CUDA kernel of the port from csrc/ (one nvcc per source, all
   started together, sm_90a: B1-B4, both halves of kernel T1, the CRF
   MLP of ops/crf_fused.py, G1, the packed stream gather's transpose of
   ops/stream_gather.py, the counting pass that builds G1's index, and
   both halves of kernel P1, the projection of ops/projection_fused.py)
   and prints ptxas's register and spill lines;
   then T1's instruction mix per element from its SASS (cuobjdump) and the
   least time its MUFU pipes and issue slots need for a frame, and T1 at
   64 units against its plain versions.  Then crf.create at full width:
   its 1,200-step gamma pre-fit replayed as a CUDA graph against the same
   pre-fit run eagerly from the same start (seconds of both, the fitted
   parameters held together, T1 once each way a step).
3. Packed serving at the full width of the ladder4-full model
   (ModelConfig() defaults: 131,072 Gaussians, SH degree 3, 8 virtual
   views, MLP CRF with 32 units, 16x128 tiles, chunk 128, shared binning)
   on 800x800 images along an orbit: render_frame for 3 frames (the shared
   packed branch) and render_pose at 3 orbit angles in LDR and HDR (the
   per-view packed branch).  The weights are random, from a fixed seed.
   Checks the outputs (finite, shaped, in range) and that the forward
   kernel was launched on both branches (its count, zeroed just before),
   and P1's forward once a request, its backward never.
   The same requests then go through image_formation.GraphedRenders (the
   viewer's, the command line's and entry()'s path: one CUDA graph per
   mode, warm-up, capture, replays), each equal to the eager output to the
   bit, and the launches a replay counts are logged.
4. Dense serving of the same model with RasterizeConfig(packed=False,
   16x16 tiles, capacity 1024, chunk 128), whose kernels read the payload
   rows through the [tiles, capacity] id table: 2 render_frame and 2
   render_pose requests, outputs checked, one launch of the dense forward
   kernel per request, the capacity overflow and the peak memory logged;
   and, on a 16,384-Gaussian part of the model where neither path drops
   anything, the dense frame against the packed frame on the same tiles.
5. Packed training at the same width: a synthetic casual video (4 frames of
   800x800, 8 virtual views each, a random cloud of 131,072 Gaussians) made
   on the card, a Trainer on PRESETS["ladder4"] with density control off,
   one warm-up step and 5 timed steps, each run twice from the same state,
   as the captured CUDA graph (`run_step`) and eagerly (`run_step_eager`),
   every scalar and every tensor of the step held together (the
   card-vs-CPU step tolerance).  Checks that every scalar is finite,
   that every parameter group moved, that the density-control statistics
   rose and that the packed forward and backward kernels, G1 and both
   halves of P1 were each launched once per step, a replay included
   (counts zeroed just before the steps; P1's counted from where they
   stand).  Then two eager steps from one state: the largest
   difference of every gradient group and tensor of the step is logged.
6. Dense training on the same video: a Trainer on PRESETS["ladder4"] with
   the dense RasterizeConfig and density control on, its store built from
   98,304 of the cloud's points so that a round finds free slots; 3 warm-up
   steps through the SH warm-up, then 5 timed steps at SH degree 3 that
   cross one densify round and one opacity reset, graphed against eager
   as in 5 (the round's threshold put where both grant the same slots).
   Checks: the dense kernels launched once a step each, scalars finite,
   every group moved,
   the round cloned or split, `alive` rose by what it granted less what it
   pruned, the moments of the new slots are zero, the reset clamped every
   opacity.  Then the density-control window: from one state with the
   same draws (the split noise drawn on the host into a pinned buffer and
   copied to a static one), the round replayed as a CUDA graph against
   the same round run eagerly, every parameter, moment and statistic and
   the report's four counts equal to the bit; the host's ms for the draw;
   the round's
   step against its neighbours (the steps before and after it), graphed
   and eager, host-clock medians of 3; the round alone eager against
   graphed (walls and busy shares).
6b. ladder5-pod at its own size, 3,145,728 Gaussians on one card (its
   (4, 2) mesh cut to (1, 1)): a synthetic video of that many Gaussians,
   ladder4's recipe with the scales divided by 24^(1/3), and a Trainer on
   PRESETS["ladder5"] with density control off, whose start-up k-NN takes
   the host grid route (its seconds printed); one step replayed from the
   captured graph against `run_step_eager` from the same state, every
   scalar and tensor of the step equal to the bit, B1, B2, G1 and its
   index once each way (added to the kernels line); B1, B2 and G1 on the
   inputs a 3M step gives them against their plain versions, B1 and B2 on
   the last view's rows, whose slots lie past 2^31 floats of the stream,
   G1 on the whole [8, 6N, 16] gradient (the kernels line's "ladder5"
   entries); then the grid k-NN against the brute force on the card on
   262,144 of the cloud's points, within rtol 1e-5.
7. The sharded path (parallel/) on the same video, ladder4 with per-view
   binning: (a) a world of one (nccl, mesh (1, 1)) in this process, one
   step's gradients against the one-device trainer from the same state,
   then a warm-up and 5 steps of each, alternating: the one-device
   per-view trainer replays its graph, the mesh trainer its captured step
   (collectives included), each of its steps run again eagerly from the
   same state and held to the graphed one as in 5, the collectives' calls
   and bytes of a graphed step equal to an eager step's (host seconds not
   measured under a replay), B1, B2, G1 and its index once a step,
   replays included; the graphed, eager and one-device walls and an
   eager-and-graphed window; then the density-control window of 6 on the
   mesh (a quarter of its full store put below the opacity prune first),
   the rebalance graphed against eager from one state, and `evaluate()`
   graphed against eager (the store gathered inside the deblurred renders'
   graphs), each equal to the bit; (b) two gloo ranks sharing cuda:0 on the
   meshes (1, 2) and (2, 1), from 98,304 of the cloud's points: one
   render_frame and one step's gradients, packed and dense, against the
   one-device port on the card, a step (eager: gloo cannot be captured),
   and on the packed trainer a densify round and a rebalance (counts
   kept, spread not wider); the ranks report their launches and each
   collective's bytes and host time per step; (c) `bench --sharded 1,1`
   (its JSON line, graphed; B1, B2 and G1 once a step), its eager step by
   bench's own loop and window, and dryrun_multichip(2) on two gloo ranks.
   B1, B2 and G1 once a step on the packed branch; rank 1 holds B1-B4 and
   G1 to their plain versions.
8. The command line on the same video written as a COLMAP capture (text
   model, 8-bit PNG frames), in this process: `train --preset ladder4` for
   6 steps with checkpoints at 3 and 6 and an eval at 6; steps 4-6 again
   from step_3 in a fresh trainer, held to the uninterrupted run
   (RESUME_*); `train --resume` to step 8; `eval`; `render` in all six
   modes; `export`, read back equal to the checkpoint.  Then the viewer
   (10 /render.jpg requests) and both pose aligners (48 steps each, a
   known offset injected) on the trained scene, each graphed twice (the
   descent step captured once, then replays) and eagerly on the same
   inputs: ms a step each way, captures and replays, the loss curves,
   corrections and outputs held together.  B1 and B2 launch counts are
   checked for every command and aligner run (G1 once per B2), and B1, B2
   and G1 are held against their plain versions on one aligner step's
   inputs (render_pose's backward, the per-view branch).
9. Holds every kernel against its plain PyTorch version on the inputs the
   paths gave it (pixels at a threshold tie exempt, forward and backward;
   each backward run twice: equal bits, but for the dense list form, whose
   atomics add in an order that changes from run to run: its largest
   run-to-run difference is logged); G1 also against the PyTorch emulation
   of its schedule, to the bit, on the packed training step, bench's step,
   an aligner step (per-view ids) and rank 1's sharded step, and its
   counting index against the sort it replaced (every real row's list of
   slots; with --g1-inputs DIR those four inputs are saved there, for
   casualhdrsplat_torch.step_compare's G1 turns); and the
   slices on the card against the same on the CPU at a small size (the
   rendered frame; the gradients of one packed training step; a dense
   training step, a densify round and the step after it).
10. Times each kernel with CUDA events at the paths' shapes (G1 also beside
   the library call the port ran before, gather's scatter_add_ or
   index_add_, and its index alone, the counting pass and the sort it
   replaced), the packed ones
   also at the same frame on 16x16 tiles and at bench.py::build's shapes
   (16x16 tiles, 4 views, 100k Gaussians), beside its plain version and its
   bound; T1 against its plain versions (forward atol T1_ATOL, backward at
   the backward tolerance with the clip's ties exempt, two launches equal
   to the bit) on a frame's, a
   pose's and a training step's inputs; P1 against the chain it replaces
   (models/gaussians.py `project_chain`: the forward equal, the backward
   within P1_GRAD_RTOL of autograd's by relative norm, two launches equal
   to the bit) on a training step's 8 views and a served pose.  Prints the eager and the graphed
   walls and profiled busy shares of render_frame, render_pose, both
   training steps and bench's step, all from this run.
11. The at-spec quality run (casualhdrsplat_torch.quality_run, in this
   process): the reference's r05 fixture built on the card through
   build_fixture (the structured cloud of 30,000 surfels, 12 frames of
   800x800, 16 ground-truth views a frame, per-view binning at chunk 256,
   stream_factor 24, capacity 4096; nothing may drop), then QUALITY_STEPS
   steps with r05's knobs, the first QUALITY_COARSE of them at 400x400
   (mtpg 64), the rest at 800x800 (mtpg 256), per-view binning at
   stream_factor 12 over a 131,072-slot store, an eval every
   QUALITY_EVAL_EVERY steps, and the aligned final eval.  Checks: the
   report holds the reference's keys, every curve point is finite, the
   last eval of each rung beats its first in eval_psnr, and B1 and B2 were
   launched once per step; then both held against their plain versions on
   the last step's inputs.  G1 once per step as well.  Then the eval
   window on the run's last trainer: `evaluate()` (the 2 held-out frames:
   the blurred frame, the deblurred and the novel view, each with its
   metric vector, replayed as CUDA graphs) against its eager twin
   (`graphed=False`), the metrics equal to the bit, B1's and T1's launches
   and the host's reads of the card per evaluated frame either way (one
   read a frame, and the learned exposures once), walls (host-clock
   medians of 3, alternating) and busy shares.
12. bench (casualhdrsplat_torch.bench.main at build()'s defaults: 100k
   Gaussians, 800x800, 4 views, 16x16 tiles, chunk 128): its JSON line,
   B1, B2 and G1 once per step.
13. entry (casualhdrsplat_torch.entry.entry()): the blurred frame's shape
   and range, B1 launched once.
14. With --profile, prints the largest kernels of every profiled window
   (torch.profiler) and profiles the dense serving requests and the
   sharded steps too.
15. Prints a `{"kernels": [...]}` line (G1's index an entry of its own,
   its launches read from its own counter wherever G1's are counted above,
   and equal to them; G1's `ms` holds its index's, `kernel_ms` is the
   kernel alone; P1's forward and backward at a training step's inputs,
   their launches the main path's from the serving phase on) and, last,
   `{"ok": true, "device": {...}}`.

Any failed phase exits non-zero without the last line.  There is no CPU
fallback: without a CUDA device the script exits 2 at once.
"""

from __future__ import annotations

import concurrent.futures
import copy
import dataclasses
import functools
import gc
import json
import os
import sys
import tempfile
import time
import traceback
from types import SimpleNamespace

import numpy as np

SEED = 0
SIZE = 800
N_FRAMES = 4
EXPOSURE = 0.6
# Compositor agreement, kernel vs plain version (float32): the kernel
# carries T as a running product, the plain version as exp of a log-space
# prefix, so they differ by rounding (~1e-6); a tile whose max T sits
# within that rounding of eps at a window boundary may skip one window
# more or less, which moves a pixel by at most eps times its colour.
ATOL, RTOL = 1e-4, 1e-4
# The function itself jumps where a slot's alpha crosses alpha_threshold:
# at a pixel where alpha sits within float32 rounding of the threshold the
# two versions may take different sides, which switches one slot of
# alpha = threshold on or off there.  The plain version reports those
# pixels (CompositeWork.tie_pixels); only they are exempt from the
# tolerance above, and they stay within 2 x threshold x the largest colour.
# Peak rates of an H100 SXM (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# fp32 operations the compositor's function needs, charged only at the
# (slot, pixel) pairs a slot touches (alpha >= threshold, CompositeWork.
# touched): elsewhere alpha is 0, and an implementation may find that out
# without evaluating it (the packed kernels skip the pixels outside a
# slot's box), so the bound counts the same work whatever implements it.
# Its bytes, likewise, are the payload rows of the slots the function
# visits (CompositeWork.slots), not the padding of the buffer they lie in.
# The dense list form names a payload row from up to max_tiles_per_gaussian
# tiles: its bound reads each distinct row named once, and only the
# USED_ROW_BYTES of it that the function uses, plus each visited slot's id.
# Alpha: dx, dy, five products and three sums of the conic form, scale,
# min, exp, opacity product, clip, threshold select = 16.  The forward's
# blend: w = alpha T, four multiply-adds, T *= 1 - alpha = 10.
ALPHA_OPS = 16
BLEND_OPS = 10
# payload columns the compositors use: mx, my, cxx, cxy, cyy, opa, r, g, b,
# one (4 bytes each)
USED_ROW_BYTES = 40
# The backward's gradient: w (1); cg = c4 . g4 (7);
# r += w cg (2); 1 - alpha, tot - r, the division, T cg and their
# difference (5); the clip select and g_pw (2); the two mean gradients (5
# each); the three conic gradients (4, 3, 4); the opacity gradient (2);
# three colour gradients (6); T = T_k (1 - alpha) (1) = 47.
BWD_TOUCHED_OPS = 47
# Backward agreement, kernel vs plain version: atol BWD_ATOL_REL x the
# largest gradient + rtol.  A slot's nine sums over up to 2048 pixels are
# taken per thread, per warp and over warps in the kernel and in one sum in
# the plain version, and tot - r cancels toward the end of a segment; the
# skip vote's one-window slack (above) moves a slot by at most eps times
# its weight.  The card-vs-CPU gradient check uses the same tolerance:
# kernels and library calls sum in other orders than the CPU (G1, the
# gather's transpose, adds a row's slots in slot order as index_add_ does
# on a CPU, but B2 and the plain layers do not).  The gradient jumps at
# a threshold tie as the function does: the side a version takes there
# switches that pixel's term of a slot's sums on or off.  A pixel's terms
# are linear in its upstream gradient, so the kernel comparison leaves the
# tie pixels out by zeroing it there (measure_gradient), and nothing else.
BWD_ATOL_REL, BWD_RTOL = 1e-4, 1e-3
TRAIN_STEPS = 5
# The dense path at full width: the shape the reference's own benchmark and
# profiling scripts use (bench.py::build, scripts/profile_step.py).
DENSE_RASTER = dict(packed=False, tile_h=16, tile_w=16, tile_capacity=1024, chunk=128,
                    max_tiles_per_gaussian=32)
# Points the dense trainer's store starts from: the rest of the 131,072
# slots are free for the densify round's clones and splits.
DENSE_TRAIN_POINTS = 98_304
# The dense trainer's schedule, in steps: 3 warm-up steps raise the SH
# degree to 3, the 5 timed steps cross a densify round and an opacity reset.
DENSE_WARMUP_STEPS, DENSE_DENSIFY_STEP, DENSE_RESET_STEP = 3, 5, 7
# Average screen-space gradient above which a Gaussian asks for a slot.  A
# run's default (2e-4) is tuned for the gradients of a scene some thousand
# steps in; a handful of steps from the k-NN init they are smaller.
DENSE_GRAD_THRESHOLD = 1e-5
# The quality phase: steps, of which on the coarse rung, and an eval every
# so many steps (two a rung); the final alignment's Adam steps per frame.
QUALITY_STEPS, QUALITY_COARSE, QUALITY_EVAL_EVERY, QUALITY_ALIGN_STEPS = 100, 60, 20, 4
# The knobs of the reference's at-spec run r05 (QUALITY_r05.json, "fixture"),
# as quality_run flags; the steps and the curriculum's length are cut.
R05_FLAGS = ["--size", "800", "--gt-gaussians", "30000", "--frames", "12",
             "--capacity", "131072", "--virtual-views", "8", "--exposure-lo", "0.5",
             "--exposure-hi", "1.0", "--stream-factor", "12", "--fixture", "structured",
             "--shake-rot", "0.06", "--shake-trans", "0.03", "--knots-per-frame", "3",
             "--pose-warmup", "100", "--pose-trans-lr-scale", "1.0", "--exposure-lr", "0.005",
             "--exposure-init-frac", "0.75", "--crf-lr", "0.001", "--c2f-steps", "0",
             "--holdout-every", "6", "--coarse-downscale", "2", "--pose-anchor-w", "0.0",
             "--densify-start", "1600", "--pose-b1", "0.0"]
# The top-level keys of the reference's report (QUALITY_r05.json).
REPORT_KEYS = ("round", "run_label", "fixture", "scale", "wall_s", "exposure_recovery",
               "crf_recovery", "hdr_recovery", "pose_recovery", "psnr_curve", "final_eval",
               "deblurring_gain_db", "final_eval_aligned", "deblurring_gain_db_aligned")


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn):
    """(result, seconds) of fn() on the host clock, ending in a sync."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events around `reps` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def build_model(device):
    """The ladder4-full model on a random scene, as a serving process
    would hold it: (cfg, scene, params)."""
    import torch

    from casualhdrsplat_torch import config
    from casualhdrsplat_torch.data import synthetic
    from casualhdrsplat_torch.models import crf as crf_mod
    from casualhdrsplat_torch.models import image_formation as imf
    from casualhdrsplat_torch.ops import sh

    cfg = config.PRESETS["ladder4"]().model
    rng = np.random.default_rng(SEED)
    cloud = synthetic.random_cloud(rng, cfg.max_gaussians, scale_range=(0.004, 0.02),
                                   device=device)
    n = cloud.means3d.shape[0]
    k = sh.num_sh_bases(cfg.sh_degree)
    sh_rest = rng.normal(0.0, 0.05, size=(n, k - 1, 3)).astype(np.float32)
    gaussians = {
        "means": cloud.means3d,
        "quats": cloud.quats,
        "log_scales": torch.log(cloud.scales),
        "opacity_logit": torch.logit(cloud.opacities),
        "sh_dc": sh.rgb_to_sh_dc(cloud.colors)[:, None, :],
        "sh_rest": torch.as_tensor(sh_rest, device=device),
        "alive": torch.ones(n, dtype=torch.bool, device=device),
    }
    poses = synthetic.orbit_knots(N_FRAMES, angle_span=0.12, width=SIZE,
                                  img_height=SIZE, device=device)
    cam = synthetic.orbit_camera(0.0, width=SIZE, img_height=SIZE, device=device)
    dataset = SimpleNamespace(
        viewmats=poses.cpu().numpy(), timestamps=np.arange(N_FRAMES, dtype=np.float32),
        fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx), cy=float(cam.cy),
        width=SIZE, height=SIZE,
    )
    scene = imf.build_scene(dataset, cfg, device=device)
    params = {
        "gaussians": gaussians,
        "knot_deltas": torch.zeros((scene.base_knots.shape[0], 6), device=device),
        "log_exposures": torch.full((N_FRAMES,), float(np.log(EXPOSURE)), device=device),
        "crf": crf_mod.create(cfg.crf, torch.Generator().manual_seed(SEED), device=device),
    }
    return cfg, scene, params


def check_image(name, img, shape, lo=None, hi=None):
    import torch

    if tuple(img.shape) != shape:
        raise AssertionError(f"{name}: shape {tuple(img.shape)} != {shape}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{name}: non-finite values")
    if lo is not None and float(img.min()) < lo or hi is not None and float(img.max()) > hi:
        raise AssertionError(f"{name}: values outside [{lo}, {hi}]")


def capture_calls(module, name, fn, restore_counts=True):
    """Run fn() and return the arguments of every call it makes of
    `module.<name>` (which still runs), tensors detached.  fn() runs to
    capture a comparison's inputs: its kernel launches are put back out
    of the counts (unless `restore_counts` is False)."""
    from casualhdrsplat_torch.ops import cuda_build

    calls = []
    original = getattr(module, name)
    counts = [c.launches for c in cuda_build.COUNTERS]

    def recorder(*args, **kw):
        calls.append(tuple(a.detach() if hasattr(a, "detach") else a for a in args))
        return original(*args, **kw)

    setattr(module, name, recorder)
    try:
        fn()
    finally:
        setattr(module, name, original)
        if restore_counts:
            for c, n in zip(cuda_build.COUNTERS, counts):
                c.launches = n
    return calls


def grad_outliers(got, ref, scale):
    """(max abs error, elements of `got` outside the backward tolerance of
    `ref`), the tolerance's atol taken from `scale`, a largest gradient."""
    diff = (got - ref).abs()
    return float(diff.max()), int((diff > BWD_ATOL_REL * scale + BWD_RTOL * ref.abs()).sum())


def grads_close(name, got, ref):
    """Raise unless `got` agrees with `ref` at the backward tolerance;
    returns the max abs error."""
    scale = float(ref.abs().max())
    err, outliers = grad_outliers(got, ref, scale)
    if outliers:
        raise AssertionError(f"{name}: max abs err {err} against a largest value of {scale}")
    return err


def roofline(nbytes: int, ops: int):
    """(bound in ms, what bounds it) for this much traffic and arithmetic."""
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def measure_forward(label, kernel, plain, colour_max, threshold, nbytes, p, reps, **meta):
    """A forward kernel vs its plain version on one input: agreement, times,
    bound.  `kernel()` launches the kernel and returns its output;
    `plain(return_work)` runs the plain version (with a CompositeWork when
    asked); `nbytes(work)` is the traffic the function needs for this
    input; p the pixels of a tile.  Returns a dict of the numbers."""
    import torch

    out = kernel()
    ref, work = plain(True)
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    err = float(diff.max())
    off = diff > ATOL + RTOL * ref.abs()
    tie = work.tie_pixels[:, None, :]  # a tie pixel exempts its four channels
    ties, tie_outliers = int(work.tie_pixels.sum()), int((off & tie).sum())
    outliers = int((off & ~tie).sum())
    jump = 2.0 * threshold * max(1.0, colour_max)
    ok = outliers == 0 and err <= jump
    ms = event_ms(kernel, reps)
    plain_ms = event_ms(lambda: plain(False), max(2, reps // 10), warmup=1)
    traffic = nbytes(work)
    bound_ms, bound_by = roofline(traffic, (ALPHA_OPS + BLEND_OPS) * work.touched)
    res = dict(
        label=label, **meta, evaluated_slots=work.slots, touched_slot_pixels=work.touched,
        bound_bytes=traffic,
        touched_share=work.touched / max(1, work.slots * p),
        max_abs_err=err, tie_pixels=ties, outliers_at_ties=tie_outliers,
        outliers_elsewhere=outliers, allclose=ok,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
    )
    log(f"compositor[{label}]: " + json.dumps(res))
    if not ok:
        raise AssertionError(f"compositor[{label}]: kernel disagrees with its plain "
                             f"version at {outliers} elements away from a threshold "
                             f"tie, max abs err {err}")
    return res


def measure_gradient(label, kernel, plain, g4, work, nbytes, p, reps, deterministic=True,
                     **meta):
    """A backward kernel vs its plain version on one input: agreement (with
    `deterministic`, two launches must also give the same bits; without,
    their largest difference is logged), times, bound.  `kernel(g4)` and
    `plain(g4)` return the gradient for the upstream gradient g4 [rows, 4, P].

    Every pixel adds its own term to the gradient, linear in its g4.  So
    where the two disagree on the whole g4, they must agree once g4 is
    zeroed at the tie pixels (`work.tie_pixels`): only the terms of those
    pixels are exempt from the tolerance, as in the forward."""
    import torch

    d = kernel(g4)
    with torch.no_grad():
        ref, plain_s = timed(lambda: plain(g4))
    if not bool(torch.isfinite(d).all()):
        raise AssertionError(f"backward[{label}]: non-finite gradient")
    largest = float(ref.abs().max())
    err, outliers = grad_outliers(d, ref, largest)
    again = kernel(g4)
    run_to_run = float((d - again).abs().max())
    if deterministic and not torch.equal(d, again):
        raise AssertionError(f"backward[{label}]: two launches differ in their bits")
    del d, ref, again
    ties = int(work.tie_pixels.sum())
    err_off_ties, outliers_off_ties = err, outliers
    if outliers and ties:
        off_ties = g4 * ~work.tie_pixels[:, None, :]
        with torch.no_grad():
            err_off_ties, outliers_off_ties = grad_outliers(
                kernel(off_ties), plain(off_ties), largest)
        del off_ties
    ok = outliers_off_ties == 0
    ms = event_ms(lambda: kernel(g4), reps)
    bound_ms, bound_by = roofline(nbytes, (ALPHA_OPS + BWD_TOUCHED_OPS) * work.touched)
    res = dict(
        label=label, **meta, evaluated_slots=work.slots, touched_slot_pixels=work.touched,
        bound_bytes=nbytes,
        touched_share=work.touched / max(1, work.slots * p),
        max_abs_err=err, largest_gradient=largest, tie_pixels=ties, outliers=outliers,
        max_abs_err_off_ties=err_off_ties, outliers_off_ties=outliers_off_ties,
        allclose=ok, deterministic=deterministic, run_to_run_max_abs_diff=run_to_run,
        ms=ms, plain_ms=plain_s * 1e3, bound_ms=bound_ms, bound_by=bound_by,
    )
    log(f"backward[{label}]: " + json.dumps(res))
    if not ok:
        raise AssertionError(
            f"backward[{label}]: kernel disagrees with its plain version at "
            f"{outliers_off_ties} elements with the tie pixels left out, max abs err "
            f"{err_off_ties} against a largest value of {largest}")
    return res


# Kernel T1 (ops/crf_fused.py), held against its plain versions: forward
# atol T1_ATOL (exp2, rcp and the backward's log2 are the approximate
# hardware ones, a few ulp each; the forward shares a reciprocal among four
# units and the H units are summed in another order), the backward's
# groups at the backward tolerance above (the clip's ties exempt), two
# launches equal to the bit.  Its fp32 operations, for the bound: per
# (pixel, channel, unit) the forward evaluates u - c, k d, -z, exp, 1 +, the reciprocal, w s and
# the sum (8); per (pixel, channel) the clamp, + eps, log, - log_min, the
# division, g u +, + bias, the output sigmoid (4), the stretch (2) and the
# clip (2) = 16.  The backward recomputes the units (6), s (1 - s) (2),
# w s' (1), the three accumulations (2 + 3 + 3) and d y / d u (2) = 19 a
# unit, and per element the forward's 16 plus the two clamps' subgradients
# (6), t (4), the g and bias sums (3) and d x (5) = 34.  exp and the
# reciprocal run on the special-function units (MUFU), 16 results a clock
# per SM against 128 fp32 FMAs on compute capability 9.0, an eighth of the
# rate; the table's fp32 peak charges them as any fp32 operation, so each
# measurement also logs the MUFU and issue floors of the built kernel's
# instruction mix (T1_MIX, from its SASS).
T1_ATOL = 1e-5
T1_FWD_UNIT_OPS, T1_FWD_ELEM_OPS, T1_BWD_UNIT_OPS, T1_BWD_ELEM_OPS = 8, 16, 19, 34
# ("fwd" or "bwd", padded units) -> instructions per element by class, from
# the built kernels' SASS; and the card's SMs and top SM clock (Hz)
T1_MIX: dict = {}
CARD_RATE = {}


class uncounted:
    """Put every kernel's launch count back on leaving: the launches of a
    comparison or of a helper run are not the path's."""

    def __enter__(self):
        from casualhdrsplat_torch.ops import cuda_build

        self.counts = [(c, c.launches) for c in cuda_build.COUNTERS]

    def __exit__(self, *exc):
        for c, n in self.counts:
            c.launches = n


def measure_crf_forward(label, call, reps):
    """T1's forward against its plain version on one captured call of its
    launcher (x [B, 3], k, c, w, g, bias, log_min, span): agreement, times,
    bound.  The function reads x and writes the image, 12 bytes a pixel
    each way."""
    import torch

    from casualhdrsplat_torch.ops import crf_fused

    x, k, c, w, g, bias, log_min, span = call
    with uncounted(), torch.no_grad():
        out = crf_fused._forward_cuda(*call)
        ref = crf_fused.monotone_crf_reference(x, k, c, w, g, bias, log_min, log_min + span)
        err = float((out - ref).abs().max())
        ms = event_ms(lambda: crf_fused._forward_cuda(*call), reps)
        plain_ms = event_ms(lambda: crf_fused.monotone_crf_reference(
            x, k, c, w, g, bias, log_min, log_min + span), max(2, reps // 10), warmup=1)
    n, h = x.numel(), k.shape[1]
    bound_ms, bound_by = roofline(2 * n * 4 + 4 * (3 * k.numel() + 6),
                                  n * (T1_FWD_UNIT_OPS * h + T1_FWD_ELEM_OPS))
    res = dict(label=label, pixels=x.shape[0], hidden=h, max_abs_err=err, atol=T1_ATOL,
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               **t1_floors("fwd", h, n))
    log(f"crf_fused forward[{label}]: " + json.dumps(res))
    if not err <= T1_ATOL:
        raise AssertionError(f"crf_fused forward[{label}]: max abs err {err} > {T1_ATOL}")
    return res


def measure_crf_backward(label, call, reps):
    """T1's backward against its closed-form plain version on one captured
    call of its launcher (x, the upstream gradient, k, c, w, g, bias,
    log_min, span): every group at the backward tolerance, two launches
    equal to the bit, times, bound (x and the upstream gradient read, d x
    written, 12 bytes a pixel each).

    At an element whose output before the clip lies within float32
    rounding of 0 or 1 the clip's subgradient switches, and kernel and
    plain version may each take either side.  Every element adds its own term to the gradients, linear in
    its upstream gradient, so where the two disagree they must agree once
    the upstream gradient is zeroed at those elements
    (crf_compare.clip_ties): only the ties' terms are exempt, as the
    compositors' threshold ties are."""
    import torch

    from casualhdrsplat_torch.crf_compare import clip_ties
    from casualhdrsplat_torch.ops import crf_fused

    x, go, k, c, w, g, bias, log_min, span = call
    names = ("x", "k", "c", "w", "g", "bias")
    with uncounted(), torch.no_grad():
        got = crf_fused._backward_cuda(*call)
        again = crf_fused._backward_cuda(*call)
        ref = crf_fused.monotone_crf_backward_reference(x, go, k, c, w, g, bias, log_min,
                                                        log_min + span)
        errs, outliers = {}, 0
        for name, a, b, r in zip(names, got, again, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"crf_fused backward[{label}]: two launches differ in {name}")
            errs[name], n_out = grad_outliers(a.reshape(r.shape), r, float(r.abs().max()))
            outliers += n_out
        ties, errs_off_ties = 0, errs
        if outliers:
            tie = clip_ties(x, k, c, w, g, bias, log_min, span)
            ties, off = int(tie.sum()), go * ~tie
            got = crf_fused._backward_cuda(x, off, k, c, w, g, bias, log_min, span)
            ref = crf_fused.monotone_crf_backward_reference(x, off, k, c, w, g, bias, log_min,
                                                            log_min + span)
            errs_off_ties = {name: grads_close(
                f"crf_fused backward[{label}] d{name}, the clip's {ties} ties zeroed", a, r)
                for name, a, r in zip(names, got, ref)}
        del got, again, ref
        ms = event_ms(lambda: crf_fused._backward_cuda(*call), reps)
        plain_ms = event_ms(lambda: crf_fused.monotone_crf_backward_reference(
            x, go, k, c, w, g, bias, log_min, log_min + span), max(2, reps // 10), warmup=1)
    n, h = x.numel(), k.shape[1]
    bound_ms, bound_by = roofline(3 * n * 4 + 4 * 2 * (3 * k.numel() + 6),
                                  n * (T1_BWD_UNIT_OPS * h + T1_BWD_ELEM_OPS))
    res = dict(label=label, pixels=x.shape[0], hidden=h, max_abs_err=max(errs.values()),
               max_abs_err_by_group=errs, outliers=outliers, clip_ties=ties,
               max_abs_err_off_ties=errs_off_ties, deterministic=True, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               **t1_floors("bwd", h, n))
    log(f"crf_fused backward[{label}]: " + json.dumps(res))
    return res


def measure_crf_step(label, run):
    """T1 forward and backward on the image-sized call of one run of
    `run` (a training step's loss and gradients: the frame's CRF and the
    priors' curves), as captured."""
    from casualhdrsplat_torch.ops import crf_fused

    fwd = max(capture_calls(crf_fused, "_forward_cuda", run), key=lambda a: a[0].shape[0])
    bwd = max(capture_calls(crf_fused, "_backward_cuda", run), key=lambda a: a[0].shape[0])
    return measure_crf_forward(label, fwd, reps=10), measure_crf_backward(label, bwd, reps=10)


def t1_floors(direction, hidden, elements):
    """The MUFU and issue floors of T1's built kernel for this many
    elements, from its SASS instruction mix."""
    from casualhdrsplat_torch.ops import crf_fused
    from casualhdrsplat_torch.utils import sass

    mix = T1_MIX[direction, crf_fused._padded_hidden(hidden)]
    return sass.floors_ms(mix, elements, CARD_RATE["sms"], CARD_RATE["clock_hz"])


def t1_instruction_mix():
    """T1's instructions per element by class, read from the SASS of its
    built kernels at every padded width, into T1_MIX; logged per element,
    per element-unit and as a frame's MUFU and issue floors."""
    import subprocess

    import torch

    from casualhdrsplat_torch.crf_compare import cuda_passes
    from casualhdrsplat_torch.ops import crf_fused
    from casualhdrsplat_torch.utils import sass

    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True)
    CARD_RATE.update(sms=torch.cuda.get_device_properties(0).multi_processor_count,
                     clock_hz=float(smi.stdout.split()[0]) * 1e6)
    frame = 3 * 8 * SIZE * SIZE
    for direction, kernel in (("fwd", crf_fused.FWD_KERNEL), ("bwd", crf_fused.BWD_KERNEL)):
        funcs = sass.functions(kernel.library_path)
        for hp in (8, 16, 32, 64):
            (name, (per_pass, trips)), = [
                item for item in cuda_passes(hp).items() if f"_{direction}_" in item[0]]
            T1_MIX[direction, hp] = mix = sass.element_mix(sass.find(funcs, name), per_pass,
                                                           trips)
            log(f"T1 {direction} SASS at {hp} units, per element: "
                + json.dumps({k: round(v, 3) for k, v in mix.items()})
                + f"; per element-unit: MUFU {sum(v for k, v in mix.items() if 'MUFU' in k) / hp:.3f}, "
                f"all {mix['all'] / hp:.3f}; a frame's floors: "
                + json.dumps(sass.floors_ms(mix, frame, CARD_RATE["sms"], CARD_RATE["clock_hz"])))


def crf_hidden64_check(device):
    """T1 at 64 units (the widest the kernels take) against its plain
    versions on 100,000 pixels: forward atol T1_ATOL, backward at the
    backward tolerance, two backward launches equal to the bit."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=device).manual_seed(SEED)
    p = [F.softplus(torch.randn((3, 64), device=device, generator=gen) * 0.5) * 20.0,
         torch.rand((3, 64), device=device, generator=gen),
         F.softplus(torch.randn((3, 64), device=device, generator=gen) - 1.0),
         F.softplus(torch.randn(3, device=device, generator=gen)),
         torch.randn(3, device=device, generator=gen)]
    x = torch.exp(torch.rand((100_000, 3), device=device, generator=gen) * 16.0 - 11.0)
    go = torch.randn(x.shape, device=device, generator=gen)
    measure_crf_forward("hidden_64", (x, *p, -10.0, 14.0), reps=5)
    measure_crf_backward("hidden_64", (x, go, *p, -10.0, 14.0), reps=5)


def twins_close(what, graphed, eager):
    """Hold a graphed descent's results to its eager twin's on the same
    inputs: equal to the bit (B1, B2, G1 and T1 are deterministic), else
    within 1e-4 x the largest + rtol 1e-3 (the card's step tolerance), with
    the largest difference logged.  Returns whether all were equal."""
    import torch

    equal = True
    for i, (a, b) in enumerate(zip(graphed, eager)):
        if torch.equal(a, b):
            continue
        equal = False
        scale = float(b.abs().max())
        diff = (a - b).abs()
        log(f"  {what}, output {i}: graphed differs from eager by {float(diff.max()):.3g} "
            f"(largest {scale:.3g})")
        if bool((diff > 1e-4 * scale + 1e-3 * b.abs()).any()):
            raise AssertionError(f"{what}: graphed against eager, output {i}, max abs diff "
                                 f"{float(diff.max())} of a largest {scale}")
    return equal


def crf_prefit_phase(device):
    """crf.create at full width (32 units a channel, gamma 2.2): its gamma
    pre-fit, 1,200 Adam steps replayed as a CUDA graph, against the same
    pre-fit run eagerly from the same start (the same generator draws);
    T1 once each way a step, replays included.  Returns the seconds of the
    graphed create and of the eager pre-fit."""
    import torch

    from casualhdrsplat_torch import config
    from casualhdrsplat_torch.models import crf
    from casualhdrsplat_torch.ops import crf_fused

    cfg = config.CRFConfig()
    kernels = (crf_fused.FWD_KERNEL, crf_fused.BWD_KERNEL)
    before = [k.launches for k in kernels]
    created, t_graphed = timed(lambda: crf.create(cfg, torch.Generator().manual_seed(SEED),
                                                  device=device))
    launched = [k.launches - b for k, b in zip(kernels, before)]
    _, t_again = timed(lambda: crf.create(cfg, torch.Generator().manual_seed(SEED),
                                          device=device))
    start = crf.create(dataclasses.replace(cfg, init_gamma=0.0),
                       torch.Generator().manual_seed(SEED), device=device)
    eager, t_eager = timed(lambda: crf._prefit_to_gamma(start, cfg, graphed=False))
    equal = twins_close("crf.create's pre-fit", [created[k] for k in start],
                        [eager[k] for k in start])
    log(f"crf.create (32 units, 1200 pre-fit steps): graphed {t_graphed:.3f} s the first "
        f"time in this process (warm-up, capture, replays, and torch's one-time set-up of "
        f"graphs), {t_again:.3f} s again; the eager pre-fit {t_eager:.3f} s; "
        f"fitted parameters {'equal to the bit' if equal else 'within tolerance'}; T1 "
        f"launches forward {launched[0]}, backward {launched[1]}")
    if launched != [1200, 1200]:
        raise AssertionError(f"crf.create: T1 once each way per pre-fit step, got {launched}")
    _, curve = crf.response_curve(created, cfg)
    if not bool(torch.isfinite(curve).all()) or not bool((curve[1:] >= curve[:-1] - 1e-6).all()):
        raise AssertionError("crf.create: the fitted response is not finite and monotone")
    return t_graphed, t_eager


# Kernel P1 (ops/projection_fused.py), held against the plain chain it
# replaces (models/gaussians.py `project_chain`) on the inputs a path gives
# models/gaussians.py `project`: the forward's outputs (payload, means2d,
# depths, radii, valid) equal to the bit; the backward, through a fixed
# random weighting of the payload, per input ||g - g_chain|| / ||g_chain||
# <= P1_GRAD_RTOL, two launches equal to the bit.  The kernel chains the
# chain's derivatives in another order and sums the views and the pose
# gradient in its own, so the two differ by float32 rounding (~4e-7 at
# ladder4-full's size); a wrong derivative reads 1e-2 or more.  Its bound:
# bytes (csrc/projection_fwd.cu, csrc/projection_bwd.cu): the leaves read
# once (the SH coefficients up to the active degree), a view's 81 bytes
# written (the 64-byte row, means2d, depth, radius, flag); the backward
# reads the leaves again and 48 bytes of a view's row gradient, and writes
# each gradient asked for once.
P1_GRAD_RTOL = 2e-5
P1_OUTPUTS = ("payload", "means2d", "depths", "radii", "valid")
# the backward's reads of a view's row gradient (three float4 loads)
P1_ROW_GRAD_BYTES = 48


def capture_project(run):
    """(args, kwargs) of every call `run()` makes of models/gaussians.py
    `project` (which still runs), each tensor and each of the store's
    leaves detached and cloned as the call saw them; the kernels' launches
    of `run()` put back out of the counts."""
    import torch

    from casualhdrsplat_torch.models import gaussians as gauss_mod

    def freeze(a):
        if isinstance(a, dict):
            return {k: freeze(v) for k, v in a.items()}
        if isinstance(a, torch.Tensor):
            with torch.inference_mode(False):
                return a.detach().clone()
        return a

    calls, original = [], gauss_mod.project

    def recorder(*args, **kw):
        calls.append((tuple(freeze(a) for a in args), {k: freeze(v) for k, v in kw.items()}))
        return original(*args, **kw)

    gauss_mod.project = recorder
    try:
        with uncounted():
            run()
    finally:
        gauss_mod.project = original
    return calls


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def p1_bytes(inputs, statics):
    """(the forward's bytes, the backward's bytes without its gradients'
    writes) of one call of P1's launchers (`_forward_cuda`'s inputs and
    statics)."""
    means, _, _, _, sh_dc, sh_rest, colors, viewmats, _, offset, alive = inputs[:11]
    n, v = means.shape[0], viewmats.shape[0]
    leaves = sum(_nbytes(t) for t in (*inputs[:5], colors, offset, alive))
    if statics.degree > 0:
        leaves += n * ((statics.degree + 1) ** 2 - 1) * 3 * sh_rest.element_size()
    return leaves + v * n * 81 + v * 64, leaves + v * n * P1_ROW_GRAD_BYTES


def measure_projection(label, call, reps):
    """P1 against `project_chain` on one captured call of `project`
    (`capture_project`): the forward to the bit, the backward of every
    input `project` can differentiate (the store's floating leaves, the
    view matrices, the camera-to-world matrices, the colors and the offset
    where given) by relative norm, two backward launches equal to the bit;
    the kernels' times (CUDA events around the launchers), the chain's
    (its forward, and autograd's backward of it), the bounds.  Returns
    (forward's numbers, backward's numbers)."""
    import torch

    from casualhdrsplat_torch.models import gaussians as gauss_mod
    from casualhdrsplat_torch.ops import projection_fused as pf

    args, kw = call
    store, viewmats, cams, rest = args[0], args[1], args[2], args[3:]

    def flat(out):
        payload, projs = out
        return (payload, projs.means2d, projs.depths, projs.radii, projs.valid)

    def differentiable():
        """Fresh leaves, each floating one asking for a gradient: (the
        call's arguments, kwargs, {name: leaf})."""
        leaves = {k: t.clone().requires_grad_(t.is_floating_point()) for k, t in store.items()}
        wanted = {k: t for k, t in leaves.items() if t.requires_grad}
        vm = viewmats.clone().requires_grad_(True)
        wanted["viewmats"] = vm
        c = cams
        if isinstance(cams, torch.Tensor):
            c = wanted["camtoworlds"] = cams.clone().requires_grad_(True)
        kw2 = dict(kw)
        for name in ("colors", "means2d_offset"):
            if kw.get(name) is not None:
                kw2[name] = wanted[name] = kw[name].clone().requires_grad_(True)
        return (leaves, vm, c, *rest), kw2, wanted

    def grads(fn, d_payload):
        a, k, wanted = differentiable()
        payload = fn(*a, **k)[0]
        gs = torch.autograd.grad(payload, list(wanted.values()), d_payload, allow_unused=True)
        return {name: torch.zeros_like(w) if g is None else g
                for (name, w), g in zip(wanted.items(), gs)}

    with uncounted():
        with torch.no_grad():
            got = flat(gauss_mod.project(*args, **kw))
            want = flat(gauss_mod.project_chain(*args, **kw))
        unequal = [name for name, a, b in zip(P1_OUTPUTS, got, want)
                   if a.dtype != b.dtype or not torch.equal(a, b)]
        if unequal:
            raise AssertionError(f"projection[{label}]: P1's forward differs from the chain's "
                                 f"in {unequal}")
        # equal values; a zero of the other sign would be the only other bits
        signed_zeros = sum(int((a.contiguous().view(torch.uint8)
                                != b.contiguous().view(torch.uint8)).sum())
                           for a, b in zip(got, want))
        views, n = got[0].shape[0], got[0].shape[1] - 1
        gen = torch.Generator(device=got[0].device).manual_seed(SEED + 19)
        d_payload = torch.randn(got[0].shape, generator=gen, device=got[0].device)
        del got, want
        g_p1 = grads(gauss_mod.project, d_payload)
        g_again = grads(gauss_mod.project, d_payload)
        g_chain = grads(gauss_mod.project_chain, d_payload)
        gaps = {name: float((g_p1[name] - g_chain[name]).norm()
                            / g_chain[name].norm().clamp(min=1e-30)) for name in g_chain}
        deterministic = all(torch.equal(g_p1[k], g_again[k]) for k in g_p1)
        err = max(float((g_p1[k] - g_chain[k]).abs().max()) for k in g_chain)
        del g_p1, g_again, g_chain
        if not deterministic:
            raise AssertionError(f"projection[{label}]: two backward launches differ")
        if max(gaps.values()) > P1_GRAD_RTOL:
            raise AssertionError(f"projection[{label}]: P1's backward against autograd of the "
                                 f"chain by relative norm {gaps} (limit {P1_GRAD_RTOL})")

        # the kernels on the launchers' own arguments, and the chain
        with torch.no_grad():
            fwd_call, = capture_calls(pf, "_forward_cuda",
                                      lambda: gauss_mod.project(*args, **kw))
        bwd_call, = capture_calls(pf, "_backward_cuda", lambda: grads(gauss_mod.project,
                                                                      d_payload))
        with torch.no_grad():
            ms = event_ms(lambda: pf._forward_cuda(*fwd_call), reps)
            bwd_ms = event_ms(lambda: pf._backward_cuda(*bwd_call), reps)
            plain_ms = event_ms(lambda: gauss_mod.project_chain(*args, **kw),
                                max(2, reps // 10), warmup=1)
        a, k, wanted = differentiable()
        chain_payload = gauss_mod.project_chain(*a, **k)[0]
        plain_bwd_ms = event_ms(lambda: torch.autograd.grad(
            chain_payload, list(wanted.values()), d_payload, retain_graph=True,
            allow_unused=True), max(2, reps // 10), warmup=1)
        written = sum(_nbytes(g) for g in pf._backward_cuda(*bwd_call))
        del chain_payload, wanted
    fwd_bytes, bwd_read = p1_bytes(fwd_call[0], fwd_call[1])
    bound_ms, bound_by = roofline(fwd_bytes, 0)
    bwd_bound_ms, bwd_bound_by = roofline(bwd_read + written, 0)
    meta = dict(label=label, views=views, gaussians=n, sh_degree=fwd_call[1].degree,
                antialias=fwd_call[1].antialias)
    fwd = dict(**meta, equal=True, bytes_of_signed_zeros=signed_zeros, max_abs_err=0.0,
               ms=ms, plain_ms=plain_ms, bound_bytes=fwd_bytes, bound_ms=bound_ms,
               bound_by=bound_by)
    bwd = dict(**meta, rel_norm_gap=gaps, rtol=P1_GRAD_RTOL, max_abs_err=err,
               deterministic=True, ms=bwd_ms, plain_ms=plain_bwd_ms,
               bound_bytes=bwd_read + written, bound_ms=bwd_bound_ms, bound_by=bwd_bound_by)
    log(f"projection forward[{label}]: " + json.dumps(fwd))
    log(f"projection backward[{label}]: " + json.dumps(bwd))
    return fwd, bwd


def _stream_meta(stream, lo, hi, statics):
    return dict(rows=lo.shape[0], tile=f"{statics.tile_h}x{statics.tile_w}",
                chunk=statics.chunk, stream_rows=stream.shape[0],
                intersections=int((hi - lo).sum()))


def measure_backward(label, call, reps):
    """Kernel B2 vs its plain version on one captured call of its launcher
    (stream, row_lo, row_hi, order, out4, g4, statics).  The function reads
    the payload rows of the slots it visits and writes their gradient rows
    (the rest of the stream buffer is padding the allocation zeroes), and
    reads the row bounds, out4 and g4."""
    import torch

    from casualhdrsplat_torch.ops import rasterize_packed as rp

    stream, lo, hi, order, out4, g4, statics = call
    with torch.no_grad():
        _, work = rp.composite_stream_reference(stream, lo, hi, statics, return_work=True)
    rows, p = lo.shape[0], statics.tile_h * statics.tile_w
    nbytes = 2 * work.slots * 64 + 2 * rows * 4 + 2 * (rows + 1) * 4 * p * 4
    return measure_gradient(
        label, lambda g: rp._backward_cuda(stream, lo, hi, order, out4, g, statics),
        lambda g: rp.composite_stream_backward_reference(stream, lo, hi, out4, g, statics),
        g4, work, nbytes, p, reps,
        **_stream_meta(stream, lo, hi, statics))


def measure_compositor(label, call, launches_per_request, reps):
    """Kernel B1 vs its plain version on one captured call of
    composite_stream (stream, row_lo, row_hi, statics).  The function reads
    the payload rows of the slots it composites (not the padding of the
    stream buffer) and the row bounds, and writes every row's tile."""
    from casualhdrsplat_torch.ops import rasterize_packed as rp

    stream, lo, hi, statics = call
    rows, p = lo.shape[0], statics.tile_h * statics.tile_w
    return measure_forward(
        label, lambda: rp.composite_stream(stream, lo, hi, statics),
        lambda work: rp.composite_stream_reference(stream, lo, hi, statics, return_work=work),
        float(stream[:, 6:10].max()), statics.alpha_threshold,
        lambda work: work.slots * 64 + 2 * rows * 4 + (rows + 1) * 4 * p * 4, p, reps,
        launches_per_request=launches_per_request, **_stream_meta(stream, lo, hi, statics))


def _list_meta(rows, ids, counts, statics):
    return dict(tiles=ids.shape[0], tile=f"{statics.tile_h}x{statics.tile_w}",
                chunk=statics.chunk, capacity=ids.shape[1], payload_rows=rows.shape[0],
                occupied_slots=int(counts.sum()), fullest_tile=int(counts.max()))


def list_read_bytes(rows, ids, ti, counts, statics, work):
    """Bytes the list form must read for one call: each visited slot's id,
    USED_ROW_BYTES of each distinct payload row those slots name (once,
    however many tiles name it), and the tiles' indices and counts."""
    import torch

    from casualhdrsplat_torch.ops import composite

    index, _ = composite.list_rows(rows, ids, ti, counts, statics)
    distinct = int(torch.unique(index[work.slots_read]).numel())
    return distinct * USED_ROW_BYTES + work.slots * 4 + 2 * ids.shape[0] * 4


def measure_dense_forward(label, call, launches_per_request, reps):
    """Kernel B3 vs its plain version on one captured call of its launcher
    in the list form (rows, tile_indices, counts, statics, ids).  The
    function reads what `list_read_bytes` counts and writes every tile."""
    from casualhdrsplat_torch.ops import composite, rasterize_dense

    rows, ti, counts, statics, ids = call
    tt, p = ids.shape[0], statics.tile_h * statics.tile_w
    return measure_forward(
        label, lambda: rasterize_dense.forward(*call),
        lambda work: composite.composite_tile_lists_reference(rows, ids, ti, counts, statics,
                                                              return_work=work),
        float(rows[:, 6:10].max()), statics.alpha_threshold,
        lambda work: list_read_bytes(rows, ids, ti, counts, statics, work) + tt * 4 * p * 4,
        p, reps, launches_per_request=launches_per_request,
        **_list_meta(rows, ids, counts, statics))


def measure_dense_backward(label, call, reps):
    """Kernel B4 vs its plain version on one captured call of its launcher
    in the list form (rows, tile_indices, counts, out4, g4, statics, ids).
    The function reads what `list_read_bytes` counts, out4 and g4, and
    writes the whole gradient of the rows once.  Its atomics add a row's
    gradients in an order that changes from run to run: no bit equality."""
    import torch

    from casualhdrsplat_torch.ops import composite, rasterize_dense

    rows, ti, counts, out4, g4, statics, ids = call
    with torch.no_grad():
        _, work = composite.composite_tile_lists_reference(rows, ids, ti, counts, statics,
                                                           return_work=True)
    tt, p = ids.shape[0], statics.tile_h * statics.tile_w
    nbytes = (list_read_bytes(rows, ids, ti, counts, statics, work) + 2 * tt * 4 * p * 4
              + rows.numel() * 4)
    return measure_gradient(
        label, lambda g: rasterize_dense.backward(rows, ti, counts, out4, g, statics, ids),
        lambda g: composite.composite_tile_lists_backward_reference(rows, ids, ti, counts, out4,
                                                                    g, statics),
        g4, work, nbytes, p, reps, deterministic=False,
        **_list_meta(rows, ids, counts, statics))


def capture_backwards(fn):
    """Run fn(), a packed path's forward and backward, and return the
    arguments of its calls of B2's launcher and of G1's
    (stream_gather._backward_cuda: d stream, ids, rows); their launches
    are not counted."""
    from casualhdrsplat_torch.ops import rasterize_packed as rp
    from casualhdrsplat_torch.ops import stream_gather as sg

    g1 = []
    b2 = capture_calls(rp, "_backward_cuda",
                       lambda: g1.extend(capture_calls(sg, "_backward_cuda", fn)))
    return b2, g1


def g1_real_lists(offsets, slots, ids, rows):
    """(each real row's slot count, its slots concatenated in key order) of
    a stream index: what G1 reads, whatever the pad rows hold."""
    import torch

    from casualhdrsplat_torch.ops import stream_gather as sg

    keys = sg._keys(ids, rows).long()
    counts = offsets[1:] - offsets[:-1]
    real_key = torch.arange(counts.numel(), device=counts.device) % rows != rows - 1
    placed = slots[:int(offsets[-1])].long()
    return counts[real_key], placed[keys[placed] % rows != rows - 1]


def g1_inputs_dir():
    """The directory after --g1-inputs, where measure_g1 saves each input it
    measures (for step_compare's G1 turns), or None."""
    args = sys.argv[1:]
    return args[args.index("--g1-inputs") + 1] if "--g1-inputs" in args else None


def measure_g1(label, call, reps):
    """Kernel G1 (ops/stream_gather.py) on one captured call of the card's
    backward (d stream [V, S, 16], ids [S] shared or [V, S] per view, rows
    R): equal to the PyTorch emulation of its schedule to the bit, two
    launches equal to the bit, and within the backward tolerance of its
    plain version (index_add_, float atomics on the card).  Its index, the
    counting pass (`slot_index`), gives every real row the list of slots
    the sort (`inverse_index`, its plain version) gives it, the same from
    launch to launch.  Times with CUDA events around `reps` calls back to
    back, as every kernel of the kernels line is timed (host launches
    included where they are slower than the card; step_compare times G1
    in a CUDA graph): the backward as the path runs it (`ms`: the index
    and the kernel), each alone (`index_ms`, `kernel_ms`), the sort the
    index replaced (`sort_index_ms`), the plain version, and the library
    call the port ran before G1 (gather's backward, scatter_add_ with the
    index expanded over the views, for shared ids; index_add_ per view).
    The bound: the function reads every
    id once and the gradient row of each slot that names a real row (not
    the pad id) once a view, and writes the [V, R, 16] gradient once; one
    add per element read.  The index's own bound (under "index"): the ids
    read once, the offsets and the placed slots written once."""
    import torch

    from casualhdrsplat_torch.ops import stream_gather as sg

    grad, ids, rows = call
    v, s = grad.shape[:2]
    shared = ids.dim() == 1
    if g1_inputs_dir():
        os.makedirs(g1_inputs_dir(), exist_ok=True)
        torch.save(call, os.path.join(g1_inputs_dir(), f"{label}.pt"))
    with uncounted(), torch.no_grad():
        got = sg._backward_cuda(grad, ids, rows)
        again = sg._backward_cuda(grad, ids, rows)
        emulated = sg.stream_gather_backward_emulation(grad, ids, rows)
        plain = sg.stream_gather_backward_reference(grad, ids, rows)
        torch.cuda.synchronize()
        equal, deterministic = torch.equal(got, emulated), torch.equal(got, again)
        largest = float(plain.abs().max())
        err, outliers = grad_outliers(got, plain, largest)
        del again, emulated, plain
        offsets, slots = sg.slot_index(ids, rows)
        offsets2, slots2 = sg.slot_index(ids, rows)
        placed = int(offsets[-1])
        index_deterministic = (torch.equal(offsets, offsets2)
                               and torch.equal(slots[:placed], slots2[:placed]))
        del offsets2, slots2
        counts, lists = g1_real_lists(offsets, slots, ids, rows)
        want_counts, want_lists = g1_real_lists(*sg.inverse_index(ids, rows), ids, rows)
        index_err = int((counts - want_counts).abs().max())
        if index_err == 0:
            index_err = int((lists - want_lists).abs().max()) if lists.numel() else 0
        longest = int(counts.max()) if counts.numel() else 0
        del counts, lists, want_counts, want_lists
        if shared:
            index = ids.long()[None, :, None].expand(v, -1, grad.shape[2])

            def library():
                return torch.zeros_like(got).scatter_add_(1, index, grad)
        else:
            keys = sg._keys(ids, rows).long()
            flat = grad.reshape(v * s, grad.shape[2])

            def library():
                return torch.zeros((v * rows, grad.shape[2]), device=grad.device).index_add_(
                    0, keys, flat)
        ms = event_ms(lambda: sg._backward_cuda(grad, ids, rows), reps)
        kernel_ms = event_ms(lambda: sg._launch(grad, offsets, slots, rows, shared), reps)
        index_ms = event_ms(lambda: sg.slot_index(ids, rows), reps)
        sort_index_ms = event_ms(lambda: sg.inverse_index(ids, rows), reps)
        plain_ms = event_ms(lambda: sg.stream_gather_backward_reference(grad, ids, rows), reps)
        library_ms = event_ms(library, reps)
        live = int((ids < rows - 1).sum())
    reads = live * (v if shared else 1)
    nbytes = reads * grad.shape[2] * 4 + ids.numel() * 4 + got.numel() * 4
    bound_ms, bound_by = roofline(nbytes, reads * grad.shape[2])
    index_bytes = ids.numel() * 4 + offsets.numel() * 4 + placed * 4
    index_bound_ms, index_bound_by = roofline(index_bytes, 0)
    res = dict(
        label=label, views=v, slots_per_view=s, rows=rows,
        ids="shared" if shared else "per view", slots_naming_a_row=live,
        longest_row=longest, bound_bytes=nbytes,
        max_abs_err=err, largest_gradient=largest, outliers=outliers,
        equal_to_emulation=equal, deterministic=deterministic,
        ms=ms, kernel_ms=kernel_ms, index_ms=index_ms, sort_index_ms=sort_index_ms,
        plain_ms=plain_ms, library_ms=library_ms,
        library="scatter_add_" if shared else "index_add_",
        bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
        kernel_share_of_bound=bound_ms / kernel_ms,
        index=dict(max_abs_err=index_err, deterministic=index_deterministic, ms=index_ms,
                   plain_ms=sort_index_ms, bound_bytes=index_bytes, bound_ms=index_bound_ms,
                   bound_by=index_bound_by),
    )
    log(f"G1[{label}]: " + json.dumps(res))
    if not (equal and deterministic and outliers == 0):
        raise AssertionError(
            f"G1[{label}]: equal to its emulation {equal}, two launches equal "
            f"{deterministic}, {outliers} elements outside the backward tolerance of the plain "
            f"version (max abs err {err} against a largest value of {largest})")
    if index_err or not index_deterministic:
        raise AssertionError(
            f"G1[{label}]: the counting index differs from the sort's on a real row (max abs "
            f"err {index_err}) or between two launches ({not index_deterministic})")
    return res


def run_to_run(trainer, label):
    """Two eager steps from one state: the largest difference of every
    tensor of the step between them, by kind and group (a group's gradient
    read off its first moment, as `compare_step_tensors` reads it), logged
    and not held.  What is not zero there is what a packed step does not
    reproduce on the card.  Launches not counted; the trainer goes on from
    the first step's state."""
    import torch

    start = trainer_state(trainer)
    ends = []
    with uncounted():
        for _ in range(2):
            set_trainer_state(trainer, start)
            trainer.run_step_eager()
            ends.append(trainer_state(trainer))
    set_trainer_state(trainer, ends[0])
    diffs = {}
    for (kind, name), a, b in zip(step_tensor_kinds(trainer), ends[0]["tensors"],
                                  ends[1]["tensors"]):
        if kind == "read" or a.numel() == 0:
            continue
        d = float((a.double() - b.double()).abs().max())
        if kind == "mu":
            d /= 1.0 - trainer.opt.groups[name].b1
            kind = "gradient"
        key = f"{kind} {name}"
        diffs[key] = max(diffs.get(key, 0.0), d)
    moved = sorted(k for k, d in diffs.items() if d > 0)
    log(f"{label}, run to run: two eager steps from one state, the largest difference of "
        f"every gradient group and tensor of the step: {json.dumps(diffs)}; "
        + (f"not equal to the bit: {moved}" if moved else "every one equal to the bit"))
    return diffs


def profile_window(name, fn, reps=3):
    """Device time by kernel over `reps` calls of fn() (torch.profiler),
    against the host-clock wall time of the same window: returns (wall ms,
    busy ms) per call.  The kernels of a replayed CUDA graph are traced one
    by one like any other.  With --profile, also the largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: [fn() for _ in range(reps)])
    # kernels only: the aten ops that launch them carry the same time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3  # us -> ms
    log(f"profile[{name}]: {reps} calls, wall {wall * 1e3 / reps:.2f} ms, "
        f"device busy {busy / reps:.2f} ms per call "
        f"({100 * busy / (wall * 1e3):.1f}% of wall), "
        f"{sum(e.count for e in events) // reps} kernel launches per call")
    if "--profile" in sys.argv[1:]:
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:16]:
            t = e.self_device_time_total / 1e3 / reps
            log(f"  {t:9.3f} ms/call {e.count // reps:5d} launches  {e.key[:90]}")
    return wall * 1e3 / reps, busy / reps


def eager_and_graphed(name, eager, graphed, reps=3):
    """Walls (host clock, medians of `reps` calls each, alternating) and
    profiled busy shares of the eager and the graphed call, in this call of
    the script: one line, kept for the summary."""
    for fn in (eager, graphed, graphed):  # warm-up: the graph is captured
        timed(fn)
    walls = {"eager": [], "graphed": []}
    for _ in range(reps):
        for kind, fn in (("eager", eager), ("graphed", graphed)):
            walls[kind].append(timed(fn)[1] * 1e3)
    row = {"window": name}
    for kind, fn in (("eager", eager), ("graphed", graphed)):
        wall, busy = profile_window(f"{name}, {kind}", fn)
        row[kind] = dict(wall_ms=float(np.median(walls[kind])), walls_ms=walls[kind],
                         profiled_wall_ms=wall, busy_ms=busy, busy_share=busy / wall)
    log("eager vs graphed: " + json.dumps(row))
    WINDOWS.append(row)
    return row


# every eager_and_graphed row of this run, printed together at the end
WINDOWS = []
# G1's index's launches in each phase, read from its own counter where the
# phase reads G1's (and checked equal to them): the kernels line's count
INDEX_LAUNCHES = {}


def small_slice_check(device):
    """The whole slice on the card against the slice on the CPU (the plain
    compositor), at a small size."""
    import torch

    from casualhdrsplat_torch import config
    from casualhdrsplat_torch.data import synthetic
    from casualhdrsplat_torch.models import image_formation as imf
    from casualhdrsplat_torch.ops import sh

    cfg = config.ModelConfig(
        max_gaussians=300, sh_degree=1, num_virtual_views=3,
        crf=config.CRFConfig(hidden=8),
        rasterize=config.RasterizeConfig(tile_h=8, tile_w=16, chunk=32),
    )
    outs = []
    for dev in (device, "cpu"):
        rng = np.random.default_rng(SEED + 1)
        cloud = synthetic.random_cloud(rng, 300, device=dev)
        poses = synthetic.orbit_knots(3, angle_span=0.2, width=64, img_height=64, device=dev)
        ds = SimpleNamespace(viewmats=poses.cpu().numpy(),
                             timestamps=np.arange(3, dtype=np.float32),
                             fx=57.6, fy=57.6, cx=32.0, cy=32.0, width=64, height=64)
        scene = imf.build_scene(ds, cfg, device=dev)
        params = imf.init_params(scene, cloud.means3d.cpu().numpy(),
                                 cloud.colors.cpu().numpy(), cfg,
                                 torch.Generator().manual_seed(SEED))
        params["gaussians"]["sh_rest"] = torch.as_tensor(
            rng.normal(0, 0.1, size=(300, 3, 3)).astype(np.float32), device=dev)
        params["gaussians"]["opacity_logit"] += 3.0
        with torch.inference_mode():
            outs.append(imf.render_frame(params, scene, 1, cfg).blurred_ldr.cpu())
    err = float((outs[0] - outs[1]).abs().max())
    log(f"small slice, card vs CPU: max abs err {err} (atol {ATOL})")
    if not torch.allclose(outs[0], outs[1], atol=ATOL, rtol=RTOL):
        raise AssertionError(f"slice on the card disagrees with the CPU: {err}")


def row_bounds_check(device):
    """B1 and B2 on rows whose bounds leave the stream (one starting before
    it, one ending past it, one ending before it starts): each composites
    nothing and owns no slot, as the same rows made empty, to the bit, and
    B1 agrees with its plain version.  The launcher reads no bound on the
    host; the kernels check them."""
    import torch

    from casualhdrsplat_torch.ops import binning
    from casualhdrsplat_torch.ops import rasterize_packed as rp
    from casualhdrsplat_torch.ops.composite import CompositeStatics

    statics = CompositeStatics(num_views=1, ntx=2, nty=2, tile_h=16, tile_w=16, chunk=32,
                               alpha_clip=0.99, alpha_threshold=1 / 255,
                               transmittance_eps=1e-4, backend="pallas")
    rng = np.random.default_rng(SEED + 5)
    stream = torch.zeros(128, binning.PAYLOAD_DIM)
    stream[:, 0:2] = torch.as_tensor(rng.uniform(0, 32, (128, 2)), dtype=torch.float32)
    stream[:, 2] = stream[:, 4] = 0.05
    stream[:, 5] = 0.6
    stream[:, 6:10] = 1.0
    stream = stream.to(device)
    i32 = dict(dtype=torch.int32, device=device)
    bad = (torch.tensor([0, -7, 40, 90], **i32), torch.tensor([30, 50, 200, 60], **i32))
    empty = (torch.tensor([0, 0, 0, 0], **i32), torch.tensor([30, 0, 0, 0], **i32))
    with uncounted(), torch.no_grad():
        out = rp._forward_cuda(stream, *bad, rp.row_order(*bad), statics)
        want = rp._forward_cuda(stream, *empty, rp.row_order(*empty), statics)
        g4 = torch.ones_like(out)
        d = rp._backward_cuda(stream, *bad, rp.row_order(*bad), out, g4, statics)
        d_want = rp._backward_cuda(stream, *empty, rp.row_order(*empty), want, g4, statics)
    plain = rp.composite_stream_reference(stream, *bad, statics)
    err = float((out - plain).abs().max())
    log(f"rows outside the stream: B1 and B2 treat them as empty (equal to the bit), B1 "
        f"against its plain version max abs err {err}")
    if not (torch.equal(out, want) and torch.equal(d, d_want) and err <= ATOL
            and float(out[1:].abs().max()) == 0.0 and float(d[30:].abs().max()) == 0.0):
        raise AssertionError("B1/B2 on rows outside the stream")


def small_train_step_check(device):
    """One training step's gradients on the card (kernels B1, B2 and G1,
    the gather's transpose) against the same on the CPU (the plain
    versions), at 64x64, for every parameter group and the means2d tap."""
    import torch

    from casualhdrsplat_torch import config
    from casualhdrsplat_torch.data import dataset as dataset_mod
    from casualhdrsplat_torch.train import optim
    from casualhdrsplat_torch.train.trainer import Trainer

    cfg = config.TrainConfig()
    cfg.model = config.ModelConfig(
        max_gaussians=384, sh_degree=2, num_virtual_views=3,
        crf=config.CRFConfig(hidden=8),
        # stream_factor 10: the k-NN init of 300 points makes wide splats
        rasterize=config.RasterizeConfig(tile_h=8, tile_w=16, chunk=32, stream_factor=10),
    )
    cfg.densify.enabled = False
    cfg.data.eval_every = 0
    ds = dataset_mod.make_synthetic_dataset(
        seed=SEED + 2, device="cpu", n_gaussians=300, n_frames=3, n_virtual=3, size=64,
        angle_span=0.2, raster_cfg=cfg.model.rasterize)
    # anisotropic, rotated, visibly opaque splats: the isotropic k-NN init
    # would leave the quaternions without a gradient
    rng = np.random.default_rng(SEED + 3)
    bump = {"log_scales": rng.normal(0, 0.3, size=(384, 3)), "quats": rng.normal(0, 0.3, (384, 4)),
            "opacity_logit": np.full(384, 3.0)}
    results = []
    for dev in (device, "cpu"):
        trainer = Trainer(cfg, ds, device=dev)
        for name, delta in bump.items():
            trainer.params["gaussians"][name] += torch.as_tensor(
                delta.astype(np.float32), device=dev)
        loss, _, grads, g2d = trainer.loss_and_grads(1)
        flat = {"/".join(path): optim.tree_get(grads, path).cpu()
                for path, label, _ in optim.labelled_leaves(trainer.params)
                if label != "frozen"}
        flat["means2d_offset"] = g2d.cpu()
        results.append((float(loss), flat))
    (loss_card, card), (loss_cpu, cpu) = results
    if abs(loss_card - loss_cpu) > ATOL:
        raise AssertionError(f"training loss on the card {loss_card} vs CPU {loss_cpu}")
    for name, ref in cpu.items():
        if float(ref.abs().max()) == 0.0:
            raise AssertionError(f"small training step: no gradient reaches {name}")
    worst = max(grads_close(f"small training step, card vs CPU, {name}", card[name], cpu[name])
                / float(cpu[name].abs().max()) for name in cpu)
    log(f"small training step, card vs CPU: loss {loss_card:.6f} vs {loss_cpu:.6f}, "
        f"{len(cpu)} gradient groups agree, worst max abs err {worst:.3g} of the group's "
        f"largest gradient (atol {BWD_ATOL_REL} of it + rtol {BWD_RTOL})")


def make_training_data(device):
    """The synthetic casual video both training phases fit, made on the
    card: (dataset, the model config it was sized for)."""
    from casualhdrsplat_torch import config
    from casualhdrsplat_torch.data import dataset as dataset_mod

    m = config.PRESETS["ladder4"]().model
    dataset, t_data = timed(lambda: dataset_mod.make_synthetic_dataset(
        seed=SEED, device=device, renderer="fast", n_gaussians=m.max_gaussians,
        n_frames=N_FRAMES, n_virtual=m.num_virtual_views, size=SIZE,
        scale_range=(0.004, 0.02), angle_span=0.12, exposure_range=(0.4, 0.8)))
    log(f"training data: {dataset.images.shape[0]} frames of {SIZE}x{SIZE} rendered from "
        f"{len(dataset.points_xyz)} Gaussians in {t_data:.2f} s")
    return dataset


def timed_trainer(cfg, dataset, device):
    """(Trainer, its set-up seconds, of which the k-NN scale init: the
    host grid search and one copy to the card, by the program's record of
    the call, ops/knn.py `LAST`)."""
    from casualhdrsplat_torch.ops import knn
    from casualhdrsplat_torch.train.trainer import Trainer

    before = knn.LAST
    trainer, t_init = timed(lambda: Trainer(cfg, dataset, device=device))
    return trainer, t_init, 0.0 if knn.LAST is before else knn.LAST.ms / 1e3


def trainer_state(trainer):
    """Everything a training step reads and writes, copied: the tensors,
    the update count and step, the frame sampler, the split-noise
    generator and the watchdog."""
    return dict(tensors=[x.clone() for x in trainer._step_tensors()],
                count=trainer.opt_state["count"], step=trainer.step,
                rng=copy.deepcopy(trainer._rng.bit_generator.state),
                noise=trainer._adc_generator.get_state(),
                watch=(trainer._clip_floor, trainer._clip_warn_at, trainer._screen_prune_armed))


def set_trainer_state(trainer, state):
    """Put a `trainer_state` back, writing the trainer's tensors in place:
    its captured step keeps reading them."""
    import torch

    with torch.no_grad():
        for dst, src in zip(trainer._step_tensors(), state["tensors"]):
            dst.copy_(src)
    trainer.opt_state["count"], trainer.step = state["count"], state["step"]
    trainer._rng.bit_generator.state = copy.deepcopy(state["rng"])
    trainer._adc_generator.set_state(state["noise"])
    trainer._clip_floor, trainer._clip_warn_at, trainer._screen_prune_armed = state["watch"]


def round_threshold(trainer):
    """When the next step ends in a densify round: put the round's
    gradient threshold into the widest gap of the averages that step will
    see (predicted by an eager loss_and_grads from the same state), between
    the 70th and 97th percentile of the alive slots'.  The graphed and the
    eager step then grant the same slots: their statistics differ only by
    what the run-to-run log shows (on the dense path B4's float atomics),
    far below that gap.  Returns the threshold, or None."""
    import torch

    from casualhdrsplat_torch.train import densify as densify_mod

    d, nxt = trainer.cfg.densify, trainer.step + 1
    if not (d.enabled and d.start_iter <= nxt <= d.stop_iter and nxt % d.interval == 0):
        return None
    frame = int(copy.deepcopy(trainer._rng).choice(trainer.dataset.train_indices))
    with uncounted():
        _, aux, _, g2d = trainer.loss_and_grads(frame, torch.tensor(trainer._c2f_sigma(),
                                                                    device=trainer.device))
    adc = densify_mod.accumulate(trainer.adc, g2d, aux["radii"], scale=trainer._adc_scale)
    avg = (adc.grad_accum / adc.count.clamp(min=1))[trainer.params["gaussians"]["alive"]]
    avg = torch.sort(avg).values
    lo, hi = int(0.70 * avg.numel()), int(0.97 * avg.numel())
    k = int(torch.argmax(avg[lo + 1:hi] - avg[lo:hi - 1]))
    d.grad_threshold = float(0.5 * (avg[lo + k] + avg[lo + k + 1]))
    return d.grad_threshold


def step_tensor_kinds(trainer):
    """(kind, group label) of every tensor of `trainer._step_tensors()`, in
    its order: the parameters, the two moment trees, the statistics, then
    what a step only reads."""
    from casualhdrsplat_torch.train import optim

    leaves = list(optim.labelled_leaves(trainer.params))
    kinds = [("param", label) for _, label, _ in leaves]
    for moment in ("mu", "nu"):
        kinds += [(moment, label) for _, label, _ in leaves if label != "frozen"]
    kinds += [("stat", name) for name in trainer.adc._fields]
    return kinds + [("read", None)] * (len(trainer._step_tensors()) - len(kinds))


def compare_step_tensors(trainer, label, start, graphed, eager):
    """Hold the graphed step's tensors to the eager step's, both from the
    state `start` (`trainer_state`s).  A group's gradient is read off its
    first moment, mu = b1 mu0 + (1 - b1) g, and held at the card-vs-CPU
    step tolerance (BWD_ATOL_REL of the group's largest + BWD_RTOL; the
    second moment is a function of the same gradient).  The parameters are
    held to within two of the group's learning rates (times the pose
    group's translation scale) plus two roundings: Adam divides each
    element's first moment by its own root mean square, so where a
    gradient sits within the run-to-run noise (B4's float atomics on the
    dense path, and whatever `run_to_run` logs) its step can take either
    sign, and a step moves an element by about lr.  The statistics' sum of
    screen gradients at the step tolerance, their counts and radii and
    every tensor a step only reads to the bit.  Returns the worst gradient
    error (of the largest) and the worst parameter difference (in lr)."""
    import torch

    worst = {"gradient": 0.0, "param_lr": 0.0}
    lrs = trainer.opt.learning_rates(start["count"])
    for i, ((kind, name), a0, a, b) in enumerate(zip(step_tensor_kinds(trainer),
                                                     start["tensors"], graphed["tensors"],
                                                     eager["tensors"])):
        what = f"{label}: {kind} {name} (tensor {i} of the step)"
        if kind == "param" and a.is_floating_point():
            group = trainer.opt.groups[name]
            lr = lrs[name] * max(1.0, group.trans_scale)
            err = float((a - b).abs().max())
            if err > 2.0 * lr + 2.4e-7 * float(b.abs().max()):
                raise AssertionError(f"{what}: max abs diff {err}, learning rate {lr}")
            worst["param_lr"] = max(worst["param_lr"], err / max(lr, 1e-30))
        elif kind == "mu":
            b1 = trainer.opt.groups[name].b1
            g_a, g_b = (a - b1 * a0) / (1.0 - b1), (b - b1 * a0) / (1.0 - b1)
            # two roundings of the moment, seen through 1 / (1 - b1)
            floor = 2.4e-7 * float(b.abs().max()) / (1.0 - b1)
            scale = float(g_b.abs().max())
            diff = (g_a - g_b).abs()
            if bool((diff > BWD_ATOL_REL * scale + BWD_RTOL * g_b.abs() + floor).any()):
                raise AssertionError(f"{what}: gradient max abs err {float(diff.max())} "
                                     f"against a largest of {scale}")
            worst["gradient"] = max(worst["gradient"], float(diff.max()) / max(scale, 1e-30))
        elif kind == "stat" and name == "grad_accum":
            grads_close(what, a, b)
        elif kind != "nu" and not torch.equal(a, b):
            raise AssertionError(f"{what} differs")
    return worst


def graph_vs_eager_steps(trainer, steps, kernels, label, after_step=None):
    """`steps` training steps, each run twice from the same state: the
    graphed `run_step` and the eager `run_step_eager`; the run goes on from
    the graphed one.  Each step must give the eager step's scalars (the
    counts equal, loss and PSNR within the card-vs-CPU step tolerance) and
    its tensors as `compare_step_tensors` holds them: B4's float atomics
    add in an order that changes from run to run, and the run-to-run log
    of the packed step (`run_to_run`) shows what else does.  Each of
    `kernels` must launch once a step on either path.  A round's threshold is put where both grant the
    same slots (`round_threshold`).  On a mesh, each run's collectives
    (`mesh.stats`, cleared before it) must be the same calls and bytes.
    Returns {"graphed": walls, "eager": walls} in seconds, "replay":
    whether each graphed step replayed (the warm-up and the capture did
    not) and on a mesh "collectives": each step's {kind: mesh.stats}."""
    walls = {"graphed": [], "eager": [], "replay": [], "collectives": []}
    mesh = trainer.mesh
    for _ in range(steps):
        thr = round_threshold(trainer)
        start = trainer_state(trainer)
        outs, launched, results, stats = {}, {}, {}, {}
        call = trainer._step_graphs.call
        seen = (call.captures, call.replays) if call is not None else None
        for kind in ("graphed", "eager"):
            if kind == "eager":
                set_trainer_state(trainer, start)
            before = [k.launches for k in kernels]
            run = trainer.run_step if kind == "graphed" else trainer.run_step_eager
            if mesh is not None:
                mesh.stats.clear()
            outs[kind], dt = timed(run)
            if mesh is not None:
                stats[kind] = {k: list(v) for k, v in mesh.stats.items()}
            walls[kind].append(dt)
            if kind == "graphed":  # a replay, neither the warm-up nor the capture
                walls["replay"].append(trainer._step_graphs.call is call and seen is not None
                                       and (call.captures, call.replays) == (seen[0],
                                                                             seen[1] + 1))
            launched[kind] = [k.launches - b for k, b in zip(kernels, before)]
            results[kind] = trainer_state(trainer)
        g, e = outs["graphed"], outs["eager"]
        log(f"{label} step {trainer.step}: graphed {walls['graphed'][-1] * 1e3:.2f} ms, "
            f"eager {walls['eager'][-1] * 1e3:.2f} ms, " + ", ".join(
                f"{k} {v:.5f}" if k in ("loss", "psnr") else f"{k} {v:.0f}"
                for k, v in g.items()) + (f" (round threshold {thr:.4g})" if thr else ""))
        if g.keys() != e.keys() or not all(np.isfinite(v) for v in g.values()):
            raise AssertionError(f"{label}: graphed step {g} against eager {e}")
        for key in g:
            exact = key not in ("loss", "psnr")
            if (g[key] != e[key]) if exact else abs(g[key] - e[key]) > (
                    BWD_ATOL_REL + BWD_RTOL) * abs(e[key]):
                raise AssertionError(f"{label}: {key} graphed {g[key]!r}, eager {e[key]!r}")
        worst = compare_step_tensors(trainer, label, start, results["graphed"],
                                     results["eager"])
        if any(n != [1] * len(kernels) for n in launched.values()):
            raise AssertionError(f"{label}: launches a step {launched}, each kernel once")
        if mesh is not None:
            calls = {kind: {k: v[:2] for k, v in st.items()} for kind, st in stats.items()}
            if not calls["eager"] or calls["graphed"] != calls["eager"]:
                raise AssertionError(f"{label}: collectives' [calls, bytes] graphed "
                                     f"{calls['graphed']}, eager {calls['eager']}")
            walls["collectives"].append(stats)
        log(f"  graphed against eager from the same state: scalars agree; every group's "
            f"gradient (from its first moment) within tolerance, worst max abs err "
            f"{worst['gradient']:.3g} of the group's largest; parameters within one Adam "
            f"step of each other, worst {worst['param_lr']:.3g} lr; statistics agree")
        set_trainer_state(trainer, results["graphed"])
        if after_step is not None:
            after_step(g)
    return walls


class DeviceReads:
    """Counts the reads of the card by the host while it is on: ops that
    copy a CUDA tensor's data to the host (`.tolist()`, `.cpu()`,
    `.item()`, `float()`), by name.  A replayed graph dispatches nothing,
    and copies into the card are not reads."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        reads = self.reads = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                name = str(func)
                src = args[1] if name.startswith("aten.copy_") else (args[0] if args else None)
                dst = args[0] if name.startswith("aten.copy_") else out
                if (getattr(src, "is_cuda", False) and hasattr(dst, "device")
                        and dst.device.type == "cpu") or (
                        name.startswith("aten._local_scalar_dense") and src.is_cuda):
                    reads.append(name)
                return out

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


def round_twins(trainer, label, armed, calls=3, rebalance=False):
    """From one state, the density-control round (or the rebalance) once
    eagerly and `calls` times through its graph (warm-up, capture,
    replays), each from that state with the same draws: every parameter,
    moment and statistic after it, and the report's four counts, equal to
    the bit.  Returns (the report, eager seconds, graphed seconds of each
    call).  Leaves the trainer at the result."""
    import torch

    start = trainer_state(trainer)

    def run(graphed):
        if rebalance:
            trainer._rebalance(graphed)
            return None
        return trainer._densify(armed, graphed=graphed)

    out, eager_s = timed(lambda: run(False))
    want = [x.clone() for x in trainer._step_tensors()]
    want_report = None if out is None else [int(x) for x in out]
    graphed_s = []
    for i in range(calls):
        set_trainer_state(trainer, start)  # the same tensors and draws
        out, dt = timed(lambda: run(True))
        graphed_s.append(dt)
        report = None if out is None else [int(x) for x in out]
        if report != want_report:
            raise AssertionError(f"{label}: report {report} against the eager {want_report}")
        for (kind, name), a, b in zip(step_tensor_kinds(trainer), trainer._step_tensors(), want):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}, graphed call {i}: {kind} {name} differs from "
                                     f"the eager one's")
    cache = trainer._rebalance_graphs if rebalance else trainer._round_graphs
    call = cache.call
    if call.captures != 1 or call.replays < calls - 1:  # one key: captured once
        raise AssertionError(f"{label}: {call.captures} captures, {call.replays} replays")
    log(f"{label}: graphed against eager from one state with the same draws, every "
        f"parameter, moment and statistic equal to the bit"
        + ("" if out is None else f", report (cloned, split, pruned, alive) {want_report} "
           "either way") + f"; eager {eager_s * 1e3:.2f} ms, graphed "
        f"{[round(x * 1e3, 2) for x in graphed_s]} ms (warm-up, capture, replays)")
    return want_report, eager_s, graphed_s


def round_step_window(trainer, label, reps=3):
    """The round's step against its neighbours: from one state, the three
    steps around a densify round (the one before, the round's, the one
    after), graphed (`run_step`, after two runs that warm up and capture
    the round's graph) and eager (`run_step_eager`), alternating, each run
    from that state with the same frames and draws.  Logs the host-clock
    walls (medians of `reps`) and returns them {kind: [before, round,
    after]} in ms.  The densify schedule is put back after."""
    d = trainer.cfg.densify
    keep = dataclasses.replace(d)
    r = trainer.step + 2
    d.enabled, d.start_iter, d.interval, d.stop_iter = True, r, r, r + 1
    d.opacity_reset_interval = 10**9
    d.sh_degree_interval = 1  # the model's SH degree: the step's graph stays
    start = trainer_state(trainer)

    def triplet(run):
        set_trainer_state(trainer, start)
        outs, walls = [], []
        for _ in range(3):
            out, dt = timed(run)
            outs.append(out)
            walls.append(dt * 1e3)
        if "alive" not in outs[1] or any("alive" in o for o in (outs[0], outs[2])):
            raise AssertionError(f"{label}: the round is not the middle step's: {outs}")
        return walls, outs[1]

    try:
        for _ in range(2):  # the round's graph: warm-up, capture
            triplet(trainer.run_step)
        walls = {"graphed": [], "eager": []}
        reports = {}
        for _ in range(reps):
            for kind, run in (("graphed", trainer.run_step), ("eager", trainer.run_step_eager)):
                w, out = triplet(run)
                walls[kind].append(w)
                reports[kind] = out
        set_trainer_state(trainer, start)
    finally:
        for f in dataclasses.fields(d):
            setattr(d, f.name, getattr(keep, f.name))
    med = {k: [float(np.median([w[i] for w in v])) for i in range(3)] for k, v in walls.items()}
    counts = {k: [reports[k][c] for c in ("cloned", "split", "pruned", "alive")]
              for k in reports}
    log(f"{label}, the round's step against its neighbours (ms, medians of {reps}, before / "
        f"round / after): graphed {[round(x, 2) for x in med['graphed']]} (the round's step "
        f"{med['graphed'][1] - (med['graphed'][0] + med['graphed'][2]) / 2:+.2f} ms over its "
        f"neighbours' mean), eager {[round(x, 2) for x in med['eager']]} "
        f"({med['eager'][1] - (med['eager'][0] + med['eager'][2]) / 2:+.2f} ms); reports "
        f"(cloned, split, pruned, alive) {json.dumps(counts)}; walls "
        + json.dumps({k: [[round(x, 2) for x in w] for w in v] for k, v in walls.items()}))
    return med


def noise_draw_ms(trainer, reps=5):
    """Host ms of the round's split-noise draw into the pinned buffer and
    the start of its copy (`SplitNoise.draw`), on a copy of the trainer's
    generator: the part of a graphed round the host does."""
    import torch

    g = torch.Generator().set_state(trainer._adc_generator.get_state())
    walls = [timed(lambda: trainer._noise.draw(g))[1] * 1e3 for _ in range(reps)]
    return float(np.median(walls))


def densify_window(trainer, label, mesh=False):
    """The density-control window: the round graphed against eager from one
    state (`round_twins`), the host's share of a graphed round (the noise
    draw), the round's step against its neighbours (`round_step_window`);
    on one device also the round alone eager against graphed
    (`eager_and_graphed`, profiled); on a mesh the rebalance graphed
    against eager and `evaluate` graphed against eager (the store gathered
    inside the deblurred renders' graphs)."""
    from casualhdrsplat_torch.train import densify as densify_mod

    # screen_prune as the trainer's next round would take it
    armed = trainer._screen_prune_armed or densify_mod.screen_prune_active(
        trainer.step, trainer.cfg.densify)
    report, _, _ = round_twins(trainer, f"{label}: density-control round", armed)
    if report[0] + report[1] <= 0:
        raise AssertionError(f"{label}: the round cloned and split nothing: {report}")
    log(f"{label}: the split noise [2, {trainer._capacity()}, 3] drawn on the host into the "
        f"pinned buffer and its copy started: {noise_draw_ms(trainer):.2f} ms (median of 5)")
    med = round_step_window(trainer, label)
    if mesh:
        round_twins(trainer, f"{label}: rebalance", armed, rebalance=True)
        evaluate_twins(trainer, label)
    else:
        eager_and_graphed(f"{label}: density-control round",
                          lambda: trainer._densify(armed, graphed=False),
                          lambda: trainer._densify(armed))
    return med


def evaluate_twins(trainer, label, calls=3):
    """`evaluate()` graphed `calls` times against its eager twin: the
    metrics dict equal to the bit each time."""
    want = trainer.evaluate(graphed=False)
    for i in range(calls):
        got = trainer.evaluate()
        if got != want:
            raise AssertionError(f"{label}: evaluate graphed {got} against eager {want}")
    log(f"{label}: evaluate graphed ({calls} calls) equal to the bit to its eager twin: "
        + json.dumps(want))
    return want


def eval_window(trainer, label):
    """`evaluate()` graphed against its eager twin on one trainer: the
    metrics equal to the bit; B1's and T1's launches and the host's reads
    of the card per evaluated frame, either way; walls (host-clock
    medians of 3, alternating) and busy shares (`eager_and_graphed`).
    Returns B1's launches in the window."""
    from casualhdrsplat_torch.ops import crf_fused
    from casualhdrsplat_torch.ops import rasterize_dense as rd
    from casualhdrsplat_torch.ops import rasterize_packed as rp

    frames = len(trainer.dataset.eval_indices) or 2
    b1 = rp.FWD_KERNEL if trainer.cfg.model.rasterize.packed else rd.FWD_KERNEL
    kernels = (b1, crf_fused.FWD_KERNEL)
    b1_start = b1.launches
    evaluate_twins(trainer, label)
    per_frame, reads = {}, {}
    for kind, graphed in (("eager", False), ("graphed", True)):
        before = [k.launches for k in kernels]
        with DeviceReads() as dr:
            trainer.evaluate(graphed=graphed)
        per_frame[kind] = [(k.launches - b) / frames for k, b in zip(kernels, before)]
        reads[kind] = len(dr.reads) / frames
        if kind == "graphed":
            read_ops = sorted(set(dr.reads))
    novel = len(trainer.dataset.eval_indices) > 0
    renders = 3 if novel else 2
    if any(n != [renders, renders] for n in per_frame.values()):
        raise AssertionError(f"{label}: launches of B1 and T1 a frame {per_frame}, "
                             f"{renders} each expected")
    if reads["graphed"] * frames != frames + novel:
        raise AssertionError(f"{label}: {reads['graphed'] * frames} host reads in a graphed "
                             f"evaluate of {frames} frames")
    log(f"{label}: {frames} evaluated frames, {renders} renders each; launches a frame "
        f"(B1, T1): eager {per_frame['eager']}, graphed {per_frame['graphed']}; host reads "
        f"of the card a frame: eager {reads['eager']}, graphed {reads['graphed']} ({read_ops}: "
        f"one a frame, and the learned exposures once)")
    eager_and_graphed(label, lambda: trainer.evaluate(graphed=False), trainer.evaluate)
    return b1.launches - b1_start


def run_timed_steps(trainer, steps, kernels, label, after_step=None):
    """`steps` training steps, each graphed and eager from the same state
    (`graph_vs_eager_steps`), with the launch counts of `kernels` zeroed
    just before: checks finite scalars, one launch of each kernel per step
    on either path, finite parameters, every floating group moved, and
    logs the launches a replay of the step's graph counts for every
    kernel; P1 (its forward and its backward) once a step as well, counted
    from where its counters stand (the main path's total runs on).
    Returns the walls, the graphed ones of replays only."""
    import torch

    from casualhdrsplat_torch.ops import projection_fused as pf
    from casualhdrsplat_torch.train import optim

    m = trainer.cfg.model
    before = {path: leaf.clone() for path, _, leaf in optim.labelled_leaves(trainer.params)}
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    p1 = (pf.FWD_KERNEL, pf.BWD_KERNEL)
    p1_before = [k.launches for k in p1]
    walls = graph_vs_eager_steps(trainer, steps, tuple(kernels) + p1, label, after_step)
    p1_launched = [k.launches - b for k, b in zip(p1, p1_before)]
    replays = [w for w, r in zip(walls["graphed"], walls["replay"]) if r]
    walls["graphed"] = replays or walls["graphed"]
    pix = SIZE * SIZE * m.num_virtual_views
    for kind in ("graphed", "eager"):
        med = float(np.median(walls[kind]))
        log(f"{label}, {kind}: step median {med * 1e3:.2f} ms = {pix / med / 1e6:.2f} Mpix/s "
            f"fwd+bwd ({SIZE}x{SIZE} x {m.num_virtual_views} views per step)")
    log(f"{label}: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (graph "
        f"pool and eager step); launches over {steps} graphed and {steps} eager steps: "
        + ", ".join(f"{k.symbol} {k.launches}" for k in kernels)
        + "".join(f", {k.symbol} {n}" for k, n in zip(p1, p1_launched)))
    call = trainer._step_graphs.call
    log(f"{label}: the step's graph was captured {call.captures} time(s) and replayed "
        f"{call.replays} times; a replay counts " + ", ".join(
            f"{c.symbol} {n}" for c, n in call._rise))
    if any(k.launches != 2 * steps for k in kernels) or p1_launched != [2 * steps] * 2:
        raise AssertionError("each training step must launch each compositor kernel and "
                             "each half of P1 once")
    for path, label_, leaf in optim.labelled_leaves(trainer.params):
        if not bool(torch.isfinite(leaf.float()).all()):
            raise AssertionError(f"parameter {path} holds non-finite values")
        if label_ != "frozen" and torch.equal(leaf, before[path]):
            raise AssertionError(f"parameter {path} did not move in {steps} steps")
    return walls


def train_phase(device, dataset, rp):
    """The packed training path at the full width of ladder4-full: returns
    (launches of B1, of B2 and of G1, the B2 measurement at its shape, T1's
    measurements, G1's, P1's).  G1's index is launched once per G1 launch
    (checked here and in every phase below)."""
    import torch

    from casualhdrsplat_torch import config
    from casualhdrsplat_torch.ops import stream_gather as sg

    cfg = config.PRESETS["ladder4"]()
    # Density control off: without its SH warm-up the run has all 16
    # coefficients from step 0 (the dense phase trains with it on).  The
    # preset's own max_steps stays, so every learning rate is the one a run
    # starts with.
    cfg.densify.enabled = False
    cfg.eval_every = 0
    cfg.data.eval_every = 0
    m = cfg.model
    trainer, t_init, t_knn = timed_trainer(cfg, dataset, device)
    alive = int(trainer.params["gaussians"]["alive"].sum())
    log(f"trainer: {alive} of {m.max_gaussians} Gaussians alive, SH degree "
        f"{trainer.active_sh_degree()}, {m.num_virtual_views} virtual views, shared binning "
        f"{cfg.model.rasterize.shared_binning}; set-up {t_init:.2f} s, of which the k-NN "
        f"{t_knn:.2f} s")
    if alive != m.max_gaussians or trainer.active_sh_degree() != m.sh_degree:
        raise AssertionError("the trainer does not run at the model's full width")

    _, t_warm = timed(trainer.run_step)
    log(f"warm-up step (the graph's, eager): {t_warm:.3f} s")
    count_before = int(trainer.adc.count.sum())
    run_timed_steps(trainer, TRAIN_STEPS, (rp.FWD_KERNEL, rp.BWD_KERNEL, sg.KERNEL, sg.INDEX),
                    "packed training")
    if int(trainer.adc.count.sum()) <= count_before:
        raise AssertionError("the density-control visibility counts did not rise")
    run_to_run(trainer, "packed training")
    eager_and_graphed("packed training step", trainer.run_step_eager, trainer.run_step)
    launches = rp.FWD_KERNEL.launches, rp.BWD_KERNEL.launches, sg.KERNEL.launches
    if sg.INDEX.launches != sg.KERNEL.launches:
        raise AssertionError(f"packed training: G1 {sg.KERNEL.launches} launches, its index "
                             f"{sg.INDEX.launches}")
    INDEX_LAUNCHES["packed training"] = sg.INDEX.launches

    # kernels B2, G1 and T1 on the inputs a training step gives them
    frame = int(trainer.dataset.train_indices[1])
    (bwd_call,), (g1_call,) = capture_backwards(lambda: trainer.loss_and_grads(frame))
    res = measure_backward("train_step", bwd_call, reps=10)
    with torch.no_grad():
        measure_compositor("train_step_forward", bwd_call[:3] + bwd_call[6:], 1, reps=10)
    del bwd_call
    g1 = measure_g1("train_step", g1_call, reps=10)
    del g1_call
    t1 = measure_crf_step("train_step", lambda: trainer.loss_and_grads(frame))
    p1 = measure_projection("train_step", capture_project(
        lambda: trainer.loss_and_grads(frame))[0], reps=20)
    return (*launches, res, t1, g1, p1)


def ladder5_phase(device, rp):
    """ladder5-pod at its own size on one card (its (4, 2) mesh cut to (1, 1)):
    a synthetic video of 3,145,728 Gaussians, ladder4's recipe with the
    scales divided by 24^(1/3), and a Trainer on PRESETS["ladder5"] with
    density control off.  The trainer's start-up k-NN takes the host grid
    route (ops/knn.py), its seconds printed.  Two steps warm up and capture
    the step's graph; then one step is run twice from the same state, a
    replay of the graph and `run_step_eager`: every scalar and every tensor
    of the step equal to the bit (a packed step is deterministic), B1, B2,
    G1 and its index once each way.  Then B1, B2 and G1 against their plain
    versions on the inputs a step gives them: B1 and B2 on the last view's
    rows (`last_view_rows`), G1 on the whole gradient of the stream.  Then
    the grid k-NN against the brute force on the card on 262,144 of the
    cloud's points, within rtol 1e-5.  Returns (launches of B1, of B2 and
    of G1, and {kernel: its measurement here})."""
    import torch

    from casualhdrsplat_torch import config
    from casualhdrsplat_torch.data import dataset as dataset_mod
    from casualhdrsplat_torch.ops import knn
    from casualhdrsplat_torch.ops import stream_gather as sg

    cfg = config.PRESETS["ladder5"]()
    cfg.parallel.data = cfg.parallel.gauss = 1
    cfg.densify.enabled = False
    cfg.eval_every = 0
    cfg.data.eval_every = 0
    m = cfg.model
    cut = 24.0 ** (1.0 / 3.0)
    dataset, t_data = timed(lambda: dataset_mod.make_synthetic_dataset(
        seed=SEED, device=device, renderer="fast", n_gaussians=m.max_gaussians,
        n_frames=N_FRAMES, n_virtual=m.num_virtual_views, size=SIZE,
        scale_range=(0.004 / cut, 0.02 / cut), angle_span=0.12, exposure_range=(0.4, 0.8)))
    log(f"ladder5: {dataset.images.shape[0]} frames of {SIZE}x{SIZE} rendered from "
        f"{len(dataset.points_xyz)} Gaussians in {t_data:.2f} s")
    trainer, t_init, t_knn = timed_trainer(cfg, dataset, device)
    last = knn.LAST
    alive = int(trainer.params["gaussians"]["alive"].sum())
    log(f"ladder5 trainer: {alive} of {m.max_gaussians} Gaussians alive, shared binning "
        f"{trainer.cfg.model.rasterize.shared_binning}; set-up {t_init:.2f} s, of which the "
        f"k-NN {t_knn:.2f} s searching and copying ({last.route} route, {last.points} "
        "points)")
    if last.route != "grid" or last.points != m.max_gaussians or alive != m.max_gaussians:
        raise AssertionError("ladder5: the trainer's k-NN did not take the grid route at the "
                             "store's size")
    if not trainer.cfg.model.rasterize.shared_binning:
        raise AssertionError("ladder5: the start-up guard left shared binning")
    for _ in range(2):  # the graph's warm-up and its capture
        trainer.run_step()
    kernels = (rp.FWD_KERNEL, rp.BWD_KERNEL, sg.KERNEL, sg.INDEX)
    for k in kernels:
        k.launches = 0
    call = trainer._step_graphs.call
    replays = call.replays
    start = trainer_state(trainer)
    graphed_out, t_graphed = timed(trainer.run_step)
    graphed = trainer_state(trainer)
    set_trainer_state(trainer, start)
    eager_out, t_eager = timed(trainer.run_step_eager)
    eager = trainer_state(trainer)
    log(f"ladder5 step {trainer.step}: graphed {t_graphed * 1e3:.2f} ms, eager "
        f"{t_eager * 1e3:.2f} ms, " + ", ".join(f"{k} {v:.6g}" for k, v in graphed_out.items())
        + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if trainer._step_graphs.call is not call or call.replays != replays + 1:
        raise AssertionError("ladder5: the graphed step was not a replay")
    if graphed_out != eager_out:
        raise AssertionError(f"ladder5: graphed step {graphed_out}, eager {eager_out}")
    differ = [f"{kind} {name}" for (kind, name), a, b in zip(
        step_tensor_kinds(trainer), graphed["tensors"], eager["tensors"])
        if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"ladder5: graphed and eager steps differ in {differ}")
    launches = tuple(k.launches for k in kernels)
    if launches != (2, 2, 2, 2):
        raise AssertionError(f"ladder5: B1, B2, G1 and its index once a step, got {launches}")
    INDEX_LAUNCHES["ladder5"] = launches[3]
    log("ladder5: the graphed step equals the eager step to the bit (every scalar and "
        f"tensor); launches B1, B2, G1, index {launches}")
    del start, graphed, eager

    # B1, B2 and G1 on the inputs a step gives them
    frame = int(trainer.dataset.train_indices[1])
    (bwd_call,), (g1_call,) = capture_backwards(lambda: trainer.loss_and_grads(frame))
    # the step's graph and its pool (~26 GiB) go with the trainer
    del trainer, call
    gc.collect()
    torch.cuda.empty_cache()
    log(f"ladder5: {torch.cuda.memory_allocated() / 2**30:.2f} GiB held by the captured calls "
        f"and the video, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    measured = {"G1": measure_g1("ladder5_step", g1_call, reps=3)}
    del g1_call
    bwd_call = last_view_rows(bwd_call)
    measured["B2"] = measure_backward("ladder5_step_last_view", bwd_call, reps=3)
    with torch.no_grad():
        measured["B1"] = measure_compositor("ladder5_step_last_view_forward",
                                            bwd_call[:3] + bwd_call[6:], 1, reps=3)
    del bwd_call
    torch.cuda.empty_cache()

    sub = np.ascontiguousarray(dataset.points_xyz[: 1 << 18])
    grid, t_grid = timed(lambda: knn.knn_mean_dist(sub, 3, device=device))
    brute, t_brute = timed(lambda: knn.knn_mean_dist_brute(sub, 3, 2048, device))
    rel = float(((grid - brute).abs() / brute).max())
    log(f"ladder5 k-NN on {len(sub)} points: grid {t_grid:.3f} s, brute force on the card "
        f"{t_brute:.3f} s, largest relative difference {rel:.3g}")
    if not rel <= 1e-5:
        raise AssertionError(f"ladder5: the grid k-NN is {rel} from the brute force")
    return (*launches[:3], measured)


def last_view_rows(call):
    """B2's captured call (stream, row_lo, row_hi, order, out4, g4, statics)
    with every row but the last view's emptied (lo = hi = 0, the order
    taken anew), so that the plain versions walk one view of the whole
    stream; raises unless some of that view's segments end past 2^31
    floats of the stream, the offsets a 32-bit index would get wrong."""
    import torch

    from casualhdrsplat_torch.ops import rasterize_packed as rp

    stream, lo, hi, _, out4, g4, statics = call
    per_view = statics.tiles_per_view or statics.ntx * statics.nty
    rows = torch.arange(lo.shape[0], device=lo.device)
    keep = rows // per_view == statics.num_views - 1
    lo = torch.where(keep, lo, torch.zeros_like(lo))
    hi = torch.where(keep, hi, torch.zeros_like(hi))
    width = stream.shape[1]
    past = int((hi.long() * width > 2**31).sum())
    log(f"ladder5 last view: rows {int(keep.sum())} of {lo.shape[0]}, {past} of them end past "
        f"2^31 floats of the stream ({stream.numel()} floats; slots "
        f"{int(lo[keep].min())}-{int(hi.max())})")
    if not past:
        raise AssertionError("ladder5: no segment of the last view passes 2^31 floats")
    return stream, lo, hi, rp.row_order(lo, hi), out4, g4, statics


def graphed_serving(params, scene, cfg, pose_vms, angles, exposure, eager_out):
    """The serving requests again through image_formation.GraphedRenders
    (the viewer's, the command line's and entry()'s path: CUDA graphs, one
    per mode, the first call of each an eager warm-up, the second its
    capture): the 3 blurred frames and the 6 LDR and HDR views, each equal
    to the eager request's output to the bit, then 3 depth views against
    the eager ones.  Logs the walls and the launches a replay of each graph
    counts.  Returns the GraphedRenders."""
    import torch

    from casualhdrsplat_torch.models import image_formation as imf

    renders = imf.GraphedRenders()
    walls = {"render_frame": [], "render_pose": []}
    with torch.inference_mode():
        for fid in range(3):
            out, dt = timed(lambda: renders.render_frame_blurred(params, scene, fid, cfg))
            walls["render_frame"].append(dt * 1e3)
            if not torch.equal(out, eager_out[fid]):
                raise AssertionError(f"graphed render_frame({fid}) differs from the eager one")
        for hdr in (False, True):
            for a, vm in zip(angles, pose_vms):
                (img, _, _), dt = timed(lambda: renders.render_pose(
                    params, scene, vm, cfg, exposure=exposure, hdr_output=hdr))
                walls["render_pose"].append(dt * 1e3)
                if not torch.equal(img, eager_out[a, hdr]):
                    raise AssertionError(f"graphed render_pose(angle={a}, hdr={hdr}) differs "
                                         f"from the eager one")
        for vm in pose_vms:
            got = renders.render_pose(params, scene, vm, cfg, depth_output=True)
            want = imf.render_pose(params, scene, vm, cfg, depth_output=True)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError("graphed depth render differs from the eager one")
    log("graphed serving: every request equal to the eager one to the bit; walls in ms "
        "(warm-up, capture, replays): " + json.dumps(
            {k: [round(w, 2) for w in v] for k, v in walls.items()}))
    for key, cache in renders._graphs.items():
        log(f"  graph {key}: captured {cache.call.captures}, replayed {cache.call.replays}; "
            f"a replay counts " + ", ".join(f"{c.symbol} {n}" for c, n in cache.call._rise))
    return renders


def dense_model_cfg(cfg):
    """`cfg` (a ModelConfig) with the dense rasterizer at full width."""
    from casualhdrsplat_torch.config import RasterizeConfig

    return dataclasses.replace(cfg, rasterize=RasterizeConfig(**DENSE_RASTER))


def dense_serving_phase(device, cfg, scene, params, pose_vms, exposure, rd):
    """Dense serving at full width: returns (launches of B3, its
    measurement at the render_frame shape)."""
    import torch

    from casualhdrsplat_torch.models import image_formation as imf

    dense = dense_model_cfg(cfg)
    r = dense.rasterize
    log(f"dense serving: tiles {r.tile_h}x{r.tile_w}, capacity {r.tile_capacity}, chunk "
        f"{r.chunk}, {cfg.num_virtual_views} x {(SIZE // r.tile_h) * (SIZE // r.tile_w)} "
        f"tiles a frame")
    with torch.inference_mode():
        _, t_warm = timed(lambda: (imf.render_frame(params, scene, 0, dense),
                                   imf.render_pose(params, scene, pose_vms[0], dense)))
        log(f"dense warm-up requests: {t_warm:.3f} s")
        torch.cuda.reset_peak_memory_stats()
        rd.FWD_KERNEL.launches = 0
        frame_s, pose_s = [], []
        for fid in (1, 2):
            out, dt = timed(lambda: imf.render_frame(params, scene, fid, dense))
            frame_s.append(dt)
            check_image(f"dense frame {fid} blurred", out.blurred_ldr, (SIZE, SIZE, 3), 0.0, 1.0)
            check_image(f"dense frame {fid} hdr", out.sharp_hdr,
                        (cfg.num_virtual_views, SIZE, SIZE, 3), 0.0)
            log(f"dense render_frame({fid}): {dt * 1e3:.2f} ms, dropped by the tile "
                f"capacity {int(out.aux.num_dropped)}, clipped {int(out.aux.num_clipped)}, "
                f"coverage {float((out.alphas > 0.5).float().mean()):.3f}")
        for vm, hdr in ((pose_vms[0], False), (pose_vms[2], True)):
            (img, alpha, aux), dt = timed(
                lambda: imf.render_pose(params, scene, vm, dense, exposure=exposure,
                                        hdr_output=hdr))
            pose_s.append(dt)
            check_image(f"dense pose {'hdr' if hdr else 'ldr'}", img, (SIZE, SIZE, 3), 0.0,
                        None if hdr else 1.0)
            log(f"dense render_pose(hdr={hdr}): {dt * 1e3:.2f} ms, dropped "
                f"{int(aux.num_dropped)}")
        launches = rd.FWD_KERNEL.launches
        log(f"dense serving: render_frame median {np.median(frame_s) * 1e3:.2f} ms, "
            f"render_pose median {np.median(pose_s) * 1e3:.2f} ms, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches of "
            f"{rd.FWD_KERNEL.symbol}: {launches} over 2 render_frame + 2 render_pose")
        if launches != 4:
            raise AssertionError("each dense request must launch the dense forward kernel once")

        # kernel B3 on the inputs the requests give it
        frame_call, = capture_calls(
            rd, "forward", lambda: imf.render_frame(params, scene, 1, dense))
        res = measure_dense_forward("dense_render_frame", frame_call, 1, reps=20)
        del frame_call
        pose_call, = capture_calls(
            rd, "forward",
            lambda: imf.render_pose(params, scene, pose_vms[1], dense, exposure=exposure))
        measure_dense_forward("dense_render_pose", pose_call, 1, reps=20)
        del pose_call

        # dense against packed on the same 16x16 tiles, per-view binning on
        # both, on a part of the model small enough that neither path drops
        # anything: the same per-tile lists in the same order.  The two stop
        # a saturated tile at different boundaries (chunks of its list; the
        # stream's G-aligned windows), each within transmittance_eps of the
        # full sum, so a pixel differs by at most 2 eps x the largest colour.
        part = dict(params, gaussians={k: v[:16_384] for k, v in params["gaussians"].items()})
        packed = dataclasses.replace(cfg, rasterize=dataclasses.replace(
            cfg.rasterize, tile_w=16, shared_binning=False))
        a = imf.render_frame(part, scene, 1, dense)
        b = imf.render_frame(part, scene, 1, packed)
        dropped = int(a.aux.num_dropped) + int(b.aux.num_dropped)
        tol = 2.0 * r.transmittance_eps * max(1.0, float(b.sharp_hdr.max()))
        err = float((a.sharp_hdr - b.sharp_hdr).abs().max())
        log(f"dense vs packed frame, 16,384 Gaussians on 16x16 tiles: dropped {dropped}, max "
            f"abs err {err:.3g} on HDR values up to {float(b.sharp_hdr.max()):.3f} "
            f"(tolerance {tol:.3g} = 2 x transmittance_eps x the largest colour)")
        if dropped != 0 or err > tol:
            raise AssertionError("the dense frame disagrees with the packed frame")
        if "--profile" in sys.argv[1:]:
            profile_window("dense_render_frame",
                           lambda: imf.render_frame(params, scene, 1, dense))
            profile_window("dense_render_pose", lambda: imf.render_pose(
                params, scene, pose_vms[1], dense, exposure=exposure))
    return launches, res


def dense_train_phase(device, dataset, rd):
    """The dense training path at the full width of ladder4-full, density
    control on: returns (launches of B3, launches of B4, the B4 measurement
    at its shape)."""
    import torch

    from casualhdrsplat_torch import config
    from casualhdrsplat_torch.models import gaussians as gauss_mod

    cfg = config.PRESETS["ladder4"]()
    cfg.model = dense_model_cfg(cfg.model)
    cfg.eval_every = 0
    cfg.data.eval_every = 0
    d = cfg.densify
    d.sh_degree_interval = 1  # SH degree 3 from step 3 on
    d.start_iter, d.interval = DENSE_DENSIFY_STEP, DENSE_DENSIFY_STEP
    d.opacity_reset_interval = DENSE_RESET_STEP
    d.grad_threshold = DENSE_GRAD_THRESHOLD
    m = cfg.model
    # a store with free slots: the trainer starts from part of the cloud
    dataset = dataclasses.replace(dataset, points_xyz=dataset.points_xyz[:DENSE_TRAIN_POINTS],
                                  points_rgb=dataset.points_rgb[:DENSE_TRAIN_POINTS])
    trainer, t_init, t_knn = timed_trainer(cfg, dataset, device)
    alive = int(trainer.params["gaussians"]["alive"].sum())
    log(f"dense trainer: {alive} of {m.max_gaussians} Gaussians alive, density control on, "
        f"tiles {m.rasterize.tile_h}x{m.rasterize.tile_w}, capacity "
        f"{m.rasterize.tile_capacity}; set-up {t_init:.2f} s, of which the k-NN "
        f"{t_knn:.2f} s")
    for _ in range(DENSE_WARMUP_STEPS):
        out, dt = timed(trainer.run_step)
        log(f"dense warm-up step {trainer.step}: {dt:.3f} s, loss {out['loss']:.5f}")
    if trainer.active_sh_degree() != m.sh_degree:
        raise AssertionError("the dense trainer does not run at the model's SH degree")

    reports, before = [], {}

    def snapshot():
        """What the next step's round, if one is due, will see."""
        g = trainer.params["gaussians"]
        avg = (trainer.adc.grad_accum / trainer.adc.count.clamp(min=1))[g["alive"]]
        before["avg_grad"] = torch.quantile(
            avg, torch.tensor([0.5, 0.9], device=device)).tolist()
        before["alive"] = g["alive"].clone()

    def after_step(out):
        g = trainer.params["gaussians"]
        if "alive" in out:
            log(f"  densify round at step {trainer.step}: cloned {out['cloned']}, split "
                f"{out['split']}, pruned {out['pruned']}, alive {out['alive']}; average "
                f"screen gradient before it: median {before['avg_grad'][0]:.3g}, 90th "
                f"percentile {before['avg_grad'][1]:.3g} (threshold {d.grad_threshold})")
            new = g["alive"] & ~before["alive"]
            granted = out["cloned"] + out["split"]
            if granted <= 0:
                raise AssertionError("the densify round cloned and split nothing")
            if out["alive"] != alive + granted - out["pruned"] or int(new.sum()) != granted:
                raise AssertionError("`alive` did not rise by what the round granted")
            for moment in ("mu", "nu"):
                for name, leaf in trainer.opt_state[moment]["gaussians"].items():
                    if float(leaf[new].abs().max()) != 0.0:
                        raise AssertionError(f"{moment} of {name} is not zero at the new slots")
            if int(trainer.adc.count.sum()) != 0:
                raise AssertionError("the round did not start the statistics over")
            reports.append(out)
        if trainer.step == DENSE_RESET_STEP:
            top = float(torch.sigmoid(g["opacity_logit"]).max())
            log(f"  opacity reset at step {trainer.step}: largest opacity {top:.4f}")
            if top > 0.01 + 1e-6:
                raise AssertionError("the opacity reset did not clamp the opacities")
        snapshot()

    snapshot()
    run_timed_steps(trainer, TRAIN_STEPS, (rd.FWD_KERNEL, rd.BWD_KERNEL), "dense training",
                    after_step)
    if len(reports) != 1 or trainer.step < DENSE_RESET_STEP:
        raise AssertionError("the timed steps must cross one densify round and one reset")
    densify_window(trainer, "dense trainer")
    d.enabled = False  # the windows below time steps, not rounds (SH stays at 3)
    eager_and_graphed("dense training step", trainer.run_step_eager, trainer.run_step)
    fwd_launches, bwd_launches = rd.FWD_KERNEL.launches, rd.BWD_KERNEL.launches

    # kernels B3 and B4 on the inputs a dense training step gives them
    frame = int(trainer.dataset.train_indices[1])
    bwd_call, = capture_calls(rd, "backward", lambda: trainer.loss_and_grads(frame))
    res = measure_dense_backward("dense_train_step", bwd_call, reps=10)
    with torch.no_grad():
        measure_dense_forward("dense_train_step_forward", bwd_call[:3] + bwd_call[5:], 1,
                              reps=10)
    del bwd_call
    return fwd_launches, bwd_launches, res


def small_dense_train_check(device):
    """A dense training step, a densify round and the step after it on the
    card (kernels B3 and B4) against the same on the CPU (the plain
    versions), at 64x64: the first step's gradients for every parameter
    group and the means2d tap, then the round's report, the store's `alive`
    mask and the next step's loss.  The round's threshold is put into the
    widest gap of the CPU's average gradients, so that the card's float
    atomics cannot move a Gaussian across it."""
    import torch

    from casualhdrsplat_torch import config
    from casualhdrsplat_torch.data import dataset as dataset_mod
    from casualhdrsplat_torch.train import optim
    from casualhdrsplat_torch.train.trainer import Trainer

    cfg = config.TrainConfig()
    cfg.model = config.ModelConfig(
        max_gaussians=384, sh_degree=2, num_virtual_views=3,
        crf=config.CRFConfig(hidden=8),
        rasterize=config.RasterizeConfig(packed=False, tile_h=8, tile_w=16, chunk=32,
                                         tile_capacity=384),
    )
    cfg.densify.start_iter = cfg.densify.interval = 3  # the round follows step 3
    cfg.densify.sh_degree_interval = 1
    cfg.data.eval_every = 0
    ds = dataset_mod.make_synthetic_dataset(
        seed=SEED + 2, device="cpu", n_gaussians=300, n_frames=3, n_virtual=3, size=64,
        angle_span=0.2, raster_cfg=cfg.model.rasterize)
    # anisotropic, rotated, visibly opaque splats, as in the packed check
    rng = np.random.default_rng(SEED + 3)
    bump = {"log_scales": rng.normal(0, 0.3, size=(384, 3)), "quats": rng.normal(0, 0.3, (384, 4)),
            "opacity_logit": np.full(384, 3.0)}
    trainers, results = [], []
    for dev in ("cpu", device):
        trainer = Trainer(cfg, ds, device=dev)
        for name, delta in bump.items():
            trainer.params["gaussians"][name] += torch.as_tensor(
                delta.astype(np.float32), device=dev)
        loss, aux, grads, g2d = trainer.loss_and_grads(1, sh_degree=2)
        flat = {"/".join(path): optim.tree_get(grads, path).cpu()
                for path, label, _ in optim.labelled_leaves(trainer.params)
                if label != "frozen"}
        flat["means2d_offset"] = g2d.cpu()
        results.append((float(loss), int(aux["num_dropped"]), flat))
        trainers.append(trainer)
    (loss_cpu, dropped_cpu, cpu), (loss_card, dropped_card, card) = results
    if abs(loss_card - loss_cpu) > ATOL or dropped_card != dropped_cpu:
        raise AssertionError(f"dense training loss on the card {loss_card} vs CPU {loss_cpu}")
    worst = max(grads_close(f"small dense step, card vs CPU, {name}", card[name], cpu[name])
                / float(cpu[name].abs().max()) for name in cpu)
    for t in trainers:
        t.run_step(), t.run_step()
    # a threshold no rounding can cross: the middle of the widest gap among
    # the middle half of the CPU's sorted average gradients (both trainers
    # read the one config object)
    adc = trainers[0].adc
    avg = torch.sort((adc.grad_accum / adc.count.clamp(min=1))[:300]).values
    k = int(torch.argmax(avg[76:225] - avg[75:224]))
    cfg.densify.grad_threshold = float(0.5 * (avg[75 + k] + avg[76 + k]))
    rounds = [t.run_step() for t in trainers]
    after = [t.run_step() for t in trainers]
    keys = ("cloned", "split", "pruned", "alive")
    if (any(rounds[0].get(k) != rounds[1].get(k) for k in keys)
            or rounds[0].get("cloned", 0) + rounds[0].get("split", 0) <= 0):
        raise AssertionError(f"dense densify round, card vs CPU: {rounds}")
    if not torch.equal(trainers[0].params["gaussians"]["alive"],
                       trainers[1].params["gaussians"]["alive"].cpu()):
        raise AssertionError("the densify round granted other slots on the card")
    if abs(after[0]["loss"] - after[1]["loss"]) > 1e-3:
        raise AssertionError(f"the step after the round: {after}")
    log(f"small dense training, card vs CPU: loss {loss_card:.6f} vs {loss_cpu:.6f}, "
        f"{len(cpu)} gradient groups agree, worst max abs err {worst:.3g} of the group's "
        f"largest gradient; densify round cloned {rounds[0]['cloned']}, split "
        f"{rounds[0]['split']}, pruned {rounds[0]['pruned']}, alive {rounds[0]['alive']} on "
        f"both, the same slots; the step after it: loss {after[1]['loss']:.6f} vs "
        f"{after[0]['loss']:.6f}")


def write_colmap_capture(dataset, root):
    """`dataset` as a COLMAP capture in text form under `root`: one PINHOLE
    camera, each frame's world-to-camera pose as (qvec, tvec), the cloud's
    points with 8-bit colours in sparse/0/, and the frames as 8-bit PNGs
    in images/frame_000i.png."""
    import torch
    from PIL import Image

    from casualhdrsplat_torch.geometry import lie

    model = os.path.join(root, "sparse", "0")
    os.makedirs(model)
    os.makedirs(os.path.join(root, "images"))
    with open(os.path.join(model, "cameras.txt"), "w") as f:
        f.write(f"1 PINHOLE {dataset.width} {dataset.height} {dataset.fx!r} {dataset.fy!r} "
                f"{dataset.cx!r} {dataset.cy!r}\n")
    vms = dataset.viewmats.astype(np.float64)
    qvecs = lie.rotmat_to_quat(torch.as_tensor(vms[:, :3, :3])).numpy()
    with open(os.path.join(model, "images.txt"), "w") as f:
        for i, (q, t) in enumerate(zip(qvecs, vms[:, :3, 3])):
            f.write(f"{i + 1} " + " ".join(repr(float(v)) for v in (*q, *t))
                    + f" 1 frame_{i:04d}.png\n0.0 0.0 -1\n")
    n = len(dataset.points_xyz)
    rgb = np.round(np.clip(dataset.points_rgb, 0.0, 1.0) * 255.0)
    np.savetxt(os.path.join(model, "points3D.txt"),
               np.column_stack([np.arange(1, n + 1), dataset.points_xyz, rgb, np.zeros(n)]),
               fmt=["%d", "%.9g", "%.9g", "%.9g", "%d", "%d", "%d", "%.1f"])
    for i, img in enumerate(dataset.images):
        Image.fromarray(np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)).save(
            os.path.join(root, "images", f"frame_{i:04d}.png"))


class CallTimer:
    """Times every call of `module.<name>` (host clock, synchronised on
    both sides) while installed; `samples` holds the seconds."""

    def __init__(self, module, name):
        self.module, self.name, self.samples = module, name, []
        self.original = getattr(module, name)

    def __enter__(self):
        def timed_call(*args, **kw):
            out, dt = timed(lambda: self.original(*args, **kw))
            self.samples.append(dt)
            return out

        setattr(self.module, self.name, timed_call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.original)


def cli_phase(device, dataset, rp):
    """The command line at full width on a COLMAP capture of the training
    video, then the viewer and both pose aligners on the trained scene:
    returns (launches of B1, of B2 and of G1, G1's measurement on an aligner
    step)."""
    from casualhdrsplat_torch import cli
    from casualhdrsplat_torch import config
    from casualhdrsplat_torch.data import dataset as dataset_mod
    from casualhdrsplat_torch.models import image_formation as imf
    from casualhdrsplat_torch.ops import stream_gather as sg
    from casualhdrsplat_torch.train import checkpoint as ckpt
    from casualhdrsplat_torch.train import trainer as trainer_mod

    kernels = (rp.FWD_KERNEL, rp.BWD_KERNEL, sg.KERNEL, sg.INDEX)
    total = np.zeros(4, np.int64)

    def count(fn):
        """(fn(), the launches of B1 and B2 during it), which also add to
        the phase's total with G1's; every packed backward launches G1 and
        its index once, so they must count what B2 counts."""
        for k in kernels:
            k.launches = 0
        out = fn()
        n = tuple(k.launches for k in kernels)
        total[:] += n
        if not n[1] == n[2] == n[3]:
            raise AssertionError(f"G1 and its index once per packed backward: B2 {n[1]}, "
                                 f"G1 {n[2]}, index {n[3]}")
        return out, n[:2]

    with tempfile.TemporaryDirectory() as tmp:
        capture = os.path.join(tmp, "capture")
        write_colmap_capture(dataset, capture)
        loaded, t_load = timed(lambda: dataset_mod.load_dataset(
            config.DataConfig(source="colmap", path=capture), device=device))
        log(f"COLMAP capture: {loaded.images.shape[0]} frames of {loaded.width}x{loaded.height}, "
            f"{len(loaded.points_xyz)} points; load_dataset {t_load:.2f} s")
        if (loaded.images.shape != dataset.images.shape
                or len(loaded.points_xyz) != len(dataset.points_xyz)
                or float(np.abs(loaded.images - dataset.images).max()) > 0.5 / 255 + 1e-6
                or float(np.abs(loaded.viewmats - dataset.viewmats).max()) > 1e-5):
            raise AssertionError("the capture does not read back as the video it was written from")

        out = os.path.join(tmp, "out")
        overrides = ["data.source=colmap", f"data.path={capture}", "densify.enabled=false",
                     "checkpoint_every=3", "log_every=3", "eval_every=6", f"out_dir={out}"]
        saves = CallTimer(trainer_mod.Trainer, "save")
        with saves:
            last, (b1, b2) = count(lambda: cli.main(
                ["train", "--preset", "ladder4", "--device", "cuda", *overrides,
                 "optim.max_steps=6"]))
        root = os.path.join(out, config.PRESETS["ladder4"]().name)
        step3, step6 = (os.path.join(root, f"step_{n}") for n in (3, 6))
        size = sum(os.path.getsize(os.path.join(step6, f)) for f in os.listdir(step6))
        log(f"cli train: 6 steps, final {json.dumps(last)}; launches B1 {b1} (6 steps + 1 eval "
            f"render), B2 {b2}; checkpoint saves {[round(x, 3) for x in saves.samples]} s, "
            f"{size / 2**20:.1f} MiB each")
        if b1 != 7 or b2 != 6:
            raise AssertionError("cli train: B1 once a step and once per eval render, B2 once a step")
        if sorted(os.listdir(root)) != ["config.json", "metrics.jsonl", "step_3", "step_6"]:
            raise AssertionError(f"cli train wrote {sorted(os.listdir(root))}")

        # steps 4-6 again from step_3 in a trainer of this process, with the
        # config of the run (the resumed run below rewrites config.json)
        with open(os.path.join(root, "config.json")) as f:
            cfg = config.from_dict(json.load(f))
        trainer = trainer_mod.Trainer(cfg, device=device)
        _, t_restore = timed(lambda: trainer.load(step3))
        for _ in range(3):
            again = trainer.run_step()
        with open(os.path.join(root, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        ref_scalars = next(r for r in logged if r["step"] == 6 and "loss" in r)
        ref = ckpt.restore(step6, map_location=device)["params"]
        resume_check(trainer, ref, again, ref_scalars, t_restore)
        del ref

        _, (b1, b2) = count(lambda: cli.main(
            ["train", "--resume", "--preset", "ladder4", "--device", "cuda", *overrides,
             "optim.max_steps=8"]))
        if ckpt.restore(ckpt.latest_step_dir(root), map_location="cpu")["step"] != 8 or b2 != 2:
            raise AssertionError("cli train --resume did not continue from step 6 to step 8")
        log(f"cli train --resume: steps 7-8 from step_6, launches B1 {b1}, B2 {b2}")

        evals, (b1, _) = count(lambda: cli.main(
            ["eval", "--device", "cuda", "--checkpoint", step6]))
        log(f"cli eval: {json.dumps(evals)}; launches B1 {b1}")
        if (sorted(evals) != ["eval_ms_ssim", "eval_psnr", "eval_ssim"]
                or not all(np.isfinite(v) for v in evals.values()) or b1 != 1):
            raise AssertionError("cli eval: three finite metrics from one render expected")

        renders = os.path.join(tmp, "renders")
        modes = {"deblur": 1, "hdr": 1, "exposure-sweep": 7, "blurred": 1, "depth": 1,
                 "novel": 3}
        for mode, calls in modes.items():
            extra = (["--path-n", "3", "--gif", os.path.join(renders, mode, "path.gif")]
                     if mode == "novel" else [])
            with CallTimer(imf.GraphedRenders, "render_pose") as poses, \
                    CallTimer(imf.GraphedRenders, "render_frame_blurred") as frames:
                _, (b1, _) = count(lambda: cli.main(
                    ["render", "--device", "cuda", "--checkpoint", step6, "--mode", mode,
                     "--frames", "1", "--out", os.path.join(renders, mode), *extra]))
            samples = poses.samples + frames.samples
            files = check_renders(os.path.join(renders, mode), mode)
            log(f"cli render --mode {mode}: {len(samples)} render calls, median "
                f"{np.median(samples) * 1e3:.2f} ms, launches B1 {b1}; wrote {files}")
            if b1 != calls or len(samples) != calls:
                raise AssertionError(f"cli render --mode {mode}: B1 once per render call")

        ply = os.path.join(tmp, "scene.ply")
        cli.main(["export", "--device", "cuda", "--checkpoint", step6, "--out", ply])
        g = ckpt.restore(step6, map_location="cpu")["params"]["gaussians"]
        alive = g["alive"].numpy()
        back = ckpt.import_ply(ply)
        quats = g["quats"].numpy()[alive]
        quats = quats / np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True), 1e-8)
        for k, want in [(k, g[k].numpy()[alive]) for k in (
                "means", "sh_dc", "sh_rest", "opacity_logit", "log_scales")] + [("quats", quats)]:
            if not np.array_equal(back[k], want):
                raise AssertionError(f"export: {k} differs from the checkpoint's alive rows")
        log(f"cli export: {int(alive.sum())} Gaussians, {os.path.getsize(ply) / 2**20:.1f} MiB, "
            f"equal to the checkpoint's alive rows")

    viewer_phase(trainer, count)
    g1 = aligner_phase(trainer, count, rp)
    log(f"command-line phase launches: B1 {total[0]}, B2 {total[1]}, G1 {total[2]}, its "
        f"index {total[3]}")
    INDEX_LAUNCHES["command line"] = int(total[3])
    return int(total[0]), int(total[1]), int(total[2]), g1


# Resume on the card: the continuation from step_3 and the uninterrupted
# run differ only by what is not deterministic in a packed step: the
# run-to-run log of the training phase (`run_to_run`) shows it, group by
# group (G1, the stream gather's transpose, no longer adds with float
# atomics).  Adam's first steps are about lr x
# sign(gradient): where a gradient cancels to below that rounding an
# element steps the other way, and the runs part by up to 2 lr a step from
# there on.  Held to: the step-6 loss and PSNR within RESUME_RTOL; in every
# parameter group at most RESUME_OUTLIER_SHARE of the elements off by more
# than 0.1 lr, and none by more than RESUME_MAX_LR lr (three such steps),
# each on top of two float32 roundings of the group's largest value.
RESUME_RTOL, RESUME_OUTLIER_SHARE, RESUME_MAX_LR = 1e-4, 1e-2, 6.0


def resume_check(trainer, ref, again, ref_scalars, t_restore):
    import torch

    from casualhdrsplat_torch.train import optim

    report, failed = {}, []
    for path, label, leaf in optim.labelled_leaves(trainer.params):
        want = optim.tree_get(ref, path)
        if label == "frozen":
            if not torch.equal(leaf, want):
                failed.append(path)
            continue
        # the largest learning rate of the group over steps 4-6
        lr = max(trainer.opt.learning_rates(c)[label] for c in range(3, 6))
        diff = (leaf - want).abs()
        # two float32 roundings of the leaf's largest value on top
        floor = 2.4e-7 * float(want.abs().max())
        shares = [int((diff > k * lr + floor).sum()) / diff.numel() for k in (1e-3, 0.1, 1.0)]
        report["/".join(path)] = dict(max_abs=float(diff.max()), lr=lr, shares=shares)
        if shares[1] > RESUME_OUTLIER_SHARE or float(diff.max()) > RESUME_MAX_LR * lr + floor:
            failed.append(path)
    errs = {k: abs(again[k] - ref_scalars[k]) / abs(ref_scalars[k]) for k in ("loss", "psnr")}
    log(f"resume from step_3 (load {t_restore:.3f} s) to step 6 vs the uninterrupted run: "
        f"loss {again['loss']!r} vs {ref_scalars['loss']!r}, psnr {again['psnr']!r} vs "
        f"{ref_scalars['psnr']!r}, relative {json.dumps(errs)}; per group: max abs diff, the "
        f"learning rate, shares of elements off by more than (1e-3, 0.1, 1) lr + two "
        f"roundings: {json.dumps(report)}")
    if failed or max(errs.values()) > RESUME_RTOL:
        raise AssertionError(f"resume: the step-6 state differs ({failed}, {errs})")


def check_renders(out, mode):
    """The files a render mode wrote, each checked: 800x800, finite, in
    range."""
    from PIL import Image

    names = sorted(os.listdir(out))
    for name in names:
        path = os.path.join(out, name)
        if name.endswith(".png"):
            img = np.asarray(Image.open(path))
            if img.shape != (SIZE, SIZE, 3) or img.max() == 0:
                raise AssertionError(f"render {mode}: {name} is {img.shape}, max {img.max()}")
        elif name.endswith(".npy"):
            arr = np.load(path)
            if arr.shape[:2] != (SIZE, SIZE) or not np.isfinite(arr).all() or arr.min() < 0:
                raise AssertionError(f"render {mode}: {name} is not finite and >= 0")
        elif name.endswith(".gif"):
            if Image.open(path).n_frames != 3:
                raise AssertionError(f"render {mode}: {name} does not hold 3 frames")
    if not names:
        raise AssertionError(f"render {mode}: no files")
    return names


def viewer_phase(trainer, count):
    """10 /render.jpg requests at 800x800 against the trained scene."""
    import urllib.request

    from casualhdrsplat_torch.viewer.server import ViewerServer, make_orbit_render_fn

    server = ViewerServer(make_orbit_render_fn(trainer), host="127.0.0.1", port=0).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        if b"viewer" not in urllib.request.urlopen(base + "/", timeout=60).read():
            raise AssertionError("viewer: no page at /")
        urllib.request.urlopen(base + "/render.jpg", timeout=120).read()  # warm-up

        def requests():
            lat = []
            for i in range(10):
                t0 = time.perf_counter()
                jpg = urllib.request.urlopen(
                    f"{base}/render.jpg?angle={0.02 * (i - 5)}&log_exposure={0.1 * (i - 5)}"
                    f"&mode={'hdr' if i % 5 == 4 else 'ldr'}", timeout=120).read()
                lat.append(time.perf_counter() - t0)
                if jpg[:2] != b"\xff\xd8":
                    raise AssertionError("viewer: a reply is not a JPEG")
            return lat

        lat, (b1, _) = count(requests)
    finally:
        server.stop()
    log(f"viewer: 10 /render.jpg requests at {SIZE}x{SIZE}, median "
        f"{np.median(lat) * 1e3:.2f} ms (min {min(lat) * 1e3:.2f}, max {max(lat) * 1e3:.2f}), "
        f"launches B1 {b1}")
    if b1 != 10:
        raise AssertionError("viewer: B1 once per request")


ALIGN_STEPS = 48


def aligner_phase(trainer, count, rp):
    """make_aligner on frame 1's deblurred view with a known 0.5 degree /
    1 cm offset, make_window_realigner on frame 1 and on the last frame
    (whose window repeats the last knot) against their clean renders with
    that offset put into the window's knots, 48 steps each: each graphed
    (a CUDA graph of one descent step: the first call warms up, captures
    and replays, a second call only replays) and eagerly (`.eager`, the
    loop of autograd steps) on the same inputs, the results held together
    (`twins_close`); then B1, B2 and G1 against their plain versions on
    one aligner step's inputs (the per-view packed branch's backward).
    Returns G1's measurement."""
    import torch

    from casualhdrsplat_torch.geometry import lie
    from casualhdrsplat_torch.models import image_formation as imf
    from casualhdrsplat_torch.train import pose_align

    m, p, scene = trainer.cfg.model, trainer.params, trainer.scene
    dev = scene.timestamps.device
    axis = torch.tensor([1.0, -1.0, 1.0], device=dev) / np.sqrt(3.0)
    xi = torch.cat([axis * np.radians(0.5), axis.flip(0) * 0.01])
    with torch.no_grad():
        dt = imf.exposure_of(p, 1)
        vm = imf.poses_at(p, scene, (scene.timestamps[1] + 0.5 * dt).reshape(1), m)[0]
        target, _, _ = imf.render_pose(p, scene, vm, m, exposure=dt)
        vm_off = lie.mat_mul(lie.se3_exp(xi), vm)
    graphed_and_eager("make_aligner, frame 1", functools.partial(pose_align.make_aligner, m),
                      (p, scene, vm_off, dt, target), count, ALIGN_STEPS + 1)
    for frame in (1, trainer.dataset.num_frames - 1):
        with torch.no_grad():
            clean = imf.render_frame(p, scene, frame, m).blurred_ldr
            t_i = float(scene.timestamps[frame])
            j0 = int(np.floor((t_i - float(scene.knot_t0)) / float(scene.knot_dt))) - 1
            idx = torch.clamp(torch.arange(j0, j0 + 7, device=dev), 0,
                              p["knot_deltas"].shape[0] - 1)
            knots = torch.unique(idx)
            kd = p["knot_deltas"]
            broken = dict(p, knot_deltas=kd.index_put(
                (knots,), lie.se3_log(lie.mat_mul(lie.se3_exp(xi), lie.se3_exp(kd[knots])))))
        graphed_and_eager(f"make_window_realigner, frame {frame} (knots {idx.tolist()})",
                          functools.partial(pose_align.make_window_realigner, m),
                          (broken, scene, frame, clean), count, ALIGN_STEPS)
    # kernels B1, B2 and G1 on the inputs one aligner step gives them
    (bwd_call,), (g1_call,) = capture_backwards(lambda: pose_align.make_aligner(
        m, steps=1).eager(p, scene, vm_off, dt, target))
    measure_backward("aligner_step", bwd_call, reps=20)
    with torch.no_grad():
        measure_compositor("aligner_step_forward", bwd_call[:3] + bwd_call[6:], 1, reps=20)
    return measure_g1("aligner_step", g1_call, reps=20)


# ms a step of each aligner run, graphed (replays only) and eager
ALIGNER_MS = {}
# the steps of the descents profiled for the card's busy time a step (the
# trace of a 48-step descent takes minutes to read)
PROFILED_STEPS = 4


def graphed_and_eager(name, make, args, count, b1_expected):
    """An aligner (`make(steps=...)`) of ALIGN_STEPS steps graphed twice
    (warm-up, capture and replays, then replays only) and eagerly on the
    same inputs: each lowers its loss and launches B1 and B2 once a step
    (`log_alignment`); the second graphed call and the eager one give the
    same results (`twins_close`); the graph was captured once and replayed
    the rest of the steps.  Then the card's busy time a step, graphed and
    eager, from a profiled descent of PROFILED_STEPS steps (graphed: all
    replays)."""
    fn = make(steps=ALIGN_STEPS)
    runs = {}
    for kind, run in (("graphed", fn), ("graphed again", fn), ("eager", fn.eager)):
        (out, (b1, b2)), t = timed(lambda: count(lambda: run(*args)))
        log_alignment(f"{name}, {kind}", out[2], t, b1, b2, b1_expected)
        runs[kind] = (out, t)
    call = fn.graphs.call.step
    log(f"{name}: the descent step's graph captured {call.captures} time(s), replayed "
        f"{call.replays} times over {2 * ALIGN_STEPS} graphed steps; a replay counts "
        + ", ".join(f"{c.symbol} {n}" for c, n in call._rise))
    if call.captures != 1 or call.replays != 2 * ALIGN_STEPS - 1:
        raise AssertionError(f"{name}: one capture and {2 * ALIGN_STEPS - 1} replays expected")
    equal = all(twins_close(f"{name}, graphed {i}", runs[k][0], runs["eager"][0])
                for i, k in enumerate(("graphed", "graphed again")))
    ms = {k: runs[k][1] / ALIGN_STEPS * 1e3 for k in runs}
    short = make(steps=PROFILED_STEPS)
    short(*args)  # its warm-up and capture
    for kind, run in (("graphed", short), ("eager", short.eager)):
        wall, busy = profile_window(f"{name}, {kind} descent of {PROFILED_STEPS} steps",
                                    lambda: run(*args), reps=1)
        ms[f"{kind} busy"] = busy / PROFILED_STEPS
        ms[f"{kind} busy share"] = busy / wall
    ALIGNER_MS[name] = ms
    log(f"{name}: graphed {ms['graphed']:.2f} ms a step with its capture, "
        f"{ms['graphed again']:.2f} replaying; eager {ms['eager']:.2f} "
        f"({ms['eager'] / ms['graphed again']:.2f}x); card busy {ms['graphed busy']:.2f} ms a "
        f"step graphed ({100 * ms['graphed busy share']:.1f}% of the profiled wall), "
        f"{ms['eager busy']:.2f} eager ({100 * ms['eager busy share']:.1f}%); loss curves, "
        f"corrections and outputs "
        + ("equal to the bit" if equal else "within tolerance (logged above)"))


def log_alignment(name, curve, seconds, b1, b2, b1_expected):
    """Log an aligner run; it must lower its loss and launch B1 and B2 once
    a step (B1 once more for make_aligner's final render)."""
    c = curve.tolist()
    log(f"{name}: {ALIGN_STEPS} steps in {seconds:.3f} s = {seconds / ALIGN_STEPS * 1e3:.2f} "
        f"ms a step; loss {c[0]:.6g} -> {c[-1]:.6g}; launches B1 {b1}, B2 {b2}")
    if not c[-1] < c[0]:
        raise AssertionError(f"{name}: the loss did not fall")
    if b1 != b1_expected or b2 != ALIGN_STEPS:
        raise AssertionError(f"{name}: B1 and B2 once a step")


def bench_shapes(device):
    """B1, B2 and G1 at bench.py::build's workload: 100k Gaussians, 4 views,
    16x16 tiles, chunk 128.  Returns G1's measurement."""
    import torch

    from casualhdrsplat_torch.config import RasterizeConfig
    from casualhdrsplat_torch.data import synthetic
    from casualhdrsplat_torch.geometry import spline
    from casualhdrsplat_torch.ops import rasterize as rast

    rng = np.random.default_rng(SEED)
    cloud = synthetic.random_cloud(rng, 100_000, scale_range=(0.004, 0.02), device=device)
    cam = synthetic.orbit_camera(0.0, width=SIZE, img_height=SIZE, device=device)
    knots = synthetic.orbit_knots(6, angle_span=0.12, width=SIZE, img_height=SIZE,
                                  device=device)
    vms = spline.cubic_bspline_interpolation(
        knots, -2.0, 1.0, spline.sample_virtual_times(torch.tensor(1.0, device=device),
                                                      0.6, 4))
    bench_cfg = RasterizeConfig(tile_h=16, tile_w=16, chunk=128)
    colors = cloud.colors.clone().requires_grad_(True)
    weights = torch.as_tensor(rng.normal(size=(4, SIZE, SIZE, 3)).astype(np.float32),
                              device=device)

    def fwd_bwd():
        images, _, _ = rast.rasterize(
            cloud.means3d, cloud.quats, cloud.scales, cloud.opacities, colors, vms,
            cam.fx, cam.fy, cam.cx, cam.cy, SIZE, SIZE, bench_cfg)
        (images * weights).sum().backward()

    (bwd_call,), (g1_call,) = capture_backwards(fwd_bwd)
    with torch.no_grad():
        measure_compositor("bench_16x16", bwd_call[:3] + bwd_call[6:], 1, reps=20)
    measure_backward("bench_16x16", bwd_call, reps=20)
    del bwd_call
    return measure_g1("bench_16x16", g1_call, reps=20)


def quality_phase(device, rp):
    """The at-spec quality run, cut to QUALITY_STEPS steps: returns
    (launches of B1, of B2 and of G1) during the run."""
    import torch

    from casualhdrsplat_torch import quality_run
    from casualhdrsplat_torch.ops import stream_gather as sg
    from casualhdrsplat_torch.train import trainer as trainer_mod

    kernels = (rp.FWD_KERNEL, rp.BWD_KERNEL, sg.KERNEL, sg.INDEX)
    per_step, captured, step_s, trainers = [], [], [], []
    run_step = trainer_mod.Trainer.run_step

    def counted_step(trainer):
        """run_step, noting the B1, B2 and G1 launches it made; after the last
        step, B2's call on that state (frame 1's loss and gradients) is kept
        for the comparison with the plain versions: a replayed step makes
        no call of the launcher to capture.  The last trainer is kept for
        the eval window."""
        trainers[:] = [trainer]
        before = tuple(k.launches for k in kernels)
        out, dt = timed(lambda: run_step(trainer))
        per_step.append(tuple(k.launches - b for k, b in zip(kernels, before)))
        step_s.append(dt)
        if trainer.step == QUALITY_STEPS:
            frame = int(trainer.dataset.train_indices[1])
            captured.extend(capture_calls(rp, "_backward_cuda",
                                          lambda: trainer.loss_and_grads(frame)))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "QUALITY_smoke.json")
        args = R05_FLAGS + [
            "--steps", str(QUALITY_STEPS), "--coarse-steps", str(QUALITY_COARSE),
            "--eval-every-steps", str(QUALITY_EVAL_EVERY), "--eval-every-s", "1e9",
            "--align-steps", str(QUALITY_ALIGN_STEPS), "--fresh", "--run-label", "chip-smoke",
            "--out", out, "--render-dir", os.path.join(tmp, "quality"),
            "--fixture-cache", os.path.join(tmp, "fixture_cache"), "--device", device.type]
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        trainer_mod.Trainer.run_step = counted_step
        try:
            rc, seconds = timed(lambda: quality_run.main(args))
        finally:
            trainer_mod.Trainer.run_step = run_step
        launches = tuple(k.launches for k in kernels)
        index_launches, launches = launches[3], launches[:3]
        INDEX_LAUNCHES["quality run"] = index_launches
        with open(out) as f:
            report = json.load(f)
    coarse, full = step_s[1:QUALITY_COARSE], step_s[QUALITY_COARSE + 1:]
    log(f"quality run: {QUALITY_STEPS} steps, {len(report['psnr_curve'])} evals and the "
        f"aligned eval in {seconds:.1f} s (of which the fixture {report['wall_s']['gt_gen']} "
        f"s); step median {np.median(coarse) * 1e3:.2f} ms on the coarse rung, "
        f"{np.median(full) * 1e3:.2f} ms at full resolution (the first step of each left "
        f"out); peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"B1 {launches[0]}, B2 {launches[1]}, G1 {launches[2]}; rasterizer "
        f"{json.dumps(report['rasterize'])}")
    log("quality report: " + json.dumps({k: report[k] for k in (
        "scale", "exposure_recovery", "crf_recovery", "hdr_recovery", "pose_recovery",
        "final_eval", "deblurring_gain_db", "deblurring_gain_db_aligned")}))
    missing = [k for k in REPORT_KEYS if k not in report]
    if rc != 0 or missing:
        raise AssertionError(f"quality run: exit {rc}, report without {missing}")
    curve = report["psnr_curve"]
    for point in curve:
        log("  eval " + json.dumps({k: point[k] for k in (
            "step", "res", "loss", "alive", "dropped", "clipped", "eval_psnr",
            "eval_sharp_psnr", "eval_sharp_psnr_input", "rot_deg_mean", "exp_err_mean")}))
        if not all(np.isfinite(v) for v in point.values() if isinstance(v, float)):
            raise AssertionError(f"quality run: non-finite values at step {point['step']}")
    for res in sorted({p["res"] for p in curve}):
        rung = [p["eval_psnr"] for p in curve if p["res"] == res]
        if len(rung) < 2 or not rung[-1] > rung[0]:
            raise AssertionError(f"quality run: eval_psnr at {res}x{res} did not rise: {rung}")
    if (len(per_step) != QUALITY_STEPS or set(per_step) != {(1, 1, 1, 1)}
            or index_launches != launches[2]):
        raise AssertionError(f"quality run: B1, B2, G1 and its index once per step, got "
                             f"{set(per_step)}; G1 {launches[2]}, index {index_launches}")

    # kernels B1 and B2 on the last step's inputs: 800x800, 8 views of
    # 16x16 tiles, chunk 256, per-view binning into 12 x 131,072-row streams
    bwd_call, = captured
    res = measure_backward("quality_step", bwd_call, reps=10)
    with torch.no_grad():
        measure_compositor("quality_step_forward", bwd_call[:3] + bwd_call[6:], 1, reps=10)
    del bwd_call, captured

    # the eval window on the run's last trainer (r05's fixture at 800x800)
    trainer, = trainers
    torch.cuda.reset_peak_memory_stats()
    b1 = eval_window(trainer, f"evaluate (r05 fixture, {trainer.dataset.width}x"
                              f"{trainer.dataset.height})")
    log(f"eval window: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(the trainer, its step's graph and the evaluation's graphs)")
    del trainer, trainers
    torch.cuda.empty_cache()
    return (launches[0] + b1, *launches[1:], res)


def bench_phase(device, rp):
    """bench.main at build()'s defaults: its JSON line (the step replayed as
    a CUDA graph), and B1 and B2 once per step (the warm-up steps and 3
    windows); then, in this call, the same windows of the eager step (the
    yardstick) and both steps' walls and busy shares.  Returns (launches of
    B1, of B2 and of G1) of bench.main."""
    import contextlib
    import io

    from casualhdrsplat_torch import bench
    from casualhdrsplat_torch.ops import stream_gather as sg

    kernels = (rp.FWD_KERNEL, rp.BWD_KERNEL, sg.KERNEL, sg.INDEX)
    for k in kernels:
        k.launches = 0
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc, seconds = timed(lambda: bench.main(["--device", device.type]))
    launches = tuple(k.launches for k in kernels)
    index_launches, launches = launches[3], launches[:3]
    INDEX_LAUNCHES["bench"] = index_launches
    lines = text.getvalue().strip().splitlines()
    for line in lines:
        log(line)
    steps = bench.WARMUP_STEPS + bench.N_WINDOWS * bench.ITERS_PER_WINDOW
    result = json.loads(lines[-1])
    log(f"bench: {steps} steps in {seconds:.1f} s with the build; launches B1 {launches[0]}, "
        f"B2 {launches[1]}, G1 {launches[2]}")
    if rc != 0 or result["metric"] != "rendered Mpix/s/chip fwd+bwd" or not result["value"] > 0:
        raise AssertionError(f"bench: exit {rc}, line {result}")
    if launches != (steps, steps, steps) or index_launches != steps:
        raise AssertionError(f"bench: B1, B2, G1 and its index once per step, got {launches}, "
                             f"index {index_launches}")
    step, args, pixels = bench.build(device=device)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        bench._run(step.eager, args, pixels, device, True)
    log("bench, the eager step: " + text.getvalue().strip().splitlines()[-1])
    eager_and_graphed("bench step", lambda: step.eager(*args), lambda: step(*args))
    return launches


def entry_phase(device, rp):
    """entry(): the blurred frame of the tiny model, three calls (the
    graph's eager warm-up, its capture, a replay), equal to the bit; B1
    launched once a call.  Returns the launches of B1."""
    import torch

    from casualhdrsplat_torch import entry

    fn, args = entry.entry(device)
    rp.FWD_KERNEL.launches = 0
    outs, walls = [], []
    with torch.no_grad():
        for _ in range(3):
            out, dt = timed(lambda: fn(*args))
            outs.append(out)
            walls.append(dt * 1e3)
    launches = rp.FWD_KERNEL.launches
    check_image("entry", out, (32, 32, 3), 0.0, 1.0)
    log(f"entry: blurred frame {tuple(out.shape)}, mean {float(out.mean()):.4f}, "
        f"{[round(w, 2) for w in walls]} ms (warm-up, capture, replay), launches B1 {launches}")
    if launches != 3 or not all(torch.equal(o, outs[0]) for o in outs):
        raise AssertionError("entry: B1 once per call, the same frame every call")
    return launches


# -- the sharded path (parallel/) ------------------------------------------------

# the meshes of the two-rank world: ranks share cuda:0 over gloo
SHARDED_MESHES = ((1, 2), (2, 1))
# the rank whose kernel calls are held against the plain versions (gauss
# index 1 on (1, 2), data index 1 on (2, 1)), and its timing repetitions
MEASURED_RANK, SHARDED_REPS = 1, 5


def sharded_cfg(branch: str):
    """ladder4 with density control off and per-view binning (the sharded
    path bins per view whatever shared_binning says; its yardstick is the
    one-device per-view branch), packed or on the dense path's lists."""
    from casualhdrsplat_torch import config

    cfg = config.PRESETS["ladder4"]()
    cfg.densify.enabled = False
    cfg.densify.grad_threshold = DENSE_GRAD_THRESHOLD
    cfg.eval_every = 0
    cfg.data.eval_every = 0
    cfg.model.rasterize = dataclasses.replace(cfg.model.rasterize, shared_binning=False)
    if branch == "dense":
        cfg.model = dense_model_cfg(cfg.model)
    return cfg


def flat_grads(trainer, grads, g2d, gather=None):
    """{group path: gradient on the CPU}, the store's gathered by `gather`
    on a mesh."""
    from casualhdrsplat_torch.train import optim

    out = {}
    for path, label, _ in optim.labelled_leaves(trainer.params):
        if label == "frozen":
            continue
        g = optim.tree_get(grads, path)
        out["/".join(path)] = (gather(g) if gather and path[0] == "gaussians" else g).cpu()
    out["means2d_offset"] = (gather(g2d) if gather else g2d).cpu()
    return out


def collective_lines(stats, steps: int = 1):
    """One log line per collective: calls, MB and host ms per step (host
    ms "not measured" once a replayed graph ran the collective)."""
    return [f"    {name}: {c / steps:.0f} calls, {b / steps / 1e6:.2f} MB, "
            + ("host ms not measured (replayed)" if t is None
               else f"{t / steps * 1e3:.2f} ms host")
            for name, (c, b, t) in sorted(stats.items())]


def sharded_world_of_one(device, dataset, rp):
    """The sharded path on a world of one (nccl, mesh (1, 1)) against the
    one-device trainer on the per-view branch from the same state: one
    step's gradients; then a step of each (their graphs' warm-ups) and
    TRAIN_STEPS steps in which the one-device trainer replays its graph and
    the mesh trainer runs its captured step and its eager twin from the
    same state (`graph_vs_eager_steps`: scalars and every tensor of the
    step held together, B1, B2, G1 and its index and both halves of P1 once
    a step either way, the collectives' calls and bytes of a graphed step equal to an eager
    step's).  Returns (B1, B2, G1 launches of the mesh's steps)."""
    import torch
    import torch.distributed as dist

    from casualhdrsplat_torch.ops import projection_fused as pf
    from casualhdrsplat_torch.ops import stream_gather as sg
    from casualhdrsplat_torch.parallel.distributed import backend_for
    from casualhdrsplat_torch.parallel.mesh import Mesh
    from casualhdrsplat_torch.train.trainer import Trainer
    from casualhdrsplat_torch.utils import cuda_graphs

    cfg = sharded_cfg("packed")
    with tempfile.TemporaryDirectory(prefix="chs-world-") as tmp:
        dist.init_process_group(backend_for(device), init_method=f"file://{tmp}/rendezvous",
                                world_size=1, rank=0)
        try:
            mesh = Mesh(1, 1)
            one = Trainer(cfg, dataset, device=device)
            sharded = Trainer(cfg, dataset, device=device, mesh=mesh)
            frame = int(one.dataset.train_indices[1])
            loss_a, _, grads_a, g2d_a = one.loss_and_grads(frame)
            loss_b, _, grads_b, g2d_b = sharded.loss_and_grads(frame)
            a, b = flat_grads(one, grads_a, g2d_a), flat_grads(sharded, grads_b, g2d_b)
            if abs(float(loss_a) - float(loss_b)) > ATOL * abs(float(loss_a)):
                raise AssertionError(f"mesh (1, 1): loss {float(loss_b)} against the one-device "
                                     f"{float(loss_a)}")
            worst = max(grads_close(f"mesh (1, 1) gradient {k}", b[k], a[k])
                        / max(float(a[k].abs().max()), 1e-30) for k in a)
            log(f"sharded, world of 1 (nccl, mesh (1, 1)): loss {float(loss_b):.6f} vs the "
                f"one-device per-view {float(loss_a):.6f}; {len(a)} gradient groups agree, "
                f"worst max abs err {worst:.3g} of the group's largest")
            del grads_a, grads_b, a, b
            graphable = cuda_graphs.graphable(device, mesh)
            log(f"mesh (1, 1): backends {sorted(mesh.backends())}, run_step "
                f"{'replays a CUDA graph' if graphable else 'eager'}")
            if not graphable:
                raise AssertionError("a world of one over nccl on the card must be graphable")
            one.run_step(), sharded.run_step()  # the graphs' warm-ups
            kernels = (rp.FWD_KERNEL, rp.BWD_KERNEL, sg.KERNEL, sg.INDEX)
            for k in kernels:
                k.launches = 0
            walls = {"one-device": [], "graphed": [], "eager": [], "replay": [],
                     "collectives": []}
            outs = {"one-device": [], "mesh (1, 1)": []}
            # the two trainers' steps alternate, so that a drift of the
            # host's or the card's speed reaches both alike
            for _ in range(TRAIN_STEPS):
                out, dt = timed(one.run_step)
                walls["one-device"].append(dt)
                outs["one-device"].append(out)
                w = graph_vs_eager_steps(sharded, 1, kernels + (pf.FWD_KERNEL, pf.BWD_KERNEL),
                                         "mesh (1, 1)", after_step=outs["mesh (1, 1)"].append)
                for key in w:
                    walls[key] += w[key]
            # each step: the one-device trainer's, the mesh's graphed and eager
            launches = tuple(k.launches for k in kernels)
            if launches != (3 * TRAIN_STEPS,) * 4:
                raise AssertionError(f"mesh (1, 1) phase: B1, B2, G1 and its index {launches}, "
                                     f"3 a step expected")
            for step, (x, y) in enumerate(zip(outs["one-device"], outs["mesh (1, 1)"]), 3):
                if not (np.isfinite(y["loss"]) and abs(x["loss"] - y["loss"])
                        <= 1e-4 * abs(x["loss"]) and abs(x["psnr"] - y["psnr"]) <= 1e-3):
                    raise AssertionError(f"mesh (1, 1) step {step}: {y} against {x}")
            replays = [w for w, r in zip(walls["graphed"], walls["replay"]) if r]
            call = sharded._step_graphs.call
            if len(replays) < TRAIN_STEPS - 1 or call.captures != 1:
                raise AssertionError(f"mesh (1, 1): {call.captures} captures, {len(replays)} "
                                     f"replays in {TRAIN_STEPS} steps")
            one_ms, graphed_ms, eager_ms = (float(np.median(v)) * 1e3 for v in (
                walls["one-device"], replays, walls["eager"]))
            log(f"sharded steps, mesh (1, 1): graphed median {graphed_ms:.2f} ms "
                f"({len(replays)} replays of {TRAIN_STEPS} steps), its eager twin "
                f"{eager_ms:.2f} ms ({eager_ms / graphed_ms:.2f}x), the one-device per-view "
                f"step graphed {one_ms:.2f} ms ({graphed_ms / one_ms:.3f}x); the step's graph "
                f"captured {call.captures} time(s), replayed {call.replays} times, a replay "
                f"counts " + ", ".join(f"{c.symbol} {n}" for c, n in call._rise)
                + "; losses " + ", ".join(f"{o['loss']:.6f}" for o in outs["mesh (1, 1)"])
                + f"; launches over the {TRAIN_STEPS} steps of the three runs: B1 "
                f"{launches[0]}, B2 {launches[1]}, G1 {launches[2]}, its index {launches[3]}; "
                f"walls in ms: " + json.dumps({k: [round(x * 1e3, 2) for x in walls[k]]
                                               for k in ("one-device", "graphed", "eager")}))
            for kind in ("graphed", "eager"):
                log(f"  collectives of the last step, {kind}:")
                for line in collective_lines(walls["collectives"][-1][kind]):
                    log(line)
            if "--profile" in sys.argv[1:]:
                profile_window("one-device per-view step", one.run_step)
            eager_and_graphed("mesh (1, 1) step", sharded.run_step_eager, sharded.run_step)
            # free slots for the round: a quarter of the store below the
            # opacity prune (the store is full)
            with torch.no_grad():
                sharded.params["gaussians"]["opacity_logit"][::4] = -10.0
            densify_window(sharded, "mesh (1, 1)", mesh=True)
            INDEX_LAUNCHES["mesh (1, 1)"] = launches[3]
            launches = launches[:3]
            del one, sharded
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches


def sharded_rank(rank, device, dataset, cfgs, refs):
    """One rank of the two-rank world (gloo, both ranks on cuda:0): on each
    mesh of SHARDED_MESHES, one trainer; for each branch (its config
    swapped in), one render_frame and one training step's gradients from
    the initial state (rank 0 holds them against the one-device `refs`),
    then a step on each branch, a densify round and a rebalance.  On
    MEASURED_RANK, each mesh's first step of each branch is then held
    against the plain versions of B1-B4 and G1 (`sharded_kernel_checks`).
    Returns this rank's log lines, its launch counts on the path (the
    comparison's launches left out) and {mesh: {kernel: max abs err}}."""
    import torch

    from casualhdrsplat_torch.ops import rasterize_dense as rd
    from casualhdrsplat_torch.ops import rasterize_packed as rp
    from casualhdrsplat_torch.ops import stream_gather as sg
    from casualhdrsplat_torch.parallel import render as prender
    from casualhdrsplat_torch.parallel import sharding
    from casualhdrsplat_torch.parallel.mesh import Mesh
    from casualhdrsplat_torch.train.trainer import Trainer

    kernels = {"B1": rp.FWD_KERNEL, "B2": rp.BWD_KERNEL, "B3": rd.FWD_KERNEL,
               "B4": rd.BWD_KERNEL, "G1": sg.KERNEL, "G1 index": sg.INDEX}
    # each branch's backward launcher, whose captured call also holds the
    # forward's inputs
    launchers = {"packed": (rp, "_backward_cuda"), "dense": (rd, "backward")}
    for k in kernels.values():
        k.launches = 0
    lines, captured, errors = [], {}, {}
    for shape in SHARDED_MESHES:
        mesh = Mesh(*shape)
        t = Trainer(copy.deepcopy(cfgs["packed"]), dataset, device=device, mesh=mesh)
        frame = int(t.dataset.train_indices[1])
        for branch in ("packed", "dense"):
            tag = f"mesh {shape} {branch}"
            t.cfg.model = cfgs[branch].model
            ref = refs[branch]
            with torch.no_grad():
                out = prender.render_frame_sharded(t.params, t.scene, frame, t.cfg.model, mesh)
            for name, img in (("blurred", out.blurred_ldr), ("hdr", out.sharp_hdr)):
                err = float((img.cpu() - ref[name]).abs().max())
                lines.append(f"{tag}: {name} max abs err {err} against one device")
                if not torch.allclose(img.cpu(), ref[name], atol=ATOL, rtol=RTOL):
                    raise AssertionError(f"{tag}: {name} disagrees with one device: {err}")
            if int(out.aux.num_dropped) != ref["dropped"]:
                raise AssertionError(f"{tag}: dropped {int(out.aux.num_dropped)} against "
                                     f"{ref['dropped']}")
            del out
            mesh.stats.clear()
            outs, g1_calls = [], []

            def step():
                outs.append(t.loss_and_grads(frame))

            def packed_step():  # G1's call as well
                g1_calls.extend(capture_calls(sg, "_backward_cuda", step, restore_counts=False))

            calls, dt = timed(lambda: capture_calls(
                *launchers[branch], packed_step if branch == "packed" else step,
                restore_counts=False))
            (loss, _, grads, g2d), = outs
            if rank == MEASURED_RANK:
                captured[branch] = calls[0]
                if branch == "packed":
                    captured["G1"] = g1_calls[0]
            del calls, g1_calls
            stats = dict(mesh.stats)
            got = flat_grads(t, grads, g2d, lambda g: sharding.gather_leaf(g, mesh))
            worst = max(grads_close(f"{tag} gradient {k}", got[k], ref["grads"][k])
                        / max(float(ref["grads"][k].abs().max()), 1e-30) for k in got)
            lines.append(f"{tag}: loss {float(loss):.6f} (one device {ref['loss']:.6f}), "
                         f"{len(got)} gradient groups agree, worst {worst:.3g} of the "
                         f"largest; loss and gradients {dt * 1e3:.1f} ms; collectives:")
            lines += collective_lines(stats)
            if abs(float(loss) - ref["loss"]) > ATOL * abs(ref["loss"]):
                raise AssertionError(f"{tag}: loss {float(loss)} against {ref['loss']}")
            del grads, g2d, got
        for branch in ("packed", "dense"):  # a step of each: Adam on the blocks
            t.cfg.model = cfgs[branch].model
            step = t.run_step()
            if not np.isfinite(step["loss"]):
                raise AssertionError(f"mesh {shape} {branch}: step {step}")
        # gloo runs its collectives on the host: run_step is eager here
        if t._step_graphs.call is not None:
            raise AssertionError(f"mesh {shape} over gloo: run_step captured a graph")
        lines.append(f"mesh {shape}: backends {sorted(mesh.backends())}, run_step eager")
        report = t._densify(False)
        before = t._shard_counts()
        t._rebalance()
        after = t._shard_counts()
        lines.append(f"mesh {shape}: densify round cloned {int(report.num_cloned)}, split "
                     f"{int(report.num_split)}, pruned {int(report.num_pruned)}, alive "
                     f"{int(report.num_alive)}; blocks {before.tolist()} -> {after.tolist()} "
                     f"after the rebalance")
        if (after.sum() != before.sum() or np.ptp(after) > np.ptp(before)
                or int(report.num_cloned + report.num_split) <= 0):
            raise AssertionError(f"mesh {shape}: densify {report}, blocks {before} -> {after}")
        del t
        if rank == MEASURED_RANK:  # after the timed work: the other rank waits meanwhile
            on_path = {name: k.launches for name, k in kernels.items()}
            errors[str(shape)] = sharded_kernel_checks(shape, captured)
            captured.clear()
            for name, k in kernels.items():  # the comparison's launches do not count
                k.launches = on_path[name]
        torch.cuda.empty_cache()
    return lines, {name: k.launches for name, k in kernels.items()}, errors


def sharded_kernel_checks(shape, captured):
    """B1-B4 and G1 against their plain versions on the inputs one rank's
    sharded training step gave them: the packed stream with the rows of the
    other rank's tiles empty (lo = hi = 0), its per-view ids (G1, also
    against its emulation), and the dense branch's slice of tiles with
    view-carrying indices v tiles_pad + g tpd + i.  Returns {kernel: max
    abs err}, and G1's whole measurement under "G1 measured"; raises on a
    disagreement."""
    import torch

    tag = f"sharded_{shape[0]}x{shape[1]}_rank{MEASURED_RANK}"
    packed, dense = captured["packed"], captured["dense"]
    b2 = measure_backward(f"{tag}_packed_step", packed, reps=SHARDED_REPS)
    b4 = measure_dense_backward(f"{tag}_dense_step", dense, reps=SHARDED_REPS)
    with torch.no_grad():
        b1 = measure_compositor(f"{tag}_packed_step_forward", packed[:3] + packed[6:], 1,
                                reps=SHARDED_REPS)
        b3 = measure_dense_forward(f"{tag}_dense_step_forward", dense[:3] + dense[5:], 1,
                                   reps=SHARDED_REPS)
    g1 = measure_g1(f"{tag}_packed_step", captured["G1"], reps=SHARDED_REPS)
    errors = {k: r["max_abs_err"] for k, r in (("B1", b1), ("B2", b2), ("B3", b3), ("B4", b4),
                                                ("G1", g1))}
    return dict(errors, **{"G1 measured": g1})


def sharded_world_of_two(device, dataset):
    """The sharded path on two gloo ranks that share cuda:0, on the meshes
    (1, 2) and (2, 1), against the one-device port on the card.  Their
    times are not those of NCCL across cards.  Returns the launches of B1,
    B2, B3, B4 and G1 summed over the ranks, and rank 1's G1 measurement
    on the mesh (1, 2)."""
    import torch

    from casualhdrsplat_torch.models import image_formation as imf
    from casualhdrsplat_torch.parallel import launch
    from casualhdrsplat_torch.train.trainer import Trainer

    # a store with free slots for the densify round: the dense trainer's
    dataset = dataclasses.replace(dataset, points_xyz=dataset.points_xyz[:DENSE_TRAIN_POINTS],
                                  points_rgb=dataset.points_rgb[:DENSE_TRAIN_POINTS])
    refs, cfgs = {}, {b: sharded_cfg(b) for b in ("packed", "dense")}
    t = Trainer(copy.deepcopy(cfgs["packed"]), dataset, device=device)
    frame = int(t.dataset.train_indices[1])
    for branch in ("packed", "dense"):
        t.cfg.model = cfgs[branch].model
        with torch.no_grad():
            out = imf.render_frame(t.params, t.scene, frame, t.cfg.model)
        dropped = int(out.aux.num_dropped) + (int(out.aux.num_clipped)
                                              if branch == "packed" else 0)
        loss, _, grads, g2d = t.loss_and_grads(frame)
        refs[branch] = {"blurred": out.blurred_ldr.cpu(), "hdr": out.sharp_hdr.cpu(),
                        "dropped": dropped, "loss": float(loss),
                        "grads": flat_grads(t, grads, g2d)}
        del out, grads, g2d
    del t
    torch.cuda.empty_cache()
    results, seconds = timed(lambda: launch.spawn(sharded_rank, 2, "gloo", device.type,
                                                  args=(dataset, cfgs, refs), timeout=600))
    launches = {}
    for rank, (lines, counts, errors) in enumerate(results):
        for line in lines:
            log(f"  rank {rank} {line}")
        log(f"  rank {rank} launches: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
        for shape, errs in errors.items():
            log(f"  rank {rank} mesh {shape}: kernels against their plain versions on this "
                f"rank's step, max abs err " + ", ".join(
                    f"{k} {v:.3g}" for k, v in errs.items() if k != "G1 measured"))
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    checked = results[MEASURED_RANK][2]
    if sorted(checked) != sorted(str(s) for s in SHARDED_MESHES):
        raise AssertionError(f"rank {MEASURED_RANK} checked the kernels on {sorted(checked)}")
    log(f"sharded, world of 2 (gloo, both ranks on cuda:0; not NCCL across cards): "
        f"{seconds:.1f} s; launches over both ranks {launches}")
    if any(v <= 0 for v in launches.values()) or launches["G1 index"] != launches["G1"]:
        raise AssertionError(f"the two-rank world did not launch every kernel, or G1's index "
                             f"not once per G1: {launches}")
    INDEX_LAUNCHES["world of 2"] = launches["G1 index"]
    return launches, checked[str(SHARDED_MESHES[0])]["G1 measured"]


def sharded_bench_and_dryrun(device):
    """bench --sharded 1,1 (a world of one in this process; its step
    replays a CUDA graph), then its eager step by bench's own loop and the
    two in one eager-and-graphed window, and dryrun_multichip(2) on two
    gloo ranks sharing the card (eager).  Returns the launches of B1 and B2
    (of both) and of G1 (of bench's graphed run)."""
    import contextlib
    import io

    import torch.distributed as dist

    from casualhdrsplat_torch import bench, entry
    from casualhdrsplat_torch.ops import rasterize_packed as rp
    from casualhdrsplat_torch.ops import stream_gather as sg
    from casualhdrsplat_torch.parallel.distributed import backend_for
    from casualhdrsplat_torch.parallel.mesh import Mesh

    kernels = (rp.FWD_KERNEL, rp.BWD_KERNEL, sg.KERNEL, sg.INDEX)
    for k in kernels:
        k.launches = 0
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc, seconds = timed(lambda: bench.main(["--device", device.type, "--sharded", "1,1"]))
    launches = [k.launches for k in kernels]
    lines = text.getvalue().strip().splitlines()
    for line in lines:
        log(f"bench --sharded 1,1: {line}")
    result = json.loads(lines[-1])
    steps = bench.WARMUP_STEPS + bench.N_WINDOWS * bench.ITERS_PER_WINDOW
    log(f"bench --sharded 1,1: {steps} steps in {seconds:.1f} s with the build; launches "
        f"B1 {launches[0]}, B2 {launches[1]}, G1 {launches[2]}")
    if rc != 0 or not result["value"] > 0 or launches != [steps] * 4:
        raise AssertionError(f"bench --sharded 1,1: exit {rc}, {result}, launches {launches}")
    INDEX_LAUNCHES["bench --sharded 1,1"] = launches[3]
    launches = launches[:3]
    # its eager step (`step.eager`) on the same workload, by bench's own loop
    with tempfile.TemporaryDirectory(prefix="chs-bench-") as tmp:
        dist.init_process_group(backend_for(device), init_method=f"file://{tmp}/rendezvous",
                                world_size=1, rank=0)
        try:
            step, args, pixels = bench.build_sharded(mesh=Mesh(1, 1), device=device)
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                bench._run(step.eager, args, pixels, device, True)
            eager = json.loads(text.getvalue().strip().splitlines()[-1])
            log(f"bench --sharded 1,1: graphed {result['value']} Mpix/s (windows "
                f"{result['windows']}, spread {result['spread_pct']}%), eager {eager['value']} "
                f"Mpix/s (windows {eager['windows']}, spread {eager['spread_pct']}%)")
            eager_and_graphed("bench --sharded 1,1 step", lambda: step.eager(*args),
                              lambda: step(*args))
            del step, args
        finally:
            dist.destroy_process_group()
    results, seconds = timed(lambda: entry.dryrun_multichip(2, device=device.type,
                                                            backend="gloo"))
    for r in results:
        launches[:2] = [a + b for a, b in zip(launches, r["launches"])]
    log(f"dryrun_multichip(2), gloo on one card: {seconds:.1f} s; launches per rank "
        f"{[r['launches'] for r in results]}")
    if any(min(r["launches"]) <= 0 for r in results):
        raise AssertionError("dryrun_multichip: a rank launched no B1 or B2")
    return launches


def kernel_entry(name, replaces, launches, res):
    return {
        "name": name,
        "route": "cuda",
        "source": f"casualhdrsplat_torch/csrc/{name}.cu",
        "replaces": f"casualhdrsplat_tpu/ops/{replaces}",
        "launches": launches,
        "max_abs_err": res["max_abs_err"],
        "ms": res["ms"],
        "plain_ms": res["plain_ms"],
        "bound_ms": res["bound_ms"],
        "bound_by": res["bound_by"],
        "library_ms": None,  # no single PyTorch call computes any of the four
    }


def at_ladder5(entry, res):
    """A kernels-line entry with its measurement on ladder5's step beside
    it, and max_abs_err the larger of the two."""
    keys = ("label", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    return dict(entry, max_abs_err=max(entry["max_abs_err"], res["max_abs_err"]),
                ladder5={k: res[k] for k in keys})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only on the card",
              file=sys.stderr)
        return 2
    try:
        import casualhdrsplat_torch  # noqa: F401
    except ModuleNotFoundError:
        # the script alone, without the package beside it: nothing to drive
        print("chip_smoke: casualhdrsplat_torch is not importable; run the script from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 2
    from casualhdrsplat_torch.bench import card_line
    from casualhdrsplat_torch.data import synthetic
    from casualhdrsplat_torch.models import image_formation as imf
    from casualhdrsplat_torch.ops import crf_fused
    from casualhdrsplat_torch.ops import projection_fused as pf
    from casualhdrsplat_torch.ops import rasterize_dense as rd
    from casualhdrsplat_torch.ops import rasterize_packed as rp
    from casualhdrsplat_torch.ops import stream_gather as sg

    device = torch.device("cuda", 0)
    smi = card_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- build ---------------------------------------------------------------
    # one nvcc per source, all started together
    kernels = (rp.FWD_KERNEL, rp.BWD_KERNEL, rd.FWD_KERNEL, rd.BWD_KERNEL,
               crf_fused.FWD_KERNEL, crf_fused.BWD_KERNEL, sg.KERNEL, sg.INDEX,
               pf.FWD_KERNEL, pf.BWD_KERNEL)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        for future in [pool.submit(k.load) for k in kernels]:
            future.result()
    log(f"built {', '.join(k.library_path.name for k in kernels)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for k in kernels:
        for line in k.build_log().splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"  ptxas {k.source_name}: {line.strip()}")
    t1_instruction_mix()
    crf_hidden64_check(device)
    crf_prefit_phase(device)

    # -- the model and a warm-up request ------------------------------------
    (cfg, scene, params), t_setup = timed(lambda: build_model(device))
    log(f"model: {cfg.max_gaussians} Gaussians, SH {cfg.sh_degree}, "
        f"{cfg.num_virtual_views} virtual views, {SIZE}x{SIZE}, "
        f"tiles {cfg.rasterize.tile_h}x{cfg.rasterize.tile_w}, chunk {cfg.rasterize.chunk}; "
        f"set-up {t_setup:.2f} s")
    angles = (-0.05, 0.0, 0.05)
    pose_vms = [synthetic.orbit_camera(a, width=SIZE, img_height=SIZE, device=device).viewmat
                for a in angles]
    exposure = torch.tensor(EXPOSURE, device=device)
    with torch.inference_mode():
        _, t_warm = timed(lambda: (imf.render_frame(params, scene, 0, cfg),
                                   imf.render_pose(params, scene, pose_vms[0], cfg)))
    log(f"warm-up requests: {t_warm:.3f} s")

    # -- the main path: serve requests, counts zeroed just before ------------
    torch.cuda.reset_peak_memory_stats()
    rp.FWD_KERNEL.launches = 0
    crf_fused.FWD_KERNEL.launches = crf_fused.BWD_KERNEL.launches = 0
    pf.FWD_KERNEL.launches = pf.BWD_KERNEL.launches = 0
    frame_s, pose_s, eager_out = [], [], {}
    with torch.inference_mode():
        for fid in range(3):
            out, dt = timed(lambda: imf.render_frame(params, scene, fid, cfg))
            eager_out[fid] = out.blurred_ldr
            frame_s.append(dt)
            check_image(f"frame {fid} blurred", out.blurred_ldr, (SIZE, SIZE, 3), 0.0, 1.0)
            check_image(f"frame {fid} hdr", out.sharp_hdr,
                        (cfg.num_virtual_views, SIZE, SIZE, 3), 0.0)
            log(f"render_frame({fid}): {dt * 1e3:.2f} ms, dropped "
                f"{int(out.aux.num_dropped)}, clipped {int(out.aux.num_clipped)}, "
                f"coverage {float((out.alphas > 0.5).float().mean()):.3f}")
        frame_launches = rp.FWD_KERNEL.launches
        for a, vm in zip(angles, pose_vms):
            for hdr in (False, True):
                (img, alpha, aux), dt = timed(
                    lambda: imf.render_pose(params, scene, vm, cfg, exposure=exposure,
                                            hdr_output=hdr))
                pose_s.append(dt)
                eager_out[a, hdr] = img
                check_image(f"pose {a} {'hdr' if hdr else 'ldr'}", img, (SIZE, SIZE, 3),
                            0.0, None if hdr else 1.0)
                log(f"render_pose(angle={a}, hdr={hdr}): {dt * 1e3:.2f} ms, dropped "
                    f"{int(aux.num_dropped)}")
    renders = graphed_serving(params, scene, cfg, pose_vms, angles, exposure, eager_out)
    launches = rp.FWD_KERNEL.launches
    pose_launches = launches - frame_launches
    log(f"serving: render_frame median {np.median(frame_s) * 1e3:.2f} ms, "
        f"render_pose median {np.median(pose_s) * 1e3:.2f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"launches of {rp.FWD_KERNEL.symbol}: {frame_launches} on the shared branch "
        f"(3 render_frame), {pose_launches} after them (6 render_pose on the per-view "
        f"branch; through the graphs 3 render_frame and 9 render_pose, and 3 eager depth "
        f"views)")
    if frame_launches != 3 or pose_launches != 21:
        raise AssertionError("the compositor kernel was not launched on both branches")
    log(f"launches of P1 while serving: forward {pf.FWD_KERNEL.launches}, backward "
        f"{pf.BWD_KERNEL.launches}")
    if (pf.FWD_KERNEL.launches, pf.BWD_KERNEL.launches) != (launches, 0):
        raise AssertionError("serving: P1's forward once a render, as the compositor, and "
                             "no backward")

    # -- kernels against their plain versions, timed -------------------------
    with torch.inference_mode():
        frame_call, = capture_calls(
            rp, "composite_stream", lambda: imf.render_frame(params, scene, 1, cfg))
        pose_call, = capture_calls(
            rp, "composite_stream",
            lambda: imf.render_pose(params, scene, pose_vms[1], cfg, exposure=exposure))
        res_frame = measure_compositor("render_frame", frame_call, 1, reps=20)
        measure_compositor("render_pose", pose_call, 1, reps=20)
        del frame_call, pose_call

        # the same frame on 16x16 tiles: what the default 16x128 tile costs
        cfg16 = dataclasses.replace(
            cfg, rasterize=dataclasses.replace(cfg.rasterize, tile_w=16))
        _, dt16 = timed(lambda: imf.render_frame(params, scene, 1, cfg16))
        log(f"render_frame(1) on 16x16 tiles: {dt16 * 1e3:.2f} ms")
        frame16_call, = capture_calls(
            rp, "composite_stream", lambda: imf.render_frame(params, scene, 1, cfg16))
        measure_compositor("render_frame_16x16", frame16_call, 1, reps=20)
        del frame16_call

        # T1 on the inputs a request gives it
        t1_frame = measure_crf_forward("render_frame", max(capture_calls(
            crf_fused, "_forward_cuda", lambda: imf.render_frame(params, scene, 1, cfg)),
            key=lambda a: a[0].shape[0]), reps=20)
        measure_crf_forward("render_pose", capture_calls(
            crf_fused, "_forward_cuda", lambda: imf.render_pose(
                params, scene, pose_vms[1], cfg, exposure=exposure))[0], reps=20)

        eager_and_graphed(
            "packed render_frame", lambda: imf.render_frame(params, scene, 1, cfg).blurred_ldr,
            lambda: renders.render_frame_blurred(params, scene, 1, cfg))
        eager_and_graphed(
            "packed render_pose",
            lambda: imf.render_pose(params, scene, pose_vms[1], cfg, exposure=exposure),
            lambda: renders.render_pose(params, scene, pose_vms[1], cfg, exposure=exposure))
    del renders

    def served_pose():
        with torch.no_grad():
            imf.render_pose(params, scene, pose_vms[1], cfg, exposure=exposure)

    # P1 on the inputs a served pose gives it
    p1_pose = measure_projection("render_pose", capture_project(served_pose)[0], reps=20)

    serve_launches = launches
    dense_serve_launches, res_dense_fwd = dense_serving_phase(
        device, cfg, scene, params, pose_vms, exposure, rd)
    del params
    dataset = make_training_data(device)
    (train_fwd_launches, train_bwd_launches, train_g1_launches, res_bwd, t1_step,
     g1_step, p1_step) = train_phase(device, dataset, rp)
    dense_fwd_launches, dense_bwd_launches, res_dense_bwd = dense_train_phase(
        device, dataset, rd)
    torch.cuda.empty_cache()
    ladder5 = ladder5_phase(device, rp)
    torch.cuda.empty_cache()
    one = sharded_world_of_one(device, dataset, rp)
    two, g1_sharded = sharded_world_of_two(device, dataset)
    bench_dry = sharded_bench_and_dryrun(device)
    sharded = {"B1": one[0] + two["B1"] + bench_dry[0], "B2": one[1] + two["B2"] + bench_dry[1],
               "B3": two["B3"], "B4": two["B4"], "G1": one[2] + two["G1"] + bench_dry[2]}
    log(f"sharded phase launches: {sharded}")
    cli_fwd_launches, cli_bwd_launches, cli_g1_launches, g1_aligner = cli_phase(
        device, dataset, rp)
    del dataset
    quality_fwd_launches, quality_bwd_launches, quality_g1_launches, _ = quality_phase(
        device, rp)
    bench_fwd_launches, bench_bwd_launches, bench_g1_launches = bench_phase(device, rp)
    entry_fwd_launches = entry_phase(device, rp)
    t1_launches = crf_fused.FWD_KERNEL.launches, crf_fused.BWD_KERNEL.launches
    log(f"T1 launches on the main path: forward {t1_launches[0]}, backward {t1_launches[1]} "
        f"(the sharded phase's second rank not counted)")
    p1_launches = pf.FWD_KERNEL.launches, pf.BWD_KERNEL.launches
    log(f"P1 launches on the main path: forward {p1_launches[0]}, backward {p1_launches[1]} "
        f"(the sharded phase's second rank not counted)")
    g1_bench = bench_shapes(device)
    log("G1 on the main path's inputs (ms: the counting index and the kernel; sort_index: "
        "the sort it replaced; library: the transpose the port ran before): " + json.dumps(
            {r["label"]: {k: r[k] for k in (
                "ms", "kernel_ms", "index_ms", "sort_index_ms", "library_ms", "plain_ms",
                "bound_ms", "share_of_bound", "kernel_share_of_bound")}
             for r in (g1_step, g1_bench, g1_aligner, g1_sharded)}))
    with torch.inference_mode():
        small_slice_check(device)
    small_train_step_check(device)
    small_dense_train_check(device)
    row_bounds_check(device)

    kernels_line = [
        # each forward kernel is launched by its path's requests and steps;
        # B1, B2 and G1 also carry their measurement on ladder5's step
        # (under "ladder5"), max_abs_err the larger of the two
        at_ladder5(kernel_entry("rasterize_packed_fwd", "rasterize_packed.py:99",
                                serve_launches + train_fwd_launches + cli_fwd_launches
                                + quality_fwd_launches + bench_fwd_launches
                                + entry_fwd_launches + sharded["B1"] + ladder5[0], res_frame),
                   ladder5[3]["B1"]),
        at_ladder5(kernel_entry("rasterize_packed_bwd", "rasterize_packed.py:201",
                                train_bwd_launches + cli_bwd_launches + quality_bwd_launches
                                + bench_bwd_launches + sharded["B2"] + ladder5[1], res_bwd),
                   ladder5[3]["B2"]),
        kernel_entry("rasterize_dense_fwd", "rasterize_pallas.py:104",
                     dense_serve_launches + dense_fwd_launches + sharded["B3"], res_dense_fwd),
        kernel_entry("rasterize_dense_bwd", "rasterize_pallas.py:185",
                     dense_bwd_launches + sharded["B4"], res_dense_bwd),
        # T1 stands for XLA's fusion of the CRF chain (no pallas_call there):
        # its forward on the frame's inputs, its backward on the step's
        dict(kernel_entry("crf_mlp_fwd", "", t1_launches[0], t1_frame),
             name="crf_fused", replaces="casualhdrsplat_tpu/models/crf.py:132"),
        dict(kernel_entry("crf_mlp_bwd", "", t1_launches[1], t1_step[1]),
             name="crf_fused_bwd", replaces="casualhdrsplat_tpu/models/crf.py:132"),
        # G1 stands for XLA's transpose of the packed stream gather (no
        # pallas_call there), measured on the training step's inputs: its
        # ms the backward as the path runs it, the index and the kernel
        # (kernel_ms the kernel alone); the library call is the
        # scatter_add_ the port ran before
        dict(at_ladder5(kernel_entry("stream_gather_bwd", "rasterize.py:310",
                                     train_g1_launches + cli_g1_launches + quality_g1_launches
                                     + bench_g1_launches + sharded["G1"] + ladder5[2],
                                     g1_step), ladder5[3]["G1"]),
             library_ms=g1_step["library_ms"], ms_includes="stream_gather_index",
             kernel_ms=g1_step["kernel_ms"]),
        # G1's index, the counting pass, by its own counter (its plain
        # version: the sort)
        kernel_entry("stream_gather_index", "rasterize.py:310",
                     sum(INDEX_LAUNCHES.values()), g1_step["index"]),
        # P1 stands for XLA's fusions of the projection chain (no
        # pallas_call there), measured on the training step's inputs (8
        # views); its plain version is the port's chain, forward and
        # autograd's backward
        dict(kernel_entry("projection_fwd", "", p1_launches[0], p1_step[0]),
             replaces="casualhdrsplat_tpu/models/gaussians.py:activate, ops/projection.py, "
                      "ops/binning.py:build_payload"),
        dict(kernel_entry("projection_bwd", "", p1_launches[1], p1_step[1]),
             replaces="casualhdrsplat_tpu/models/gaussians.py:activate, ops/projection.py, "
                      "ops/binning.py:build_payload"),
    ]
    idle = [k["name"] for k in kernels_line if k["launches"] <= 0]
    if idle:
        raise AssertionError(f"kernels the main path never launched: {idle}")
    if kernels_line[-3]["launches"] != kernels_line[-4]["launches"]:
        raise AssertionError(f"G1's index not once per G1 launch: {INDEX_LAUNCHES}")
    log(f"T1 on the training step's inputs: forward {json.dumps(t1_step[0])}, backward "
        f"{json.dumps(t1_step[1])}")
    log("P1 (ms, plain_ms, bound_ms), forward / backward: " + json.dumps(
        {r[0]["label"]: [[d[k] for k in ("ms", "plain_ms", "bound_ms")] for d in r]
         for r in (p1_step, p1_pose)}))
    log("eager and graphed windows: " + json.dumps(WINDOWS))
    log("pose aligners, ms a step: " + json.dumps(ALIGNER_MS))
    log(json.dumps({"kernels": kernels_line}))
    log(smi)  # as nvidia-smi gives them, on a line of its own
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # a failed phase: report it and exit non-zero
        traceback.print_exc()
        sys.exit(1)
