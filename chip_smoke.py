#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (casualhdrsplat_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every CUDA kernel of the port from csrc/ (one nvcc per source, all
   started together, sm_90a) and prints ptxas's register and spill lines.
3. Packed serving at the full width of the ladder4-full model
   (ModelConfig() defaults: 131,072 Gaussians, SH degree 3, 8 virtual
   views, MLP CRF with 32 units, 16x128 tiles, chunk 128, shared binning)
   on 800x800 images along an orbit: render_frame for 3 frames (the shared
   packed branch) and render_pose at 3 orbit angles in LDR and HDR (the
   per-view packed branch).  The weights are random, from a fixed seed.
   Checks the outputs (finite, shaped, in range) and that the forward
   kernel was launched on both branches (its count, zeroed just before).
4. Dense serving of the same model with RasterizeConfig(packed=False,
   16x16 tiles, capacity 1024, chunk 128): 2 render_frame and 2 render_pose
   requests, outputs checked, one launch of the dense forward kernel per
   request, the capacity overflow logged; and, on a 16,384-Gaussian part of
   the model where neither path drops anything, the dense frame against the
   packed frame on the same tiles.
5. Packed training at the same width: a synthetic casual video (4 frames of
   800x800, 8 virtual views each, a random cloud of 131,072 Gaussians) made
   on the card, a Trainer on PRESETS["ladder4"] with density control off,
   one warm-up step and 5 timed steps.  Checks that every scalar is finite,
   that every parameter group moved, that the density-control statistics
   rose and that the packed forward and backward kernels were each launched
   once per step (counts zeroed just before the steps).
6. Dense training on the same video: a Trainer on PRESETS["ladder4"] with
   the dense RasterizeConfig and density control on, its store built from
   98,304 of the cloud's points so that a round finds free slots; 3 warm-up
   steps through the SH warm-up, then 5 timed steps at SH degree 3 that
   cross one densify round and one opacity reset.  Checks: the dense
   kernels launched once a step each, scalars finite, every group moved,
   the round cloned or split, `alive` rose by what it granted less what it
   pruned, the moments of the new slots are zero, the reset clamped every
   opacity.
7. Holds every kernel against its plain PyTorch version on the inputs the
   paths gave it (pixels at a threshold tie exempt, forward and backward;
   each backward run twice for equal bits), and the
   slices on the card against the same on the CPU at a small size (the
   rendered frame; the gradients of one packed training step; a dense
   training step, a densify round and the step after it).
8. Times each kernel with CUDA events at the paths' shapes, the packed ones
   also at the same frame on 16x16 tiles and at bench.py::build's shapes
   (16x16 tiles, 4 views, 100k Gaussians), beside its plain version and its
   bound; and the dense path's payload gather and its transpose beside
   autograd's own transpose.
9. With --profile, prints the device time of a render_frame request, a
   render_pose request and a training step by kernel (torch.profiler), on
   both paths.
10. Prints a `{"kernels": [...]}` line and, last, `{"ok": true, "device":
   {...}}`.

Any failed phase exits non-zero without the last line.  There is no CPU
fallback: without a CUDA device the script exits 2 at once.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import subprocess
import sys
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
# Alpha: dx, dy, five products and three sums of the conic form, scale,
# min, exp, opacity product, clip, threshold select = 16.  The forward's
# blend: w = alpha T, four multiply-adds, T *= 1 - alpha = 10.
ALPHA_OPS = 16
BLEND_OPS = 10
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
# its weight.  The scatter-add of the gather's transpose runs as float
# atomics on the card, in an order that changes from run to run: the
# card-vs-CPU gradient check uses the same tolerance.  The gradient jumps at
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


def capture_calls(module, name, fn):
    """Run fn() and return the arguments of every call it makes of
    `module.<name>` (which still runs), tensors detached."""
    calls = []
    original = getattr(module, name)

    def recorder(*args, **kw):
        calls.append(tuple(a.detach() if hasattr(a, "detach") else a for a in args))
        return original(*args, **kw)

    setattr(module, name, recorder)
    try:
        fn()
    finally:
        setattr(module, name, original)
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
    bound_ms, bound_by = roofline(nbytes(work), (ALPHA_OPS + BLEND_OPS) * work.touched)
    res = dict(
        label=label, **meta, evaluated_slots=work.slots, touched_slot_pixels=work.touched,
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


def measure_gradient(label, kernel, plain, g4, work, nbytes, p, reps, **meta):
    """A backward kernel vs its plain version on one input: agreement (two
    launches must also give the same bits), times, bound.  `kernel(g4)` and
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
    if not torch.equal(d, kernel(g4)):
        raise AssertionError(f"backward[{label}]: two launches differ in their bits")
    del d, ref
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
        touched_share=work.touched / max(1, work.slots * p),
        max_abs_err=err, largest_gradient=largest, tie_pixels=ties, outliers=outliers,
        max_abs_err_off_ties=err_off_ties, outliers_off_ties=outliers_off_ties,
        allclose=ok, deterministic=True,
        ms=ms, plain_ms=plain_s * 1e3, bound_ms=bound_ms, bound_by=bound_by,
    )
    log(f"backward[{label}]: " + json.dumps(res))
    if not ok:
        raise AssertionError(
            f"backward[{label}]: kernel disagrees with its plain version at "
            f"{outliers_off_ties} elements with the tie pixels left out, max abs err "
            f"{err_off_ties} against a largest value of {largest}")
    return res


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


def _table_meta(gathered, counts, statics):
    return dict(tiles=gathered.shape[0], tile=f"{statics.tile_h}x{statics.tile_w}",
                chunk=statics.chunk, capacity=gathered.shape[1],
                occupied_slots=int(counts.sum()), fullest_tile=int(counts.max()))


def measure_dense_forward(label, call, launches_per_request, reps):
    """Kernel B3 vs its plain version on one captured call of its launcher
    (gathered, tile_indices, counts, statics).  The function reads the
    occupied rows of the lists it visits and writes every tile."""
    from casualhdrsplat_torch.ops import composite, rasterize_dense

    gathered, ti, counts, statics = call
    tt, p = gathered.shape[0], statics.tile_h * statics.tile_w
    return measure_forward(
        label, lambda: rasterize_dense.forward(*call),
        lambda work: composite.composite_tiles_reference(*call, return_work=work),
        float(gathered[..., 6:10].max()), statics.alpha_threshold,
        lambda work: work.slots * 64 + 2 * tt * 4 + tt * 4 * p * 4, p, reps,
        launches_per_request=launches_per_request, **_table_meta(gathered, counts, statics))


def measure_dense_backward(label, call, reps):
    """Kernel B4 vs its plain version on one captured call of its launcher
    (gathered, tile_indices, counts, out4, g4, statics).  The function reads
    the occupied rows it visits, out4 and g4, and writes the whole gradient
    table, occupied or not."""
    import torch

    from casualhdrsplat_torch.ops import composite, rasterize_dense

    gathered, ti, counts, out4, g4, statics = call
    with torch.no_grad():
        _, work = composite.composite_tiles_reference(gathered, ti, counts, statics,
                                                      return_work=True)
    tt, p = gathered.shape[0], statics.tile_h * statics.tile_w
    nbytes = work.slots * 64 + 2 * tt * 4 + 2 * tt * 4 * p * 4 + gathered.numel() * 4
    return measure_gradient(
        label, lambda g: rasterize_dense.backward(gathered, ti, counts, out4, g, statics),
        lambda g: composite.composite_tiles_backward_reference(gathered, ti, counts, out4, g,
                                                               statics),
        g4, work, nbytes, p, reps,
        **_table_meta(gathered, counts, statics))


def profile_window(name, fn, reps=3):
    """Device time by kernel over `reps` calls of fn() (torch.profiler),
    against the host-clock wall time of the same window."""
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
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:16]:
        t = e.self_device_time_total / 1e3 / reps
        log(f"  {t:9.3f} ms/call {e.count // reps:5d} launches  {e.key[:90]}")


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


def small_train_step_check(device):
    """One training step's gradients on the card (kernels B1 and B2, the
    scatter-add of the gather's transpose as atomics) against the same on
    the CPU (the plain versions), at 64x64, for every parameter group and
    the means2d tap."""
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
    """(Trainer, its set-up seconds, of which the k-NN scale init on the
    card)."""
    from casualhdrsplat_torch.models import gaussians as gauss_mod
    from casualhdrsplat_torch.train.trainer import Trainer

    knn_s = []
    knn = gauss_mod.knn_mean_dist

    def timed_knn(*args, **kw):
        out, dt = timed(lambda: knn(*args, **kw))
        knn_s.append(dt)
        return out

    gauss_mod.knn_mean_dist = timed_knn
    try:
        trainer, t_init = timed(lambda: Trainer(cfg, dataset, device=device))
    finally:
        gauss_mod.knn_mean_dist = knn
    return trainer, t_init, sum(knn_s)


def run_timed_steps(trainer, steps, kernels, after_step=None):
    """`steps` timed run_step calls with the launch counts of `kernels`
    zeroed just before: checks finite scalars, one launch of each kernel per
    step, finite parameters, every floating group moved, the visibility
    counts rose (unless a round zeroed them).  Returns the step seconds."""
    import torch

    from casualhdrsplat_torch.train import optim

    m = trainer.cfg.model
    before = {path: leaf.clone() for path, _, leaf in optim.labelled_leaves(trainer.params)}
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    step_s = []
    for _ in range(steps):
        out, dt = timed(trainer.run_step)
        step_s.append(dt)
        log(f"step {trainer.step}: {dt * 1e3:.2f} ms, " + ", ".join(
            f"{k} {v:.5f}" if k in ("loss", "psnr") else f"{k} {v:.0f}"
            for k, v in out.items()))
        if not all(np.isfinite(v) for v in out.values()):
            raise AssertionError(f"step {trainer.step}: non-finite scalars {out}")
        if after_step is not None:
            after_step(out)
    mpix = SIZE * SIZE * m.num_virtual_views / np.median(step_s) / 1e6
    log(f"training: step median {np.median(step_s) * 1e3:.2f} ms = {mpix:.2f} Mpix/s "
        f"fwd+bwd ({SIZE}x{SIZE} x {m.num_virtual_views} views per step), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"launches over {steps} steps: "
        + ", ".join(f"{k.symbol} {k.launches}" for k in kernels))
    if any(k.launches != steps for k in kernels):
        raise AssertionError("each training step must launch each compositor kernel once")
    for path, label, leaf in optim.labelled_leaves(trainer.params):
        if not bool(torch.isfinite(leaf.float()).all()):
            raise AssertionError(f"parameter {path} holds non-finite values")
        if label != "frozen" and torch.equal(leaf, before[path]):
            raise AssertionError(f"parameter {path} did not move in {steps} steps")
    return step_s


def train_phase(device, dataset, rp):
    """The packed training path at the full width of ladder4-full: returns
    (launches of B1, launches of B2, the B2 measurement at its shape)."""
    import torch

    from casualhdrsplat_torch import config

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
        f"on the card {t_knn:.2f} s")
    if alive != m.max_gaussians or trainer.active_sh_degree() != m.sh_degree:
        raise AssertionError("the trainer does not run at the model's full width")

    _, t_warm = timed(trainer.run_step)
    log(f"warm-up step: {t_warm:.3f} s")
    count_before = int(trainer.adc.count.sum())
    run_timed_steps(trainer, TRAIN_STEPS, (rp.FWD_KERNEL, rp.BWD_KERNEL))
    fwd_launches, bwd_launches = rp.FWD_KERNEL.launches, rp.BWD_KERNEL.launches
    if int(trainer.adc.count.sum()) <= count_before:
        raise AssertionError("the density-control visibility counts did not rise")

    # kernel B2 on the inputs a training step gives it
    frame = int(trainer.dataset.train_indices[1])
    bwd_call, = capture_calls(rp, "_backward_cuda", lambda: trainer.loss_and_grads(frame))
    res = measure_backward("train_step", bwd_call, reps=10)
    with torch.no_grad():
        measure_compositor("train_step_forward", bwd_call[:3] + bwd_call[6:], 1, reps=10)
    del bwd_call
    if "--profile" in sys.argv[1:]:
        profile_window("train_step", trainer.run_step)
    return fwd_launches, bwd_launches, res


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


def gather_transpose_times(call):
    """The dense path's payload gather and its transpose at the training
    step's table, beside autograd's own transpose of the same gather (which
    adds every pad slot into the one pad row): CUDA-event times."""
    import torch

    from casualhdrsplat_torch.ops import binning

    gathered, _, counts, _ = call[:4]
    tt, cap, _ = gathered.shape
    # a table with the step's occupancy: tile i holds counts[i] ids, then pads
    n = 131_072
    slot = torch.arange(cap, device=gathered.device)[None, :]
    ids = (torch.arange(tt, device=gathered.device)[:, None] * 7919 + slot * 104729) % n
    table = torch.where(slot < counts[:, None], ids, n).to(torch.int32)
    payload = torch.randn((n + 1, 16), device=gathered.device, requires_grad=True)
    tiles = binning.TileLists(table, counts, None, None)
    grad = torch.randn_like(gathered)
    fwd_ms = event_ms(lambda: binning.gather_payload(payload, tiles), 5)
    out = binning.gather_payload(payload, tiles)
    bwd_ms = event_ms(lambda: torch.autograd.grad(out, payload, grad, retain_graph=True), 5)
    del out
    index = table.long()
    own = payload[index]
    own_ms = event_ms(lambda: torch.autograd.grad(own, payload, grad, retain_graph=True), 1,
                      warmup=0)
    log(f"gather of {tt * cap} rows ({int(counts.sum())} occupied): {fwd_ms:.3f} ms; its "
        f"transpose with the pad slots spread over spare rows: {bwd_ms:.3f} ms; autograd's "
        f"own transpose of payload[index]: {own_ms:.3f} ms")


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
        f"{m.rasterize.tile_capacity}; set-up {t_init:.2f} s, of which the k-NN on the "
        f"card {t_knn:.2f} s")
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
    run_timed_steps(trainer, TRAIN_STEPS, (rd.FWD_KERNEL, rd.BWD_KERNEL), after_step)
    fwd_launches, bwd_launches = rd.FWD_KERNEL.launches, rd.BWD_KERNEL.launches
    if len(reports) != 1 or trainer.step < DENSE_RESET_STEP:
        raise AssertionError("the timed steps must cross one densify round and one reset")

    # kernels B3 and B4 on the inputs a dense training step gives them
    frame = int(trainer.dataset.train_indices[1])
    bwd_call, = capture_calls(rd, "backward", lambda: trainer.loss_and_grads(frame))
    res = measure_dense_backward("dense_train_step", bwd_call, reps=10)
    with torch.no_grad():
        measure_dense_forward("dense_train_step_forward", bwd_call[:3] + bwd_call[5:], 1,
                              reps=10)
    gather_transpose_times(bwd_call)
    del bwd_call
    if "--profile" in sys.argv[1:]:
        profile_window("dense_train_step", trainer.run_step)
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


def bench_shapes(device):
    """Both kernels at bench.py::build's workload: 100k Gaussians, 4 views,
    16x16 tiles, chunk 128."""
    import torch

    from casualhdrsplat_torch.config import RasterizeConfig
    from casualhdrsplat_torch.data import synthetic
    from casualhdrsplat_torch.geometry import spline
    from casualhdrsplat_torch.ops import rasterize as rast
    from casualhdrsplat_torch.ops import rasterize_packed as rp

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

    bwd_call, = capture_calls(rp, "_backward_cuda", fwd_bwd)
    with torch.no_grad():
        measure_compositor("bench_16x16", bwd_call[:3] + bwd_call[6:], 1, reps=20)
    measure_backward("bench_16x16", bwd_call, reps=20)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only on the card",
              file=sys.stderr)
        return 2
    from casualhdrsplat_torch.data import synthetic
    from casualhdrsplat_torch.models import image_formation as imf
    from casualhdrsplat_torch.ops import rasterize_dense as rd
    from casualhdrsplat_torch.ops import rasterize_packed as rp

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- build ---------------------------------------------------------------
    # one nvcc per source, all started together
    kernels = (rp.FWD_KERNEL, rp.BWD_KERNEL, rd.FWD_KERNEL, rd.BWD_KERNEL)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        for future in [pool.submit(k.load) for k in kernels]:
            future.result()
    log(f"built {', '.join(k.library_path.name for k in kernels)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for k in kernels:
        for line in k.build_log().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {k.source_name}: {line.strip()}")

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
    frame_s, pose_s = [], []
    with torch.inference_mode():
        for fid in range(3):
            out, dt = timed(lambda: imf.render_frame(params, scene, fid, cfg))
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
                check_image(f"pose {a} {'hdr' if hdr else 'ldr'}", img, (SIZE, SIZE, 3),
                            0.0, None if hdr else 1.0)
                log(f"render_pose(angle={a}, hdr={hdr}): {dt * 1e3:.2f} ms, dropped "
                    f"{int(aux.num_dropped)}")
    launches = rp.FWD_KERNEL.launches
    pose_launches = launches - frame_launches
    log(f"serving: render_frame median {np.median(frame_s) * 1e3:.2f} ms, "
        f"render_pose median {np.median(pose_s) * 1e3:.2f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"launches of {rp.FWD_KERNEL.symbol}: {frame_launches} on the shared branch "
        f"(3 render_frame), {pose_launches} on the per-view branch (6 render_pose)")
    if frame_launches < 3 or pose_launches < 6:
        raise AssertionError("the compositor kernel was not launched on both branches")

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
        if "--profile" in sys.argv[1:]:
            profile_window("render_frame", lambda: imf.render_frame(params, scene, 1, cfg))
            profile_window("render_pose", lambda: imf.render_pose(
                params, scene, pose_vms[1], cfg, exposure=exposure))

    serve_launches = launches
    dense_serve_launches, res_dense_fwd = dense_serving_phase(
        device, cfg, scene, params, pose_vms, exposure, rd)
    del params
    dataset = make_training_data(device)
    train_fwd_launches, train_bwd_launches, res_bwd = train_phase(device, dataset, rp)
    dense_fwd_launches, dense_bwd_launches, res_dense_bwd = dense_train_phase(
        device, dataset, rd)
    del dataset
    bench_shapes(device)
    with torch.inference_mode():
        small_slice_check(device)
    small_train_step_check(device)
    small_dense_train_check(device)

    kernels_line = [
        # each forward kernel is launched by its path's requests and steps
        kernel_entry("rasterize_packed_fwd", "rasterize_packed.py:99",
                     serve_launches + train_fwd_launches, res_frame),
        kernel_entry("rasterize_packed_bwd", "rasterize_packed.py:201",
                     train_bwd_launches, res_bwd),
        kernel_entry("rasterize_dense_fwd", "rasterize_pallas.py:104",
                     dense_serve_launches + dense_fwd_launches, res_dense_fwd),
        kernel_entry("rasterize_dense_bwd", "rasterize_pallas.py:185",
                     dense_bwd_launches, res_dense_bwd),
    ]
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
