#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (casualhdrsplat_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every CUDA kernel of the port from csrc/ (one nvcc per source, all
   started together, sm_90a) and prints ptxas's register and spill lines.
3. Serves requests at the full width of the ladder4-full model
   (ModelConfig() defaults: 131,072 Gaussians, SH degree 3, 8 virtual
   views, MLP CRF with 32 units, 16x128 tiles, chunk 128, shared binning)
   on 800x800 images along an orbit: render_frame for 3 frames (the shared
   packed branch) and render_pose at 3 orbit angles in LDR and HDR (the
   per-view packed branch).  The weights are random, from a fixed seed.
4. Checks the outputs (finite, shaped, in range) and that every kernel of
   the path was launched on both branches (its launch count, zeroed just
   before the requests).
5. Trains at the same width: a synthetic casual video (4 frames of 800x800,
   8 virtual views each, a random cloud of 131,072 Gaussians) made on the
   card, a Trainer on PRESETS["ladder4"], one warm-up step and 5 timed
   steps.  Checks that every scalar is finite, that every parameter group
   moved, that the density-control statistics rose and that the forward and
   the backward kernel were each launched once per step (counts zeroed just
   before the steps).
6. Holds every kernel against its plain PyTorch version on the inputs the
   paths gave it, and the slices on the card against the same on the CPU
   at a small size (the rendered frame; the gradients of one training
   step).
7. Times each kernel with CUDA events at the paths' shapes, at the same
   frame on 16x16 tiles and at bench.py::build's shapes (16x16 tiles, 4
   views, 100k Gaussians), beside its plain version and its bound.
8. With --profile, prints the device time of a render_frame request, a
   render_pose request and a training step by kernel (torch.profiler).
9. Prints a `{"kernels": [...]}` line and, last, `{"ok": true, "device":
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
# fp32 operations of the compositor.  At every (evaluated stream slot,
# pixel): alpha (dx, dy, five products and three sums of the conic form,
# scale, min, exp, opacity product, clip, threshold select = 16).  Only at
# the pairs the slot touches (alpha >= threshold), the blend: w = alpha T,
# four multiply-adds, T *= 1 - alpha = 10.
ALPHA_OPS = 16
BLEND_OPS = 10
# The backward kernel, at touched pairs only: w (1); cg = c4 . g4 (7);
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
# card-vs-CPU gradient check uses the same tolerance.
BWD_ATOL_REL, BWD_RTOL = 1e-4, 1e-3
TRAIN_STEPS = 5


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


def capture_calls(name, fn):
    """Run fn() and return the arguments of every call it makes of
    ops/rasterize_packed.<name> (which still runs): `composite_stream`
    gets (stream, row_lo, row_hi, statics), `_backward_cuda`, the launcher
    of the backward kernel, (stream, row_lo, row_hi, out4, g4, statics)."""
    from casualhdrsplat_torch.ops import rasterize_packed as rp

    calls = []
    original = getattr(rp, name)

    def recorder(*args):
        calls.append(tuple(a.detach() if hasattr(a, "detach") else a for a in args))
        return original(*args)

    setattr(rp, name, recorder)
    try:
        fn()
    finally:
        setattr(rp, name, original)
    return calls


def grads_close(name, got, ref):
    """Raise unless `got` agrees with `ref` at the backward tolerance;
    returns the max abs error."""
    import torch

    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    if not torch.allclose(got, ref, atol=BWD_ATOL_REL * scale, rtol=BWD_RTOL):
        raise AssertionError(f"{name}: max abs err {err} against a largest value of {scale}")
    return err


def measure_backward(label, call, reps):
    """Kernel B2 vs its plain version on one captured call: agreement,
    times, bound.  Returns a dict of the numbers."""
    import torch

    from casualhdrsplat_torch.ops import rasterize_packed as rp

    stream, lo, hi, out4, g4, statics = call
    d = rp._backward_cuda(*call)
    with torch.no_grad():
        ref, plain_s = timed(lambda: rp.composite_stream_backward_reference(*call))
        _, work = rp.composite_stream_reference(stream, lo, hi, statics, return_work=True)
    if not bool(torch.isfinite(d).all()):
        raise AssertionError(f"backward[{label}]: non-finite gradient")
    err = grads_close(f"backward[{label}]: kernel vs plain version", d, ref)
    ms = event_ms(lambda: rp._backward_cuda(*call), reps)
    rows, p = lo.shape[0], statics.tile_h * statics.tile_w
    # stream read and gradient written once, out4 and g4 read once
    nbytes = 2 * stream.numel() * 4 + 2 * rows * 4 + 2 * (rows + 1) * 4 * p * 4
    ops = ALPHA_OPS * work.slots * p + BWD_TOUCHED_OPS * work.touched
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    res = dict(
        label=label, rows=rows, tile=f"{statics.tile_h}x{statics.tile_w}",
        chunk=statics.chunk, stream_rows=stream.shape[0],
        intersections=int((hi - lo).sum()), evaluated_slots=work.slots,
        touched_slot_pixels=work.touched, max_abs_err=err, largest_gradient=float(ref.abs().max()), allclose=True,
        ms=ms, plain_ms=plain_s * 1e3, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )
    log(f"backward[{label}]: " + json.dumps(res))
    return res


def measure_compositor(label, call, launches_per_request, reps):
    """Kernel vs plain version on one captured call: agreement, times,
    bound.  Returns a dict of the numbers."""
    import torch

    from casualhdrsplat_torch.ops import rasterize_packed as rp

    stream, lo, hi, statics = call
    out = rp.composite_stream(stream, lo, hi, statics)
    ref, work = rp.composite_stream_reference(stream, lo, hi, statics, return_work=True)
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    err = float(diff.max())
    off = diff > ATOL + RTOL * ref.abs()
    tie = work.tie_pixels[:, None, :]  # a tie pixel exempts its four channels
    ties, tie_outliers = int(work.tie_pixels.sum()), int((off & tie).sum())
    outliers = int((off & ~tie).sum())
    jump = 2.0 * statics.alpha_threshold * max(1.0, float(stream[:, 6:10].max()))
    ok = outliers == 0 and err <= jump
    ms = event_ms(lambda: rp.composite_stream(stream, lo, hi, statics), reps)
    plain_ms = event_ms(lambda: rp.composite_stream_reference(stream, lo, hi, statics),
                        max(2, reps // 10), warmup=1)
    rows, p = lo.shape[0], statics.tile_h * statics.tile_w
    nbytes = stream.numel() * 4 + 2 * rows * 4 + (rows + 1) * 4 * p * 4
    ops = ALPHA_OPS * work.slots * p + BLEND_OPS * work.touched
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    res = dict(
        label=label, rows=rows, tile=f"{statics.tile_h}x{statics.tile_w}",
        chunk=statics.chunk, stream_rows=stream.shape[0],
        intersections=int((hi - lo).sum()), evaluated_slots=work.slots,
        touched_slot_pixels=work.touched,
        launches_per_request=launches_per_request, max_abs_err=err,
        tie_pixels=ties, outliers_at_ties=tie_outliers, outliers_elsewhere=outliers,
        allclose=ok,
        ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )
    log(f"compositor[{label}]: " + json.dumps(res))
    if not ok:
        raise AssertionError(f"compositor[{label}]: kernel disagrees with its plain "
                             f"version at {outliers} elements away from a threshold "
                             f"tie, max abs err {err}")
    return res


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


def train_phase(device, rp):
    """The training path at the full width of ladder4-full: returns
    (launches of B1, launches of B2, the B2 measurement at its shape)."""
    import torch

    from casualhdrsplat_torch import config
    from casualhdrsplat_torch.data import dataset as dataset_mod
    from casualhdrsplat_torch.models import gaussians as gauss_mod
    from casualhdrsplat_torch.train import optim
    from casualhdrsplat_torch.train.trainer import Trainer

    cfg = config.PRESETS["ladder4"]()
    # Density control off: its rounds are not ported yet, and without its SH
    # warm-up the run has all 16 coefficients from step 0.  The preset's own
    # max_steps stays, so every learning rate is the one a run starts with.
    cfg.densify.enabled = False
    cfg.eval_every = 0
    cfg.data.eval_every = 0
    m = cfg.model
    dataset, t_data = timed(lambda: dataset_mod.make_synthetic_dataset(
        seed=SEED, device=device, renderer="fast", n_gaussians=m.max_gaussians,
        n_frames=N_FRAMES, n_virtual=m.num_virtual_views, size=SIZE,
        scale_range=(0.004, 0.02), angle_span=0.12, exposure_range=(0.4, 0.8)))
    log(f"training data: {dataset.images.shape[0]} frames of {SIZE}x{SIZE} rendered from "
        f"{len(dataset.points_xyz)} Gaussians in {t_data:.2f} s")

    # gaussians.create runs the k-NN scale init on the host: set-up, timed
    knn_s = []
    knn = gauss_mod.knn_mean_dist

    def timed_knn(*args, **kw):
        t0 = time.perf_counter()
        out = knn(*args, **kw)
        knn_s.append(time.perf_counter() - t0)
        return out

    gauss_mod.knn_mean_dist = timed_knn
    try:
        trainer, t_init = timed(lambda: Trainer(cfg, dataset, device=device))
    finally:
        gauss_mod.knn_mean_dist = knn
    alive = int(trainer.params["gaussians"]["alive"].sum())
    log(f"trainer: {alive} of {m.max_gaussians} Gaussians alive, SH degree "
        f"{trainer.active_sh_degree()}, {m.num_virtual_views} virtual views, shared binning "
        f"{cfg.model.rasterize.shared_binning}; set-up {t_init:.2f} s, of which the host "
        f"k-NN {sum(knn_s):.2f} s")
    if alive != m.max_gaussians or trainer.active_sh_degree() != m.sh_degree:
        raise AssertionError("the trainer does not run at the model's full width")

    _, t_warm = timed(trainer.run_step)
    log(f"warm-up step: {t_warm:.3f} s")
    before = {path: leaf.clone() for path, _, leaf in optim.labelled_leaves(trainer.params)}
    count_before = int(trainer.adc.count.sum())
    torch.cuda.reset_peak_memory_stats()
    rp.FWD_KERNEL.launches = rp.BWD_KERNEL.launches = 0
    step_s = []
    for _ in range(TRAIN_STEPS):
        out, dt = timed(trainer.run_step)
        step_s.append(dt)
        log(f"step {trainer.step}: {dt * 1e3:.2f} ms, loss {out['loss']:.5f}, psnr "
            f"{out['psnr']:.3f}, dropped {out['dropped']:.0f}, clipped {out['clipped']:.0f}")
        if not all(np.isfinite(v) for v in out.values()):
            raise AssertionError(f"step {trainer.step}: non-finite scalars {out}")
    fwd_launches, bwd_launches = rp.FWD_KERNEL.launches, rp.BWD_KERNEL.launches
    mpix = SIZE * SIZE * m.num_virtual_views / np.median(step_s) / 1e6
    log(f"training: step median {np.median(step_s) * 1e3:.2f} ms = {mpix:.2f} Mpix/s "
        f"fwd+bwd ({SIZE}x{SIZE} x {m.num_virtual_views} views per step), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"launches over {TRAIN_STEPS} steps: {rp.FWD_KERNEL.symbol} {fwd_launches}, "
        f"{rp.BWD_KERNEL.symbol} {bwd_launches}")
    if fwd_launches != TRAIN_STEPS or bwd_launches != TRAIN_STEPS:
        raise AssertionError("each training step must launch each compositor kernel once")
    for path, label, leaf in optim.labelled_leaves(trainer.params):
        if not bool(torch.isfinite(leaf.float()).all()):
            raise AssertionError(f"parameter {path} holds non-finite values")
        if label != "frozen" and torch.equal(leaf, before[path]):
            raise AssertionError(f"parameter {path} did not move in {TRAIN_STEPS} steps")
    if int(trainer.adc.count.sum()) <= count_before:
        raise AssertionError("the density-control visibility counts did not rise")
    del before

    # kernel B2 on the inputs a training step gives it
    frame = int(trainer.dataset.train_indices[1])
    bwd_call, = capture_calls("_backward_cuda", lambda: trainer.loss_and_grads(frame))
    res = measure_backward("train_step", bwd_call, reps=10)
    with torch.no_grad():
        measure_compositor("train_step_forward", bwd_call[:3] + bwd_call[5:], 1, reps=10)
    del bwd_call
    if "--profile" in sys.argv[1:]:
        profile_window("train_step", trainer.run_step)
    return fwd_launches, bwd_launches, res


def bench_shapes(device):
    """Both kernels at bench.py::build's workload: 100k Gaussians, 4 views,
    16x16 tiles, chunk 128."""
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

    bwd_call, = capture_calls("_backward_cuda", fwd_bwd)
    with torch.no_grad():
        measure_compositor("bench_16x16", bwd_call[:3] + bwd_call[5:], 1, reps=20)
    measure_backward("bench_16x16", bwd_call, reps=20)


def kernel_entry(name, line, launches, res):
    return {
        "name": name,
        "route": "cuda",
        "source": f"casualhdrsplat_torch/csrc/{name}.cu",
        "replaces": f"casualhdrsplat_tpu/ops/rasterize_packed.py:{line}",
        "launches": launches,
        "max_abs_err": res["max_abs_err"],
        "ms": res["ms"],
        "plain_ms": res["plain_ms"],
        "bound_ms": res["bound_ms"],
        "bound_by": res["bound_by"],
        "library_ms": None,  # no single PyTorch call computes either function
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only on the card",
              file=sys.stderr)
        return 2
    from casualhdrsplat_torch.data import synthetic
    from casualhdrsplat_torch.models import image_formation as imf
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
    kernels = (rp.FWD_KERNEL, rp.BWD_KERNEL)
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
            "composite_stream", lambda: imf.render_frame(params, scene, 1, cfg))
        pose_call, = capture_calls(
            "composite_stream",
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
            "composite_stream", lambda: imf.render_frame(params, scene, 1, cfg16))
        measure_compositor("render_frame_16x16", frame16_call, 1, reps=20)
        del frame16_call
        if "--profile" in sys.argv[1:]:
            profile_window("render_frame", lambda: imf.render_frame(params, scene, 1, cfg))
            profile_window("render_pose", lambda: imf.render_pose(
                params, scene, pose_vms[1], cfg, exposure=exposure))
        del params

    serve_launches = launches
    train_fwd_launches, train_bwd_launches, res_bwd = train_phase(device, rp)
    bench_shapes(device)
    with torch.inference_mode():
        small_slice_check(device)
    small_train_step_check(device)

    kernels_line = [
        # both main paths launch the forward kernel: the requests and the steps
        kernel_entry("rasterize_packed_fwd", 99, serve_launches + train_fwd_launches,
                     res_frame),
        kernel_entry("rasterize_packed_bwd", 201, train_bwd_launches, res_bwd),
    ]
    log(json.dumps({"kernels": kernels_line}))
    log(smi)  # as nvidia-smi gives them, on a line of its own
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)  # the run used device 0 alone
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # a failed phase: report it and exit non-zero
        traceback.print_exc()
        sys.exit(1)
