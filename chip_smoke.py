#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (casualhdrsplat_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every CUDA kernel of the serving path from csrc/ (nvcc, sm_90a).
3. Serves requests at the full width of the ladder4-full model
   (ModelConfig() defaults: 131,072 Gaussians, SH degree 3, 8 virtual
   views, MLP CRF with 32 units, 16x128 tiles, chunk 128, shared binning)
   on 800x800 images along an orbit: render_frame for 3 frames (the shared
   packed branch) and render_pose at 3 orbit angles in LDR and HDR (the
   per-view packed branch).  The weights are random, from a fixed seed.
4. Checks the outputs (finite, shaped, in range) and that every kernel of
   the path was launched on both branches (its launch count, zeroed just
   before the requests).
5. Holds every kernel against its plain PyTorch version on the inputs the
   path gave it, and the whole slice on the card against the slice on the
   CPU at a small size.
6. Times each kernel with CUDA events at the path's shapes, at the same
   frame on 16x16 tiles and at bench.py::build's shapes (16x16 tiles, 4
   views, 100k Gaussians), beside its plain version and its bound.
7. With --profile, prints the device time of a render_frame and a
   render_pose request by kernel (torch.profiler).
8. Prints a `{"kernels": [...]}` line and, last, `{"ok": true, "device":
   {...}}`.

Any failed phase exits non-zero without the last line.  There is no CPU
fallback: without a CUDA device the script exits 2 at once.
"""

from __future__ import annotations

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
# Peak rates of an H100 SXM (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# fp32 operations per (stream slot, pixel) in the compositor: alpha
# (dx, dy, five products and three sums of the conic form, scale, min,
# exp, opacity product, clip, threshold select = 16) and the blend
# (w = alpha T, four multiply-adds, T *= 1 - alpha = 10).
OPS_PER_SLOT_PIXEL = 26


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

    cfg = config.PRESETS["ladder4"]()
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


def capture_composite_calls(fn):
    """Run fn() and return the (stream, row_lo, row_hi, statics) of every
    compositor call it makes (the kernel still runs)."""
    from casualhdrsplat_torch.ops import rasterize_packed as rp

    calls = []
    original = rp.composite_stream

    def recorder(stream, lo, hi, statics):
        calls.append((stream, lo, hi, statics))
        return original(stream, lo, hi, statics)

    rp.composite_stream = recorder
    try:
        fn()
    finally:
        rp.composite_stream = original
    return calls


def measure_compositor(label, call, launches_per_request, reps):
    """Kernel vs plain version on one captured call: agreement, times,
    bound.  Returns a dict of the numbers."""
    import torch

    from casualhdrsplat_torch.ops import rasterize_packed as rp

    stream, lo, hi, statics = call
    out = rp.composite_stream(stream, lo, hi, statics)
    ref, work = rp.composite_stream_reference(stream, lo, hi, statics, return_work=True)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    ok = bool(torch.allclose(out, ref, atol=ATOL, rtol=RTOL))
    ms = event_ms(lambda: rp.composite_stream(stream, lo, hi, statics), reps)
    plain_ms = event_ms(lambda: rp.composite_stream_reference(stream, lo, hi, statics),
                        max(2, reps // 10), warmup=1)
    rows, p = lo.shape[0], statics.tile_h * statics.tile_w
    nbytes = stream.numel() * 4 + 2 * rows * 4 + (rows + 1) * 4 * p * 4
    ops = work * p * OPS_PER_SLOT_PIXEL
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    res = dict(
        label=label, rows=rows, tile=f"{statics.tile_h}x{statics.tile_w}",
        chunk=statics.chunk, stream_rows=stream.shape[0],
        intersections=int((hi - lo).sum()), evaluated_slots=work,
        launches_per_request=launches_per_request, max_abs_err=err, allclose=ok,
        ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )
    log(f"compositor[{label}]: " + json.dumps(res))
    if not ok:
        raise AssertionError(f"compositor[{label}]: kernel disagrees with its plain "
                             f"version, max abs err {err}")
    return res


def profile_requests(params, scene, cfg, viewmat, exposure, reps=3):
    """Device time by kernel over `reps` render_frame and `reps`
    render_pose requests (torch.profiler), against the host-clock wall
    time of the same window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from casualhdrsplat_torch.models import image_formation as imf

    for name, request in (
        ("render_frame", lambda: imf.render_frame(params, scene, 1, cfg)),
        ("render_pose", lambda: imf.render_pose(params, scene, viewmat, cfg,
                                                exposure=exposure)),
    ):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = timed(lambda: [request() for _ in range(reps)])
        # kernels only: the aten ops that launch them carry the same time
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in events) / 1e3  # us -> ms
        log(f"profile[{name}]: {reps} requests, wall {wall * 1e3 / reps:.2f} ms, "
            f"device busy {busy / reps:.2f} ms per request "
            f"({100 * busy / (wall * 1e3):.1f}% of wall)")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
            t = e.self_device_time_total / 1e3 / reps
            log(f"  {t:9.3f} ms/request {e.count // reps:5d} launches  {e.key[:90]}")


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only on the card",
              file=sys.stderr)
        return 2
    from casualhdrsplat_torch.config import RasterizeConfig
    from casualhdrsplat_torch.data import synthetic
    from casualhdrsplat_torch.geometry import spline
    from casualhdrsplat_torch.models import image_formation as imf
    from casualhdrsplat_torch.ops import rasterize as rast
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
    t0 = time.perf_counter()
    rp.FWD_KERNEL.load()
    log(f"built {rp.FWD_KERNEL.library_path.name} in {time.perf_counter() - t0:.2f} s")
    for line in rp.FWD_KERNEL.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

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
        frame_call, = capture_composite_calls(lambda: imf.render_frame(params, scene, 1, cfg))
        pose_call, = capture_composite_calls(
            lambda: imf.render_pose(params, scene, pose_vms[1], cfg, exposure=exposure))
        res_frame = measure_compositor("render_frame", frame_call, 1, reps=20)
        measure_compositor("render_pose", pose_call, 1, reps=20)
        del frame_call, pose_call

        # the same frame on 16x16 tiles: what the default 16x128 tile costs
        cfg16 = dataclasses.replace(
            cfg, rasterize=dataclasses.replace(cfg.rasterize, tile_w=16))
        _, dt16 = timed(lambda: imf.render_frame(params, scene, 1, cfg16))
        log(f"render_frame(1) on 16x16 tiles: {dt16 * 1e3:.2f} ms")
        frame16_call, = capture_composite_calls(
            lambda: imf.render_frame(params, scene, 1, cfg16))
        measure_compositor("render_frame_16x16", frame16_call, 1, reps=20)
        del frame16_call
        if "--profile" in sys.argv[1:]:
            profile_requests(params, scene, cfg, pose_vms[1], exposure)
        del params

        # bench.py::build's workload: 100k Gaussians, 4 views, 16x16 tiles
        rng = np.random.default_rng(SEED)
        cloud = synthetic.random_cloud(rng, 100_000, scale_range=(0.004, 0.02),
                                       device=device)
        cam = synthetic.orbit_camera(0.0, width=SIZE, img_height=SIZE, device=device)
        knots = synthetic.orbit_knots(6, angle_span=0.12, width=SIZE, img_height=SIZE,
                                      device=device)
        vms = spline.cubic_bspline_interpolation(
            knots, -2.0, 1.0, spline.sample_virtual_times(torch.tensor(1.0, device=device),
                                                          0.6, 4))
        bench_cfg = RasterizeConfig(tile_h=16, tile_w=16, chunk=128)
        bench_call, = capture_composite_calls(lambda: rast.rasterize(
            cloud.means3d, cloud.quats, cloud.scales, cloud.opacities, cloud.colors, vms,
            cam.fx, cam.fy, cam.cx, cam.cy, SIZE, SIZE, bench_cfg))
        measure_compositor("bench_16x16", bench_call, 1, reps=20)
        del bench_call
        small_slice_check(device)

    kernels = [{
        "name": "rasterize_packed_fwd",
        "route": "cuda",
        "source": "casualhdrsplat_torch/csrc/rasterize_packed_fwd.cu",
        "replaces": "casualhdrsplat_tpu/ops/rasterize_packed.py:99",
        "launches": launches,
        "max_abs_err": res_frame["max_abs_err"],
        "ms": res_frame["ms"],
        "plain_ms": res_frame["plain_ms"],
        "bound_ms": res_frame["bound_ms"],
        "bound_by": res_frame["bound_by"],
        "library_ms": None,
    }]
    log(json.dumps({"kernels": kernels}))
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
