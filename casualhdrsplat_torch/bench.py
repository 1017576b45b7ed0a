"""Headline benchmark of the port: rendered Mpix/s on one card, forward and
backward.  Counterpart of the reference's `bench.py`, on the same workload.

    python -m casualhdrsplat_torch.bench [--chunk N] [--stream-factor N]
        [--tile HxW] [--device cuda|cpu] [--sharded D[,G]] [--profile]

Measures the full differentiable image-formation chain (projection, tile
binning, the streaming compositor's kernel B1, CRF, blur mean, loss, then
the hand-written backward through kernel B2 and autograd to every
parameter group) and reports megapixels rendered per second: the median of
3 windows of 12 steps, each window ending in one host read of its summed
losses.  `vs_baseline = value / 10`, the reference's denominator (about 10
Mpix/s forward and backward for 3DGS-class training on an RTX-class GPU,
from the lineage's published speeds).

`--sharded D[,G]` runs the same workload through the sharded rasterizer
(parallel/render.py) on a (D, G) mesh (`build_sharded`; "4" means 4x1).
It bins every view on its own, where the default workload shares one
binning among the views, so on one card its ratio to the default is the
sharded code path's cost and that difference together.  1,1 runs in this
process on a world of one (nccl on the card, gloo on the CPU); a larger
mesh needs a launched world, one rank per card:

    torchrun --nproc_per_node=N -m casualhdrsplat_torch.bench --sharded D,G

On the card the step (`build`'s) replays as one captured CUDA graph, the
counterpart of the reference's `@jax.jit step` (utils/cuda_graphs.py: the
first call is an eager warm-up, the second captures); `step.eager` is the
same step without a graph, the yardstick.  `--sharded` runs eagerly.

`--profile` then runs one more window under torch.profiler and prints,
before the JSON line, its host wall and the card's busy time per step:
where the card is busy for much less than the wall, the host sets the
pace, and the windows vary with the host's load.

Prints the card's name and power limit, then one JSON line: {"metric",
"value", "unit", "vs_baseline", "median_of", "iters_per_window",
"spread_pct", "windows"} (with --sharded, from rank 0, per card).  Without
a CUDA device it exits 2 unless asked for the CPU with `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

N_WINDOWS, ITERS_PER_WINDOW = 3, 12
# untimed steps first: kernel loads and the allocator; on the card the
# first is the graph's eager warm-up, the second its capture
WARMUP_STEPS = 2


def build(n_gaussians=100_000, size=800, n_virtual=4, chunk=128, stream_factor=6,
          tile=(16, 16), device="cuda"):
    """(step, args, pixels per step): `step(*args)` returns the loss and its
    gradients with respect to the means, log-scales, opacity logits,
    colours, CRF parameters (a dict) and log exposure time, for one blurred
    frame of `n_virtual` views of a random cloud at size x size.  On a CUDA
    device `step` replays a CUDA graph (its outputs are the graph's, which
    the next call overwrites) and `step.eager` is the eager step."""
    from casualhdrsplat_torch.config import CRFConfig, RasterizeConfig
    from casualhdrsplat_torch.data import synthetic
    from casualhdrsplat_torch.geometry import spline
    from casualhdrsplat_torch.models import crf as crf_mod
    from casualhdrsplat_torch.models import losses
    from casualhdrsplat_torch.ops import rasterize as rast

    rng = np.random.default_rng(0)
    cloud = synthetic.random_cloud(rng, n_gaussians, scale_range=(0.004, 0.02),
                                   device=device)
    cam = synthetic.orbit_camera(0.0, width=size, img_height=size, device=device)
    knots = synthetic.orbit_knots(6, angle_span=0.12, width=size, img_height=size,
                                  device=device)
    t_k = spline.sample_virtual_times(torch.tensor(1.0, device=device), 0.6, n_virtual)
    viewmats = spline.cubic_bspline_interpolation(knots, -2.0, 1.0, t_k)

    cfg = RasterizeConfig(
        tile_h=tile[0], tile_w=tile[1], tile_capacity=1024, max_tiles_per_gaussian=32,
        chunk=chunk, backend="auto", stream_factor=stream_factor,
    )
    crf_cfg = CRFConfig(kind="mlp")
    crf_params = crf_mod.create(crf_cfg, torch.Generator().manual_seed(0), device=device)
    target = torch.as_tensor(rng.uniform(size=(size, size, 3)).astype(np.float32),
                             device=device)

    def step(means, log_scales, opacity_logit, colors, crf_p, log_dt):
        crf_keys = sorted(crf_p)
        leaves = [t.detach().requires_grad_(True) for t in
                  (means, log_scales, opacity_logit, colors, log_dt,
                   *(crf_p[k] for k in crf_keys))]
        means, log_scales, opacity_logit, colors, log_dt = leaves[:5]
        crf_leaves = dict(zip(crf_keys, leaves[5:]))
        hdr, _, _ = rast.rasterize(
            means, cloud.quats, torch.exp(log_scales), torch.sigmoid(opacity_logit),
            colors, viewmats, cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height, cfg,
        )
        ldr = crf_mod.apply(crf_leaves, hdr * torch.exp(log_dt), crf_cfg)
        loss = losses.photometric(ldr.mean(0), target, 0.2)
        g = torch.autograd.grad(loss, leaves)
        return loss.detach(), (g[0], g[1], g[2], g[3], dict(zip(crf_keys, g[5:])), g[4])

    args = (
        cloud.means3d,
        torch.log(cloud.scales),
        torch.log(cloud.opacities / (1 - cloud.opacities)),
        cloud.colors,
        crf_params,
        torch.tensor(0.0, device=device),
    )
    return _graphed(step, "bench's step"), args, size * size * n_virtual


def _graphed(step, name):
    """`step` replayed as a CUDA graph on CUDA tensors (captured over the
    arguments of its second call; other arguments capture again), the
    eager `step` elsewhere; `.eager` is the eager step."""
    from casualhdrsplat_torch.utils import cuda_graphs

    graphs = cuda_graphs.GraphCache()

    def flat(tree):
        if isinstance(tree, dict):
            return [t for k in sorted(tree) for t in flat(tree[k])]
        if isinstance(tree, (tuple, list)):
            return [t for x in tree for t in flat(x)]
        return [tree] if isinstance(tree, torch.Tensor) else []

    def graphed_step(*args):
        leaves = flat(args)
        if not leaves or not cuda_graphs.graphable(leaves[0].device):
            return step(*args)
        return graphs.get(None, leaves, lambda: cuda_graphs.GraphedCall(
            lambda: step(*args), name))()

    graphed_step.eager = step
    return graphed_step


def build_sharded(n_gaussians=100_000, size=800, n_virtual=4, mesh=None, device="cuda"):
    """(step, args, pixels per step) of `build`'s workload through the
    sharded rasterizer on `mesh` (parallel.mesh.Mesh over the initialized
    world): `step(store)` returns the loss of the blurred frame's clipped
    HDR mean and its gradients with respect to this rank's block of the
    store (its floating leaves); `args` holds that block."""
    from casualhdrsplat_torch.config import RasterizeConfig
    from casualhdrsplat_torch.data import synthetic
    from casualhdrsplat_torch.geometry import spline
    from casualhdrsplat_torch.models import gaussians as gauss_mod
    from casualhdrsplat_torch.models import losses
    from casualhdrsplat_torch.parallel import render as prender
    from casualhdrsplat_torch.parallel import sharding

    rng = np.random.default_rng(0)
    cloud = synthetic.random_cloud(rng, n_gaussians, scale_range=(0.004, 0.02),
                                   device=device)
    cam = synthetic.orbit_camera(0.0, width=size, img_height=size, device=device)
    knots = synthetic.orbit_knots(6, angle_span=0.12, width=size, img_height=size,
                                  device=device)
    t_k = spline.sample_virtual_times(torch.tensor(1.0, device=device), 0.6, n_virtual)
    viewmats = spline.cubic_bspline_interpolation(knots, -2.0, 1.0, t_k)
    cfg = RasterizeConfig(tile_h=16, tile_w=16, tile_capacity=1024, max_tiles_per_gaussian=32,
                          chunk=128, backend="auto")
    store = gauss_mod.create(cloud.means3d.cpu().numpy(),
                             np.clip(cloud.colors.cpu().numpy(), 0, 1), n_gaussians,
                             sh_degree=0, device=device)
    store["quats"] = cloud.quats
    store["log_scales"] = torch.log(cloud.scales)
    store["opacity_logit"] = torch.log(cloud.opacities / (1 - cloud.opacities))
    block = sharding.shard_params({"gaussians": store}, mesh)["gaussians"]
    target = torch.as_tensor(rng.uniform(size=(size, size, 3)).astype(np.float32),
                             device=device)

    def step(gp):
        keys = [k for k, v in gp.items() if v.is_floating_point()]
        leaves = {k: gp[k].detach().requires_grad_(True) for k in keys}
        hdr, _, _, _, _ = prender.rasterize_sharded(
            dict(gp, **leaves), viewmats, cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
            cam.height, cfg, mesh, 0)
        loss = losses.photometric(torch.clamp(hdr, 0.0, 1.0).mean(0), target, 0.2)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
        return loss.detach(), dict(zip(keys, grads))

    return step, (block,), size * size * n_virtual


def _sharded_setup(arg: str, device: torch.device, tmp: str):
    """(mesh, device, whether this call started the world) for --sharded
    D[,G]: the launched world (torchrun), one already started in this
    process, or for 1,1 a world of one started here (rendezvous in `tmp`)."""
    import os

    import torch.distributed as dist

    from casualhdrsplat_torch.config import ParallelConfig
    from casualhdrsplat_torch.parallel import distributed, mesh as mesh_mod

    dg = [int(x) for x in arg.split(",")] + [1]
    data, gauss = dg[0], dg[1]
    started = False
    if distributed.launched_world():
        device = distributed.initialize(device=device)
    elif not dist.is_initialized():
        if data * gauss != 1:
            raise SystemExit(
                f"bench --sharded {arg}: a mesh of {data * gauss} ranks needs a launched "
                f"world: torchrun --nproc_per_node={data * gauss} -m "
                f"casualhdrsplat_torch.bench --sharded {arg}")
        dist.init_process_group(distributed.backend_for(device),
                                init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                                world_size=1, rank=0)
        started = True
    return mesh_mod.make_mesh(ParallelConfig(data=data, gauss=gauss)), device, started


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # kernel-schedule knobs for tuning; the recorded metric uses the defaults
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--stream-factor", type=int, default=6)
    ap.add_argument("--tile", default="16x16", help="HxW")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--sharded", default=None, metavar="D[,G]",
                    help="the workload through the sharded rasterizer on a (D, G) mesh")
    ap.add_argument("--profile", action="store_true",
                    help="also time one window's card busy time against its wall (CUDA)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("bench: no CUDA device; pass --device cpu for a CPU run", file=sys.stderr)
            return 2
        print(f"card: {card_line()}", flush=True)
    device = torch.device(args.device)
    if args.sharded is None:
        step, step_args, pixels = build(
            chunk=args.chunk, stream_factor=args.stream_factor,
            tile=tuple(int(x) for x in args.tile.split("x")), device=device,
        )
        return _run(step, step_args, pixels, device, True, args.profile)
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory(prefix="chs-bench-") as tmp:
        mesh, device, started = _sharded_setup(args.sharded, device, tmp)
        try:
            step, step_args, pixels = build_sharded(mesh=mesh, device=device)
            # each rank renders its share of the pixels: per card, as the default
            return _run(step, step_args, pixels / mesh.size("world"), device, mesh.rank == 0,
                        args.profile)
        finally:
            if started:
                dist.destroy_process_group()


def _profile_window(step, step_args) -> str:
    """One window of ITERS_PER_WINDOW steps under torch.profiler: its host
    wall, the card's busy time (the sum of its kernels' times) and the
    kernel launches, per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS_PER_WINDOW):
            step(*step_args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / ITERS_PER_WINDOW * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / ITERS_PER_WINDOW
    launches = sum(e.count for e in kernels) // ITERS_PER_WINDOW
    return (f"profile: wall {wall:.3f} ms a step (profiled), card busy {busy:.3f} ms a step "
            f"({100 * busy / wall:.1f}% of the wall), {launches} kernel launches a step")


def _run(step, step_args, pixels, device, report: bool, profile: bool = False) -> int:
    """Warm up, time N_WINDOWS windows of ITERS_PER_WINDOW steps, print the
    JSON line when `report` (with `profile`, the profiled window's line
    before it)."""
    for _ in range(WARMUP_STEPS):
        loss, _ = step(*step_args)
    if not np.isfinite(float(loss)):
        raise RuntimeError(f"bench: non-finite warm-up loss {float(loss)}")
    rates = []
    for _ in range(N_WINDOWS):
        t0 = time.perf_counter()
        acc = torch.zeros((), device=device)
        for _ in range(ITERS_PER_WINDOW):
            loss, _ = step(*step_args)
            acc = acc + loss
        # one host read per window: the stream runs in order, so it waits
        # for every step of the window, backward included
        if not np.isfinite(float(acc)):
            raise RuntimeError("bench: non-finite loss")
        dt = (time.perf_counter() - t0) / ITERS_PER_WINDOW
        rates.append(pixels / dt / 1e6)

    mpix_s = float(np.median(rates))
    line = _profile_window(step, step_args) if profile and device.type == "cuda" else None
    if not report:
        return 0
    if line:
        print(line, flush=True)
    print(json.dumps({
        "metric": "rendered Mpix/s/chip fwd+bwd",
        "value": round(mpix_s, 3),
        "unit": "Mpix/s",
        "vs_baseline": round(mpix_s / 10.0, 3),
        "median_of": N_WINDOWS,
        "iters_per_window": ITERS_PER_WINDOW,
        "spread_pct": round(100.0 * (max(rates) - min(rates)) / max(mpix_s, 1e-9), 1),
        "windows": [round(r, 2) for r in rates],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
