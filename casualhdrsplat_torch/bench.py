"""Headline benchmark of the port: rendered Mpix/s on one card, forward and
backward.  Counterpart of the reference's `bench.py`, on the same workload.

    python -m casualhdrsplat_torch.bench [--chunk N] [--stream-factor N]
        [--tile HxW] [--device cuda|cpu]

Measures the full differentiable image-formation chain (projection, tile
binning, the streaming compositor's kernel B1, CRF, blur mean, loss, then
the hand-written backward through kernel B2 and autograd to every
parameter group) and reports megapixels rendered per second: the median of
3 windows of 12 steps, each window ending in one host read of its summed
losses.  `vs_baseline = value / 10`, the reference's denominator (about 10
Mpix/s forward and backward for 3DGS-class training on an RTX-class GPU,
from the lineage's published speeds).

Prints the card's name and power limit, then one JSON line: {"metric",
"value", "unit", "vs_baseline", "median_of", "iters_per_window",
"spread_pct", "windows"}.  Without a CUDA device it exits 2 unless asked
for the CPU with `--device cpu`.
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


def build(n_gaussians=100_000, size=800, n_virtual=4, chunk=128, stream_factor=6,
          tile=(16, 16), device="cuda"):
    """(step, args, pixels per step): `step(*args)` returns the loss and its
    gradients with respect to the means, log-scales, opacity logits,
    colours, CRF parameters (a dict) and log exposure time, for one blurred
    frame of `n_virtual` views of a random cloud at size x size."""
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
    return step, args, size * size * n_virtual


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
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("bench: no CUDA device; pass --device cpu for a CPU run", file=sys.stderr)
            return 2
        print(f"card: {card_line()}", flush=True)
    device = torch.device(args.device)
    step, step_args, pixels = build(
        chunk=args.chunk, stream_factor=args.stream_factor,
        tile=tuple(int(x) for x in args.tile.split("x")), device=device,
    )

    loss, _ = step(*step_args)  # warm-up: kernel loads, allocator
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
