"""The benchmark's inputs, made from the run's seed on the device: the
ground-truth cloud, the casual video rendered from it, and the training
state a resumed run starts from.

The recipe is the synthetic casual video's: random Gaussians in the cube
[-1, 1]^3 seen from an orbit of radius 4 at height 0.6, frames at times
0..F-1 on a cubic spline through the orbit poses, exposures drawn
uniformly, each frame the mean of `views` sharp renders over its exposure
tone-mapped by a gamma curve.  The renders go through the plain reference
(benchmark/reference), never through the system under test.  All draws
come from one torch.Generator on the device, in a few large calls and in
a fixed order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import geometry as geo
from benchmark.reference import render as ref

SH_C0 = 0.28209479177387814


class Video(NamedTuple):
    cloud: dict  # means, quats, scales, opacities, colors on the device
    images: np.ndarray  # [F, H, W, 3] float32 host frames (zeros when not rendered)
    timestamps: np.ndarray  # [F]
    viewmats: np.ndarray  # [F, 4, 4] the frames' orbit poses
    exposures: torch.Tensor  # [F]
    cam: tuple  # fx, fy, cx, cy, width, height


def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def make_cloud(gen, spec: dict, device) -> dict:
    n = spec["gaussians"]
    q = torch.randn((n, 4), generator=gen, device=device)
    lo, hi = spec["scale_range"]
    return {
        "means": _uniform(gen, (n, 3), -spec["extent"], spec["extent"], device),
        "quats": q / torch.linalg.norm(q, dim=-1, keepdim=True),
        "scales": _uniform(gen, (n, 3), lo, hi, device),
        "opacities": _uniform(gen, (n,), *spec["opacity_range"], device),
        "colors": _uniform(gen, (n, 3), 0.0, spec["hdr_max"], device),
    }


def orbit_poses(spec: dict, device) -> torch.Tensor:
    """The frames' poses [F, 4, 4] along the orbit segment."""
    f = spec["frames"]
    return torch.stack([geo.orbit_viewmat(a, spec["radius"], spec["height"], device)
                        for a in np.linspace(-spec["angle_span"] / 2, spec["angle_span"] / 2, f)])


def camera(spec: dict) -> tuple:
    size = spec["size"]
    focal = spec["focal_ratio"] * size
    return (focal, focal, size / 2.0, size / 2.0, size, size)


@torch.no_grad()
def make_video(gen, spec: dict, device, render: bool = True) -> Video:
    """The cloud, exposures and (when `render`) the blurred frames."""
    cloud = make_cloud(gen, spec, device)
    f = spec["frames"]
    exposures = _uniform(gen, (f,), *spec["exposure_range"], device)
    poses = orbit_poses(spec, device)
    cam = camera(spec)
    scene = ref.make_scene(poses, np.arange(f, dtype=np.float32), cam)
    images = np.zeros((f, cam[5], cam[4], 3), np.float32)
    if render:
        raster = ref.Raster(packed=False, tile_h=16, tile_w=16,
                            tile_capacity=spec["gt_tile_capacity"], max_tiles_per_gaussian=1024,
                            chunk=128, stream_factor=0, shared_binning=False, near_plane=0.05,
                            alpha_clip=0.99, alpha_threshold=1.0 / 255.0, transmittance_eps=1e-4)
        for i in range(f):
            times = geo.virtual_times(scene.timestamps[i], exposures[i], spec["views"])
            mats = geo.cubic_spline(scene.base_knots, scene.knot_t0, scene.knot_dt, times)
            rgb = cloud["colors"][None].expand(len(times), -1, -1)
            out = ref.rasterize(cloud["means"], cloud["quats"], cloud["scales"],
                                cloud["opacities"], rgb, mats, cam, raster)
            if out.dropped:
                raise RuntimeError(f"ground-truth frame {i} dropped {out.dropped} entries: "
                                   f"raise gt_tile_capacity")
            ldr = torch.clamp(out.hdr * exposures[i], 0.0, 1.0) ** (1.0 / spec["crf_gamma"])
            images[i] = ldr.mean(0).cpu().numpy()
            del out, ldr
    return Video(cloud, images, np.arange(f, dtype=np.float32), poses.cpu().numpy(),
                 exposures, cam)


def inv_softplus(y: float) -> float:
    return float(np.log(np.expm1(y)))


@torch.no_grad()
def make_state(gen, video: Video, model: dict, spec: dict, device):
    """The parameters and Adam moments a run resumed at spec["step"]
    holds: the ground truth perturbed as a fit would leave it, a share of
    slots faded below the prune threshold, the CRF at its s-curve start,
    first moments 0 and second moments of the stated size.  Returns
    (params, mu, nu) with mu and nu keyed by leaf name."""
    c = video.cloud
    n = c["means"].shape[0]
    noise = spec["noise"]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    logit = torch.logit(c["opacities"]) + noise["opacity_logit"] * randn(n)
    faded = torch.rand((n,), generator=gen, device=device) < spec["faded_share"]
    logit = torch.where(faded, torch.full_like(logit, spec["faded_logit"]), logit)
    k = (model["sh_degree"] + 1) ** 2
    gauss = {
        "means": c["means"] + noise["means"] * randn(n, 3),
        "quats": c["quats"] + noise["quats"] * randn(n, 4),
        "log_scales": torch.log(c["scales"]) + noise["log_scales"] * randn(n, 3),
        "opacity_logit": logit,
        "sh_dc": ((c["colors"] * (1.0 + noise["colors"] * randn(n, 3)) - 0.5) / SH_C0)[:, None],
        "sh_rest": noise["sh_rest"] * randn(n, k - 1, 3),
        "alive": torch.ones(n, dtype=torch.bool, device=device),
    }
    crf_cfg = model["crf"]
    h = crf_cfg["hidden"]
    span = crf_cfg["log_max"] - crf_cfg["log_min"]
    gain = 1.32 * span
    x0 = (math.log(0.35) - crf_cfg["log_min"]) / span
    crf = {
        "unit_k": torch.ones((3, h), device=device),
        "unit_c": torch.linspace(0.05, 0.95, h, device=device).repeat(3, 1),
        "unit_w": -4.0 + 0.01 * randn(3, h),
        "gain": torch.full((3,), inv_softplus(gain), device=device),
        "bias": torch.full((3,), -gain * x0, device=device),
    }
    knots = video.viewmats.shape[0] + 4
    params = {
        "gaussians": gauss,
        "knot_deltas": noise["knot_deltas"] * randn(knots, 6),
        "log_exposures": torch.log(video.exposures) + noise["log_exposures"] * randn(
            video.exposures.shape[0]),
        "crf": crf,
    }
    from benchmark.reference.train import LEAVES, get, leaf_name

    mu, nu = {}, {}
    for path, _ in LEAVES:
        leaf = get(params, path)
        name = leaf_name(path)
        mu[name] = torch.zeros_like(leaf)
        rms = spec["adam_nu_rms"][name]
        nu[name] = (rms * torch.exp(0.5 * randn(*leaf.shape))) ** 2
    return params, mu, nu


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)
