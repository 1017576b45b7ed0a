"""Synthetic scenes and casual-video fixtures, numpy-seeded.  Counterpart
of casualhdrsplat_tpu/data/synthetic.py.

The numpy draws come in the reference's order, so the same generator state
yields the same cloud, shake and exposures in both packages.
`make_casual_video` renders its ground truth through the port's rasterizer
by default (`renderer="fast"`; the reference's default is the dense
[N, H*W] oracle, `renderer="oracle"`, which the port has too).  Not ported
yet: `structured_cloud`, ROADMAP.md queue A.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from casualhdrsplat_torch.geometry import lie, spline
from casualhdrsplat_torch.geometry.camera import Camera, look_at


class GaussianCloud(NamedTuple):
    means3d: torch.Tensor  # [N,3]
    quats: torch.Tensor  # [N,4]
    scales: torch.Tensor  # [N,3] positive
    opacities: torch.Tensor  # [N] in (0,1)
    colors: torch.Tensor  # [N,3] linear HDR radiance


def random_cloud(
    rng: np.random.Generator,
    n: int,
    extent: float = 1.0,
    scale_range=(0.02, 0.08),
    hdr_max: float = 1.0,
    device="cuda",
) -> GaussianCloud:
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return GaussianCloud(
        means3d=f32(rng.uniform(-extent, extent, size=(n, 3))),
        quats=f32(q),
        scales=f32(rng.uniform(scale_range[0], scale_range[1], size=(n, 3))),
        opacities=f32(rng.uniform(0.3, 0.95, size=(n,))),
        colors=f32(rng.uniform(0.0, hdr_max, size=(n, 3))),
    )


def orbit_camera(
    angle: float,
    radius: float = 4.0,
    height: float = 0.6,
    width: int = 64,
    img_height: int = 64,
    focal: float | None = None,
    device="cuda",
) -> Camera:
    eye = (radius * np.sin(angle), height, -radius * np.cos(angle))
    viewmat = look_at(eye, (0.0, 0.0, 0.0), device=device)
    if focal is None:
        focal = 0.9 * width
    return Camera.make(
        viewmat, focal, focal, width / 2.0, img_height / 2.0, width, img_height,
        device=device,
    )


def orbit_knots(
    num: int,
    angle_span: float = 0.6,
    radius: float = 4.0,
    width: int = 64,
    img_height: int = 64,
    device="cuda",
) -> torch.Tensor:
    """Spline control knots [M,4,4] along an orbit segment."""
    angles = np.linspace(-angle_span / 2, angle_span / 2, num)
    return torch.stack([
        orbit_camera(a, radius=radius, width=width, img_height=img_height,
                     device=device).viewmat
        for a in angles
    ])


class SyntheticVideo(NamedTuple):
    """Ground-truth casual video fixture."""

    cloud: GaussianCloud
    images: torch.Tensor  # [F,H,W,3] observed LDR (blurred, auto-exposed)
    sharp_hdr: torch.Tensor  # [F,H,W,3] mid-exposure sharp HDR renders
    sharp_ldr: torch.Tensor  # [F,H,W,3] GT-CRF tone-map of sharp_hdr * dt_i
    timestamps: torch.Tensor  # [F] frame start times
    exposures: torch.Tensor  # [F] ground-truth exposure durations
    knots: torch.Tensor  # [M,4,4] ground-truth spline knots
    knot_t0: float
    knot_dt: float
    camera: Camera  # intrinsics template (viewmat unused)


def make_casual_video(
    rng: np.random.Generator,
    n_gaussians: int = 300,
    n_frames: int = 6,
    n_virtual: int = 9,
    size: int = 48,
    angle_span: float = 0.5,
    exposure_range=(0.3, 1.2),
    crf_gamma: float = 2.2,
    blur: bool = True,
    renderer: str = "fast",
    raster_cfg=None,
    hdr_max: float = 2.5,
    scale_range=(0.02, 0.08),
    extent: float = 1.0,
    cloud_kind: str = "random",
    shake_rot: float = 0.0,
    shake_trans: float = 0.0,
    knots_per_frame: int = 1,
    device="cuda",
) -> SyntheticVideo:
    """Render a ground-truth auto-exposed blurry video.

    Frame i spans [t_i, t_i + dt_i] on a cubic spline; the observed image
    is the mean of `n_virtual` sharp LDR renders, each LDR = gamma-CRF of
    (HDR * dt_i).  Frame times are 0..n_frames-1; exposures are a fraction
    of the inter-frame interval.

    `renderer="fast"` (the port's default) sends the ground truth through
    the port's rasterizer (per-view binning unless `raster_cfg` says
    otherwise), as at-spec fixtures need; `renderer="oracle"` (the
    reference's default) through the dense [N, H*W] reference renderer
    ops/oracle.py, for small fixtures.  The reference's structured cloud is
    not ported yet.
    """
    from casualhdrsplat_torch import config as config_mod
    from casualhdrsplat_torch.ops import oracle
    from casualhdrsplat_torch.ops import rasterize as raster_mod

    if renderer not in ("fast", "oracle"):
        raise ValueError(f"unknown renderer {renderer!r}")
    if cloud_kind != "random":
        raise NotImplementedError(
            f"cloud_kind={cloud_kind!r}: structured_cloud is not ported yet "
            "(ROADMAP.md queue A, 'Data')"
        )
    if raster_cfg is None:
        raster_cfg = config_mod.RasterizeConfig(shared_binning=False)

    cloud = random_cloud(rng, n_gaussians, extent=extent, hdr_max=hdr_max,
                         scale_range=scale_range, device=device)

    def orbit_mats(angles):
        return torch.stack([
            orbit_camera(a, width=size, img_height=size, device=device).viewmat
            for a in angles
        ])

    cam = orbit_camera(0.0, width=size, img_height=size, device=device)
    if knots_per_frame > 1:
        # dense sub-frame ground-truth knots straight from the analytic
        # orbit, on the grid build_scene constructs for knots_per_frame
        times, t0, dt = spline.dense_grid(n_frames, knots_per_frame, pad=2, device="cpu")
        knots = orbit_mats(
            -angle_span / 2
            + angle_span * np.clip(times.numpy(), 0, n_frames - 1) / max(n_frames - 1, 1)
        )
    else:
        poses = orbit_mats(np.linspace(-angle_span / 2, angle_span / 2, n_frames))
        knots, t0, dt = spline.knots_for_frames(poses, pad=2)
    if shake_rot > 0.0 or shake_trans > 0.0:
        # Handheld shake: per-knot SE(3) jitter left-composed onto the
        # world->cam knot (exp(xi) @ knot), a perturbation in the camera
        # frame: the orientation wobbles by omega and the camera centre
        # drifts by about |v|, independent of the orbit radius.
        m = int(knots.shape[0])
        xi = np.concatenate(
            [rng.normal(0.0, max(shake_rot, 1e-12), (m, 3)),
             rng.normal(0.0, max(shake_trans, 1e-12), (m, 3))], axis=-1,
        ).astype(np.float32)
        knots = lie.mat_mul(lie.se3_exp_batch(torch.as_tensor(xi, device=device)), knots)

    # One quantity per frame: the exposure time dt_i both scales irradiance
    # (H * dt) and spans the blur window on the spline.
    exposures = rng.uniform(*exposure_range, size=n_frames).astype(np.float32)

    def render_views_oracle(mats):
        return torch.stack([
            oracle.render(cloud.means3d, cloud.quats, cloud.scales, cloud.opacities,
                          cloud.colors, dataclasses.replace(cam, viewmat=m)).image
            for m in mats
        ])

    def render_views_fast(mats):
        imgs, _, aux = raster_mod.rasterize(
            cloud.means3d, cloud.quats, cloud.scales, cloud.opacities,
            cloud.colors, mats, cam.fx, cam.fy, cam.cx, cam.cy,
            cam.width, cam.height, raster_cfg,
        )
        # Ground truth must never be budget-truncated: a waterfilled
        # fixture silently corrupts every downstream quality metric.
        dropped = int(aux.num_dropped)
        if dropped != 0:
            raise ValueError(
                f"synthetic GT fixture overflowed the rasterizer "
                f"stream budget ({dropped} contributions "
                "dropped) — raise raster_cfg.stream_factor / "
                "tile_capacity or shrink the fixture (docs/TUNING.md)"
            )
        return imgs

    render_views = render_views_fast if renderer == "fast" else render_views_oracle

    timestamps = np.arange(n_frames, dtype=np.float32)
    images, sharp = [], []
    with torch.no_grad():
        for i in range(n_frames):
            t_i = torch.tensor(float(timestamps[i]), device=device)
            t_k = spline.sample_virtual_times(
                t_i, float(exposures[i]) if blur else 0.0, n_virtual if blur else 1
            )
            hdrs = render_views(spline.cubic_bspline_interpolation(knots, t0, dt, t_k))
            ldrs = torch.clamp(hdrs * float(exposures[i]), 0.0, 1.0) ** (1.0 / crf_gamma)
            images.append(ldrs.mean(0))
            mid_t = t_i + (float(exposures[i]) / 2.0 if blur else 0.0)
            mid = spline.cubic_bspline_interpolation(knots, t0, dt, mid_t.reshape(1))
            sharp.append(render_views(mid)[0])
        sharp_hdr = torch.stack(sharp)
        exposures_t = torch.as_tensor(exposures, device=device)
        sharp_ldr = (
            torch.clamp(sharp_hdr * exposures_t[:, None, None, None], 0.0, 1.0)
            ** (1.0 / crf_gamma)
        )
    return SyntheticVideo(
        cloud=cloud,
        images=torch.stack(images),
        sharp_hdr=sharp_hdr,
        sharp_ldr=sharp_ldr,
        timestamps=torch.as_tensor(timestamps, device=device),
        exposures=exposures_t,
        knots=knots,
        knot_t0=t0,
        knot_dt=dt,
        camera=cam,
    )
