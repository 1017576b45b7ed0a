"""Synthetic scenes and casual-video fixtures, numpy-seeded.  Counterpart
of casualhdrsplat_tpu/data/synthetic.py.

The numpy draws come in the reference's order, so the same generator state
yields the same cloud, shake and exposures in both packages.  The clouds
are computed in numpy, as the reference computes them, and moved to the
device at the end: the same seed gives the same cloud bit for bit.
`make_casual_video` renders its ground truth through the port's rasterizer
by default (`renderer="fast"`; the reference's default is the dense
[N, H*W] oracle, `renderer="oracle"`, which the port has too).
`cached_casual_video` keeps a fixture in an `.npz` under the reference's
key and field names, so either package reads what the other wrote.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
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


def _smooth_field(rng: np.random.Generator, pts: np.ndarray,
                  n_waves: int = 6, freq=(2.0, 12.0)) -> np.ndarray:
    """Smooth scalar field in ~[-1,1] over 3D points: a sum of random
    plane waves.  Spatially correlated, so nearby splats get nearby
    colours, the piecewise-smooth appearance real scenes have."""
    k = rng.uniform(freq[0], freq[1], size=n_waves)
    dirs = rng.normal(size=(n_waves, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    phase = rng.uniform(0.0, 2 * np.pi, size=n_waves)
    vals = np.sin(pts @ (dirs.T * k) + phase).sum(axis=-1)
    return vals / np.sqrt(n_waves)


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """a * b + c as a fused multiply-add gives it in float32: computed in
    float64, where the product of two float32 values is exact, so only the
    sum rounds (twice, which differs from one rounding only at rare
    double-rounding ties)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _rotmat_to_quat_f32(rots: np.ndarray) -> np.ndarray:
    """geometry.lie.rotmat_to_quat in float32 numpy, with the arithmetic of
    the reference's jitted version on a CPU, whose norms are a chain of
    fused multiply-adds: the same rotations give the same bits."""
    R = rots.astype(np.float32)
    m00, m01, m02 = R[:, 0, 0], R[:, 0, 1], R[:, 0, 2]
    m10, m11, m12 = R[:, 1, 0], R[:, 1, 1], R[:, 1, 2]
    m20, m21, m22 = R[:, 2, 0], R[:, 2, 1], R[:, 2, 2]
    tr = m00 + m11 + m22
    one = np.float32(1.0)
    cands = np.stack([
        np.stack([one + tr, m21 - m12, m02 - m20, m10 - m01], -1),
        np.stack([m21 - m12, one + m00 - m11 - m22, m01 + m10, m02 + m20], -1),
        np.stack([m02 - m20, m01 + m10, one + m11 - m00 - m22, m12 + m21], -1),
        np.stack([m10 - m01, m02 + m20, m12 + m21, one + m22 - m00 - m11], -1),
    ], -2)  # [n, 4, 4]

    def norm(v):
        s = v[..., 0] * v[..., 0]
        for i in range(1, 4):
            s = _fma32(v[..., i], v[..., i], s)
        return np.sqrt(s)

    best = np.argmax(norm(cands), axis=-1)
    q = cands[np.arange(len(R)), best]
    q = q / np.maximum(norm(q), np.float32(1e-8))[:, None]
    return q * np.where(q[:, :1] < 0, np.float32(-1.0), np.float32(1.0))


def _tangent_quats(normals: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Unit quaternions (w,x,y,z) whose rotation maps local +z to the
    surface normal, with a random in-plane spin: flat surfel splats."""
    n = normals / np.linalg.norm(normals, axis=-1, keepdims=True)
    helper = np.where(
        np.abs(n[:, 1:2]) < 0.9,
        np.tile(np.array([[0.0, 1.0, 0.0]]), (len(n), 1)),
        np.tile(np.array([[1.0, 0.0, 0.0]]), (len(n), 1)),
    )
    t1 = np.cross(helper, n)
    t1 /= np.linalg.norm(t1, axis=-1, keepdims=True)
    t2 = np.cross(n, t1)
    spin = rng.uniform(0.0, 2 * np.pi, size=len(n))
    c, s = np.cos(spin)[:, None], np.sin(spin)[:, None]
    u, v = c * t1 + s * t2, -s * t1 + c * t2
    rots = np.stack([u, v, n], axis=-1)  # columns: local x,y,z in world
    return _rotmat_to_quat_f32(rots)


def _fibonacci_sphere(count: int, radius: float, center: np.ndarray):
    i = np.arange(count, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / count)
    theta = np.pi * (1.0 + 5**0.5) * i
    n = np.stack(
        [np.sin(phi) * np.cos(theta), np.cos(phi), np.sin(phi) * np.sin(theta)],
        axis=-1,
    )
    return center + radius * n, n


def structured_cloud(
    rng: np.random.Generator,
    n: int,
    extent: float = 2.2,
    hdr_max: float = 3.0,
    detail: float = 0.35,
    brightness: float = 2.0,
    device="cuda",
) -> GaussianCloud:
    """Piecewise-smooth structured scene: a room of textured surfaces
    (ground plane, wide back wall, spheres resting on the ground) tiled
    with tangent-oriented surfel Gaussians whose radiance follows smooth
    procedural fields, plus an emissive HDR window patch on the wall.

    Against `random_cloud` confetti no fit can score well (i.i.d.
    pixel-scale noise has no recoverable structure); here blur destroys
    texture edges that a correct joint model can recover, so deblurring
    quality becomes measurable.

    Geometry is sized for the default orbit rig (radius-4 camera looking
    at the origin): ground at y=-0.9, back wall at z=+1.8 spanning the
    view across an orbit of +-0.6 rad.
    """
    ground_y, wall_z = -0.9, 0.82 * extent
    wall_w, wall_h = 3.0 * extent, 1.6 * extent
    ground_half = 1.6 * extent
    sphere_specs = [  # (center_x, center_z, radius)
        (-0.95, 0.25, 0.55),
        (0.85, -0.15, 0.45),
        (0.05, 0.95, 0.65),
        (-0.15, -0.85, 0.30),
    ]
    # weight: splat-count allocation bias (foreground surfaces get finer
    # texture; the grazing-angle ground needs less)
    surfaces = [
        {"kind": "plane", "area": (2 * ground_half) ** 2, "weight": 0.6,
         "origin": np.array([-ground_half, ground_y, -ground_half]),
         "u": np.array([2 * ground_half, 0.0, 0.0]),
         "v": np.array([0.0, 0.0, 2 * ground_half]),
         "normal": np.array([0.0, 1.0, 0.0]),
         "albedo": np.array([0.55, 0.45, 0.35])},
        {"kind": "plane", "area": wall_w * wall_h, "weight": 1.2,
         "origin": np.array([-wall_w / 2, ground_y, wall_z]),
         "u": np.array([wall_w, 0.0, 0.0]),
         "v": np.array([0.0, wall_h, 0.0]),
         "normal": np.array([0.0, 0.0, -1.0]),
         "albedo": np.array([0.45, 0.50, 0.62])},
    ]
    palette = [
        np.array([0.80, 0.30, 0.25]),
        np.array([0.25, 0.55, 0.30]),
        np.array([0.85, 0.70, 0.25]),
        np.array([0.35, 0.35, 0.80]),
    ]
    for (sx, sz, r), alb in zip(sphere_specs, palette):
        surfaces.append(
            {"kind": "sphere", "area": 4 * np.pi * r * r, "weight": 2.0,
             "center": np.array([sx, ground_y + r, sz]), "radius": r,
             "albedo": alb}
        )
    total_w = sum(s["area"] * s["weight"] for s in surfaces)
    pts_all, nrm_all, col_all, scale_all = [], [], [], []
    for s in surfaces:
        cnt = max(16, int(round(n * s["area"] * s["weight"] / total_w)))
        spacing = float(np.sqrt(s["area"] / cnt))
        if s["kind"] == "plane":
            lu = np.linalg.norm(s["u"])
            lv = np.linalg.norm(s["v"])
            nu = max(2, int(round(np.sqrt(cnt * lu / lv))))
            nv = max(2, int(np.ceil(cnt / nu)))
            gu, gv = np.meshgrid(
                (np.arange(nu) + 0.5) / nu, (np.arange(nv) + 0.5) / nv
            )
            uv = np.stack([gu.ravel(), gv.ravel()], axis=-1)[:cnt]
            uv += rng.uniform(-0.4, 0.4, uv.shape) / np.array([nu, nv])
            pts = s["origin"] + uv[:, :1] * s["u"] + uv[:, 1:] * s["v"]
            nrm = np.tile(s["normal"], (len(pts), 1))
        else:
            pts, nrm = _fibonacci_sphere(cnt, s["radius"], s["center"])
            jitter = rng.normal(size=pts.shape) * (0.15 * spacing)
            jitter -= (jitter * nrm).sum(-1, keepdims=True) * nrm  # tangent only
            pts = pts + jitter
        # radiance: smooth low-frequency shading x mid-frequency texture
        # detail (the structure blur destroys and deblurring restores)
        shade = 0.72 + 0.30 * _smooth_field(rng, pts, n_waves=5, freq=(1.5, 6.0))
        tex = 1.0 + detail * _smooth_field(rng, pts, n_waves=8, freq=(12.0, 40.0))
        tint = 1.0 + 0.18 * np.stack(
            [_smooth_field(rng, pts, n_waves=3, freq=(2.0, 8.0)) for _ in range(3)],
            axis=-1,
        )
        col = brightness * s["albedo"] * (shade * tex)[:, None] * tint
        tang = spacing * 0.62 * rng.uniform(0.8, 1.25, size=(len(pts), 1))
        scale = np.concatenate([np.tile(tang, (1, 2)), 0.10 * tang], axis=-1)
        pts_all.append(pts)
        nrm_all.append(nrm)
        col_all.append(col)
        scale_all.append(scale)
    pts = np.concatenate(pts_all).astype(np.float32)
    nrm = np.concatenate(nrm_all).astype(np.float32)
    col = np.concatenate(col_all).astype(np.float32)
    scales = np.concatenate(scale_all).astype(np.float32)
    # Emissive HDR window on the back wall: a bright patch whose radiance
    # exceeds the LDR clip at long exposures but reads unsaturated at short
    # ones, so the CRF/exposure chain sees both regimes.
    win = (
        (np.abs(pts[:, 2] - wall_z) < 1e-3)
        & (pts[:, 0] > 0.45) & (pts[:, 0] < 1.45)
        & (pts[:, 1] > 0.35) & (pts[:, 1] < 1.25)
    )
    col[win] = np.array([1.0, 0.93, 0.78], np.float32) * hdr_max
    quats = _tangent_quats(nrm, rng).astype(np.float32)
    opac = rng.uniform(0.82, 0.97, size=len(pts)).astype(np.float32)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return GaussianCloud(
        means3d=dev(pts),
        quats=dev(quats),
        scales=dev(np.maximum(scales, 1e-4)),
        opacities=dev(opac),
        colors=dev(np.maximum(col, 0.0)),
    )


_CAM_FIELDS = ("fx", "fy", "cx", "cy", "width", "height")


def cached_casual_video(cache_dir: str, seed: int, device="cuda", **kw) -> "SyntheticVideo":
    """make_casual_video memoized to `cache_dir/video_<key>.npz`, under the
    reference's key and field names, so that either
    package reads the fixture the other wrote.  A fixture is a pure
    function of (seed, kwargs); at 800x800 its ground truth takes a while
    to render, and every resume of a quality run needs it again.

    The key is the reference's: sha256 of the sorted reprs of the keyword
    arguments and the seed.  `raster_cfg` only says how the ground truth
    is rendered (drop-free either way) and is left out, as is `device`,
    which is not a keyword of `make_casual_video` there."""
    key_src = {k: repr(v) for k, v in sorted(kw.items()) if k != "raster_cfg"}
    key_src["seed"] = seed
    key = hashlib.sha256(json.dumps(key_src, sort_keys=True).encode()).hexdigest()[:16]
    path = os.path.join(cache_dir, f"video_{key}.npz")
    os.makedirs(cache_dir, exist_ok=True)
    if os.path.exists(path):
        with np.load(path) as z:
            def dev(name):
                return torch.as_tensor(z[name], device=device)

            cam = Camera.make(z["cam_viewmat"], float(z["fx"]), float(z["fy"]),
                              float(z["cx"]), float(z["cy"]), int(z["width"]),
                              int(z["height"]), device=device)
            return SyntheticVideo(
                cloud=GaussianCloud(*[dev(f"cloud_{f}") for f in GaussianCloud._fields]),
                images=dev("images"),
                sharp_hdr=dev("sharp_hdr"),
                sharp_ldr=dev("sharp_ldr"),
                timestamps=dev("timestamps"),
                exposures=dev("exposures"),
                knots=dev("knots"),
                knot_t0=float(z["knot_t0"]),
                knot_dt=float(z["knot_dt"]),
                camera=cam,
            )
    video = make_casual_video(np.random.default_rng(seed), device=device, **kw)
    cam = video.camera

    def host(t):
        return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    np.savez_compressed(
        path,
        **{f"cloud_{f}": host(getattr(video.cloud, f)) for f in GaussianCloud._fields},
        images=host(video.images),
        sharp_hdr=host(video.sharp_hdr),
        sharp_ldr=host(video.sharp_ldr),
        timestamps=host(video.timestamps),
        exposures=host(video.exposures),
        knots=host(video.knots),
        knot_t0=np.asarray(video.knot_t0),
        knot_dt=np.asarray(video.knot_dt),
        cam_viewmat=host(cam.viewmat),
        **{f: host(getattr(cam, f)) for f in _CAM_FIELDS},
    )
    return video


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
    ops/oracle.py, for small fixtures.

    `cloud_kind="structured"` renders `structured_cloud` (its splat sizes
    come from the surface tiling density, not `scale_range`), else
    `random_cloud`.
    """
    from casualhdrsplat_torch import config as config_mod
    from casualhdrsplat_torch.ops import oracle
    from casualhdrsplat_torch.ops import rasterize as raster_mod

    if renderer not in ("fast", "oracle"):
        raise ValueError(f"unknown renderer {renderer!r}")
    if raster_cfg is None:
        raster_cfg = config_mod.RasterizeConfig(shared_binning=False)

    if cloud_kind == "structured":
        cloud = structured_cloud(rng, n_gaussians, extent=extent, hdr_max=hdr_max,
                                 device=device)
    else:
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
