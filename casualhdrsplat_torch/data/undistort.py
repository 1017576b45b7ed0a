"""Camera undistortion for COLMAP models.  The port's own copy of
casualhdrsplat_tpu/data/undistort.py.

COLMAP's offline `image_undistorter` is not needed: casually captured
video (phone lenses always carry radial distortion) is resampled onto the
ideal pinhole grid at load time, so the rasterizer's pinhole camera model
(geometry/camera.py) stays exact.

All math is host-side numpy on normalized camera-plane coordinates —
distortion is resolution-independent, so remapping a downscaled frame
with downscaled intrinsics is equivalent to remapping at full res.

Conventions follow COLMAP `src/colmap/sensor/models.h`:

- SIMPLE_RADIAL  (f, cx, cy, k)                : radial 1 + k r^2
- RADIAL         (f, cx, cy, k1, k2)           : 1 + k1 r^2 + k2 r^4
- OPENCV         (fx, fy, cx, cy, k1,k2,p1,p2) : radial + tangential
- FULL_OPENCV    (.. k1..k6, p1, p2)           : rational radial + tangential
- OPENCV_FISHEYE (fx, fy, cx, cy, k1..k4)      : equidistant theta-poly
- SIMPLE_RADIAL_FISHEYE / RADIAL_FISHEYE       : radial poly on theta
- FOV            (fx, fy, cx, cy, omega)       : Devernay-Faugeras
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _radial_tangential(x, y, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
                       k4=0.0, k5=0.0, k6=0.0):
    r2 = x * x + y * y
    radial = (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
    den = (1.0 + r2 * (k4 + r2 * (k5 + r2 * k6)))
    radial = radial / den
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def _fisheye_theta(x, y, scale_of_theta):
    """Generic fisheye: distortion acts on theta = atan(r)."""
    r = np.sqrt(x * x + y * y)
    r = np.maximum(r, 1e-12)
    theta = np.arctan(r)
    s = scale_of_theta(theta) / r
    return x * s, y * s


def distort(model: str, params: np.ndarray, x: np.ndarray, y: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Forward distortion of ideal normalized coords (x, y) -> (xd, yd).

    `params` is the full COLMAP parameter vector for `model` (including
    focal/principal, which are ignored here — only distortion terms are
    read).  Models with no distortion terms return inputs unchanged.
    """
    p = np.asarray(params, np.float64)
    if model in ("SIMPLE_PINHOLE", "PINHOLE"):
        return x, y
    if model == "SIMPLE_RADIAL":
        return _radial_tangential(x, y, k1=p[3])
    if model == "RADIAL":
        return _radial_tangential(x, y, k1=p[3], k2=p[4])
    if model == "OPENCV":
        return _radial_tangential(x, y, k1=p[4], k2=p[5], p1=p[6], p2=p[7])
    if model == "FULL_OPENCV":
        return _radial_tangential(x, y, k1=p[4], k2=p[5], p1=p[6], p2=p[7],
                                  k3=p[8], k4=p[9], k5=p[10], k6=p[11])
    if model == "OPENCV_FISHEYE":
        k1, k2, k3, k4 = p[4], p[5], p[6], p[7]

        def s(t):
            t2 = t * t
            return t * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))

        return _fisheye_theta(x, y, s)
    if model == "SIMPLE_RADIAL_FISHEYE":
        k = p[3]
        return _fisheye_theta(x, y, lambda t: t * (1 + k * t * t))
    if model == "RADIAL_FISHEYE":
        k1, k2 = p[3], p[4]
        return _fisheye_theta(
            x, y, lambda t: t * (1 + t * t * (k1 + t * t * k2)))
    if model == "FOV":
        omega = p[4]
        if abs(omega) < 1e-8:
            return x, y
        r = np.maximum(np.sqrt(x * x + y * y), 1e-12)
        s = np.arctan(2.0 * r * np.tan(0.5 * omega)) / (omega * r)
        return x * s, y * s
    raise NotImplementedError(f"distortion model {model}")


def undistort_points(model: str, params: np.ndarray, xd: np.ndarray,
                     yd: np.ndarray, iters: int = 20
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Invert `distort` per point by damped fixed-point/Newton iteration
    (COLMAP `IterativeUndistortion` equivalent).  Used for 2D feature
    coords and for synthesizing test fixtures; image undistortion only
    needs the forward map."""
    x = np.array(xd, np.float64, copy=True)
    y = np.array(yd, np.float64, copy=True)
    for _ in range(iters):
        fx_, fy_ = distort(model, params, x, y)
        # Jacobian-free secant step with numeric diagonal Jacobian.
        eps = 1e-7
        dxx = (distort(model, params, x + eps, y)[0] - fx_) / eps
        dyy = (distort(model, params, x, y + eps)[1] - fy_) / eps
        dxx = np.where(np.abs(dxx) < 1e-6, 1e-6, dxx)
        dyy = np.where(np.abs(dyy) < 1e-6, 1e-6, dyy)
        x = x - (fx_ - xd) / dxx
        y = y - (fy_ - yd) / dyy
    return x, y


def undistort_map(model: str, params: np.ndarray, width: int, height: int,
                  fx: float, fy: float, cx: float, cy: float):
    """(us, vs) source-pixel sampling maps for `undistort_image`.

    Depends only on the camera, not the frame — compute ONCE per camera
    and reuse across a video's frames (hundreds of frames share one
    camera; rebuilding the meshgrid + distortion polynomial per frame is
    minutes of redundant host work at 4K).
    """
    u, v = np.meshgrid(np.arange(width, dtype=np.float64) + 0.5,
                       np.arange(height, dtype=np.float64) + 0.5)
    xn = (u - cx) / fx
    yn = (v - cy) / fy
    xd, yd = distort(model, params, xn, yn)
    return xd * fx + cx - 0.5, yd * fy + cy - 0.5


def undistort_image(img: np.ndarray, model: str, params: np.ndarray,
                    fx: float, fy: float, cx: float, cy: float,
                    uv_map=None) -> np.ndarray:
    """Resample a distorted capture onto the ideal pinhole grid.

    For each output pinhole pixel: normalized coords -> forward distort ->
    source pixel -> bilinear sample.  Out-of-source samples clamp to the
    border (the corners a pincushion lens never saw).  Pass `uv_map`
    (from `undistort_map`) to reuse the per-camera sampling grid.
    """
    h, w = img.shape[:2]
    if uv_map is None:
        uv_map = undistort_map(model, params, w, h, fx, fy, cx, cy)
    us, vs = uv_map
    return _bilinear(img, us, vs)


def _bilinear(img: np.ndarray, us: np.ndarray, vs: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    us = np.clip(us, 0.0, w - 1.0)
    vs = np.clip(vs, 0.0, h - 1.0)
    u0 = np.floor(us).astype(np.int64)
    v0 = np.floor(vs).astype(np.int64)
    u1 = np.minimum(u0 + 1, w - 1)
    v1 = np.minimum(v0 + 1, h - 1)
    fu = (us - u0)[..., None]
    fv = (vs - v0)[..., None]
    top = img[v0, u0] * (1 - fu) + img[v0, u1] * fu
    bot = img[v1, u0] * (1 - fu) + img[v1, u1] * fu
    return (top * (1 - fv) + bot * fv).astype(img.dtype)
