"""EWA Gaussian projection.  Counterpart of
casualhdrsplat_tpu/ops/projection.py.

Elementwise over Gaussians, so plain tensor code.  `viewmat` may carry
leading view dimensions ([V,4,4]); every output then has them too
([V,N,...]), which renders all virtual views of a frame in one pass (the
reference vmaps over views).

Math (gsplat mathematical supplement):
  t        = R_view p + t_view                    (camera-space mean)
  Sigma    = R(q) diag(s)^2 R(q)^T                (world covariance)
  J        = [[fx/tz, 0, -fx tx/tz^2],
              [0, fy/tz, -fy ty/tz^2]]            (perspective Jacobian)
  Sigma2d  = J W Sigma W^T J^T + blur I           (EWA + low-pass, blur=0.3)
  conic    = Sigma2d^{-1}  (upper triangle xx, xy, yy)
  radius   = ceil(3 sqrt(lambda_max(Sigma2d)))
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from casualhdrsplat_torch.geometry.lie import quat_to_rotmat

BLUR_2D = 0.3


class Projected(NamedTuple):
    means2d: torch.Tensor  # [..., N, 2] pixel coordinates
    depths: torch.Tensor  # [..., N] camera-space z
    conics: torch.Tensor  # [..., N, 3] inverse 2D covariance (xx, xy, yy)
    radii: torch.Tensor  # [..., N] 3-sigma screen radius (float; 0 = culled)
    valid: torch.Tensor  # [..., N] bool
    compensation: torch.Tensor  # [..., N] antialias opacity compensation


def _cov2d_components(quats, scales, R):
    """The 6 unique components of W Sigma W^T, scalar-expanded over [N]
    (R [..., 3, 3] broadcasts against the Gaussians)."""
    rot = quat_to_rotmat(quats)  # [N,3,3]
    m = [[rot[:, i, j] * scales[:, j] for j in range(3)] for i in range(3)]
    sig = {}
    for i in range(3):
        for j in range(i, 3):
            sig[(i, j)] = sum(m[i][k] * m[j][k] for k in range(3))

    def s_at(i, j):
        return sig[(i, j)] if (i, j) in sig else sig[(j, i)]

    def w(i, k):
        return R[..., i, k, None]

    a = [[sum(w(i, k) * s_at(k, j) for k in range(3)) for j in range(3)]
         for i in range(3)]

    def c_at(i, j):
        return sum(a[i][k] * w(j, k) for k in range(3))

    return c_at(0, 0), c_at(0, 1), c_at(0, 2), c_at(1, 1), c_at(1, 2), c_at(2, 2)


def project_gaussians(
    means3d: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    scales: torch.Tensor,  # [N, 3] (activated, positive)
    viewmat: torch.Tensor,  # [..., 4, 4] world->camera
    fx,
    fy,
    cx,
    cy,
    width: int,
    height: int,
    near_plane: float = 0.05,
    antialias: bool = False,
) -> Projected:
    R = viewmat[..., :3, :3]
    t = (means3d[:, None, :] * R[..., None, :, :]).sum(-1) + viewmat[..., None, :3, 3]
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    in_front = tz > near_plane
    tz_safe = torch.where(in_front, tz, torch.ones_like(tz))
    inv_z = 1.0 / tz_safe

    # gsplat's tangent-plane clamp keeps the Jacobian bounded near borders
    lim_x = 1.3 * (0.5 * width / fx + torch.abs((cx - 0.5 * width) / fx))
    lim_y = 1.3 * (0.5 * height / fy + torch.abs((cy - 0.5 * height) / fy))
    txz = torch.clamp(tx * inv_z, -lim_x, lim_x) * tz_safe
    tyz = torch.clamp(ty * inv_z, -lim_y, lim_y) * tz_safe

    c00, c01, c02, c11, c12, c22 = _cov2d_components(quats, scales, R)

    j00 = fx * inv_z
    j02 = -fx * txz * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -fy * tyz * inv_z * inv_z

    sxx = j00 * j00 * c00 + 2.0 * j00 * j02 * c02 + j02 * j02 * c22
    sxy = j00 * j11 * c01 + j00 * j12 * c02 + j02 * j11 * c12 + j02 * j12 * c22
    syy = j11 * j11 * c11 + 2.0 * j11 * j12 * c12 + j12 * j12 * c22

    det_raw = sxx * syy - sxy * sxy
    sxx_b = sxx + BLUR_2D
    syy_b = syy + BLUR_2D
    det = sxx_b * syy_b - sxy * sxy
    nondegenerate = det > 1e-10
    inv_det = 1.0 / torch.where(nondegenerate, det, torch.ones_like(det))
    conics = torch.stack([syy_b * inv_det, -sxy * inv_det, sxx_b * inv_det], dim=-1)

    if antialias:  # gsplat "antialiased": opacity * sqrt(det_raw / det)
        compensation = torch.where(
            nondegenerate, torch.sqrt(torch.clamp(det_raw, min=0.0) * inv_det),
            torch.zeros_like(det),
        )
    else:
        compensation = torch.ones_like(det)

    # 3-sigma radius from the larger eigenvalue of the blurred covariance
    mid = 0.5 * (sxx_b + syy_b)
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
    radii = torch.ceil(3.0 * torch.sqrt(lam_max))

    means2d = torch.stack([fx * tx * inv_z + cx, fy * ty * inv_z + cy], dim=-1)

    on_screen = (
        (means2d[..., 0] + radii > 0)
        & (means2d[..., 0] - radii < width)
        & (means2d[..., 1] + radii > 0)
        & (means2d[..., 1] - radii < height)
    )
    valid = in_front & nondegenerate & on_screen
    radii = torch.where(valid, radii, torch.zeros_like(radii))
    return Projected(
        means2d=means2d, depths=tz, conics=conics, radii=radii, valid=valid,
        compensation=compensation,
    )


def cull_invisible(proj: Projected, opacities: torch.Tensor) -> Projected:
    """Drop exactly-zero-opacity splats (dead capacity slots) from binning;
    bit-exact, since their alpha is exactly 0."""
    vis = proj.valid & (opacities > 0.0)
    return proj._replace(valid=vis, radii=torch.where(vis, proj.radii, 0.0))


def view_directions(means3d: torch.Tensor, camtoworld: torch.Tensor) -> torch.Tensor:
    """Unit directions from the camera center to each Gaussian (for SH);
    camtoworld [..., 4, 4] -> [..., N, 3]."""
    d = means3d - camtoworld[..., None, :3, 3]
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-8)
