"""Closed-form so(3)/se(3) Lie operations on tensors.

Counterpart of casualhdrsplat_tpu/geometry/lie.py.  Every function takes
leading batch dimensions (the reference vmaps single elements; here a batch
is written out), is branch-free (Taylor-switched with `torch.where`) and is
differentiable by autograd.

Conventions:
- Rotations are 3x3 matrices; tangents are `omega` in R^3.
- SE(3) elements are 4x4 homogeneous matrices, `X_out = R @ X_in + t`.
- se(3) tangent `xi = (omega[3], v[3])` — rotation part first.

All products run in float32 (TF32 is off package-wide, see __init__).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def mat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix product in full float32 — use for all pose compositions."""
    return torch.matmul(a, b)


def mat_vec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product: [..., i, j] x [..., j] -> [..., i]."""
    return (a * v[..., None, :]).sum(-1)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: w[..., 3] -> skew-symmetric [..., 3, 3]."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of `hat`."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta_sq: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3), Taylor-safe.

    Below theta^2 = 1e-8 the Taylor branch is taken; the arguments of the
    untaken branch are guarded so it never produces NaN gradients.
    """
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS * _EPS))
    small = theta_sq < 1e-8
    one = torch.ones_like(theta)
    safe_theta = torch.where(small, one, theta)
    safe_sq = torch.where(small, one, theta_sq)
    A = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe_theta) / safe_theta)
    B = torch.where(
        small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(safe_theta)) / safe_sq
    )
    C = torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (safe_theta - torch.sin(safe_theta)) / (safe_sq * safe_theta),
    )
    return A, B, C


def _eye3(w: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=w.dtype, device=w.device)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: w[..., 3] -> R[..., 3, 3]."""
    theta_sq = (w * w).sum(-1)
    A, B, _ = _sinc_coeffs(theta_sq)
    W = hat(w)
    return _eye3(w) + A[..., None, None] * W + B[..., None, None] * mat_mul(W, W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Matrix log: R[..., 3, 3] -> w[..., 3] (principal value, |w| <= pi),
    through the quaternion, which stays well conditioned near theta = pi."""
    q = rotmat_to_quat(R)  # (w, x, y, z), w >= 0
    qw, qv = q[..., 0], q[..., 1:]
    # guarded norm: exactly zero gradient at qv = 0 (identity rotations
    # occur at repeated boundary spline knots)
    nv = torch.sqrt(torch.clamp((qv * qv).sum(-1), min=1e-24))
    small = nv < 1e-6
    safe_nv = torch.where(small, torch.ones_like(nv), nv)
    # theta = 2 atan2(|v|, w); scale = theta / |v|, Taylor 2(1 + |v|^2/6)
    scale = torch.where(
        small, 2.0 + nv * nv / 3.0, 2.0 * torch.atan2(nv, qw) / safe_nv
    )
    return scale[..., None] * qv


def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V: exp(xi) = [R, V v] for se(3)."""
    theta_sq = (w * w).sum(-1)
    _, B, C = _sinc_coeffs(theta_sq)
    W = hat(w)
    return _eye3(w) + B[..., None, None] * W + C[..., None, None] * mat_mul(W, W)


def _left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta_sq = (w * w).sum(-1)
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS * _EPS))
    small = theta_sq < 1e-8
    one = torch.ones_like(theta)
    safe_theta = torch.where(small, one, theta)
    half = safe_theta * 0.5
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half))
        / torch.where(small, one, theta_sq),
    )
    W = hat(w)
    return _eye3(w) - 0.5 * W + cot_term[..., None, None] * mat_mul(W, W)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """xi[..., 6] = (omega, v) -> T[..., 4, 4]."""
    w, v = xi[..., :3], xi[..., 3:]
    return rt_to_mat(so3_exp(w), mat_vec(_left_jacobian(w), v))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """T[..., 4, 4] -> xi[..., 6] = (omega, v)."""
    R, t = mat_to_rt(T)
    w = so3_log(R)
    return torch.cat([w, mat_vec(_left_jacobian_inv(w), t)], dim=-1)


# The reference vmaps its single-element se3_exp into this; se3_exp
# already takes batches.
se3_exp_batch = se3_exp


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # [0, 0, 0, 1] made on the device: no copy from the host (which a CUDA
    # graph cannot hold)
    bottom = torch.zeros(4, dtype=R.dtype, device=R.device)
    bottom[3:].fill_(1.0)
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def mat_to_rt(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3]


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R, t = mat_to_rt(T)
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -mat_vec(Rt, t))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> R[..., 3, 3].  Normalizes the input."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack(
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                dim=-1,
            ),
            torch.stack(
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                dim=-1,
            ),
            torch.stack(
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                dim=-1,
            ),
        ],
        dim=-2,
    )


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """R[..., 3, 3] -> unit quaternion (w, x, y, z), w >= 0.

    Branch-free Shepperd-style: all four candidate constructions, the
    best-conditioned one selected by its norm.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def mk(a, b, c, d):
        return torch.stack([a, b, c, d], dim=-1)

    cands = torch.stack(
        [
            mk(1 + tr, m21 - m12, m02 - m20, m10 - m01),
            mk(m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20),
            mk(m02 - m20, m01 + m10, 1 + m11 - m00 - m22, m12 + m21),
            mk(m10 - m01, m02 + m20, m12 + m21, 1 + m22 - m00 - m11),
        ],
        dim=-2,
    )  # [..., 4, 4]
    best = torch.argmax(torch.linalg.norm(cands, dim=-1), dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)
