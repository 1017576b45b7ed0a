"""Camera geometry of the plain reference: SO(3)/SE(3) exp and log, the
cumulative cubic B-spline over 4x4 knots, look-at and orbit cameras.

Plain float32 PyTorch, differentiable by autograd.  Conventions: rotations
are 3x3, a se(3) tangent is (omega[3], v[3]), an SE(3) element is a 4x4
world-to-camera matrix (+z forward, +x right, +y down).  Every pose product
is a `torch.matmul`, so the precision of matrix products (TF32 or full
float32) reaches the poses, as it does in the system under test.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def mat_vec(a, v):
    return (a * v[..., None, :]).sum(-1)


def _sinc(theta_sq):
    """(sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3), Taylor below 1e-8."""
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS * _EPS))
    small = theta_sq < 1e-8
    one = torch.ones_like(theta)
    st = torch.where(small, one, theta)
    sq = torch.where(small, one, theta_sq)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(st) / st)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(st)) / sq)
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (st - torch.sin(st)) / (sq * st))
    return a, b, c


def rt_to_mat(R, t):
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R, t = R.expand(batch + (3, 3)), t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom.expand(batch + (1, 4))], -2)


def se3_inverse(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    return rt_to_mat(Rt, -mat_vec(Rt, T[..., :3, 3]))


def se3_exp(xi):
    """(omega, v) [..., 6] -> [..., 4, 4]."""
    w, v = xi[..., :3], xi[..., 3:]
    a, b, c = _sinc((w * w).sum(-1))
    W = hat(w)
    WW = torch.matmul(W, W)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    R = eye + a[..., None, None] * W + b[..., None, None] * WW
    V = eye + b[..., None, None] * W + c[..., None, None] * WW
    return rt_to_mat(R, mat_vec(V, v))


def quat_to_rotmat(q):
    """(w, x, y, z) -> [..., 3, 3], normalising q."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _rotmat_to_quat(R):
    """Unit quaternion (w >= 0) of R, from the best-conditioned of the four
    Shepperd candidates."""
    m = [[R[..., i, j] for j in range(3)] for i in range(3)]
    tr = m[0][0] + m[1][1] + m[2][2]
    cands = torch.stack([
        torch.stack([1 + tr, m[2][1] - m[1][2], m[0][2] - m[2][0], m[1][0] - m[0][1]], -1),
        torch.stack([m[2][1] - m[1][2], 1 + m[0][0] - m[1][1] - m[2][2], m[0][1] + m[1][0],
                     m[0][2] + m[2][0]], -1),
        torch.stack([m[0][2] - m[2][0], m[0][1] + m[1][0], 1 + m[1][1] - m[0][0] - m[2][2],
                     m[1][2] + m[2][1]], -1),
        torch.stack([m[1][0] - m[0][1], m[0][2] + m[2][0], m[1][2] + m[2][1],
                     1 + m[2][2] - m[0][0] - m[1][1]], -1),
    ], -2)
    best = torch.argmax(torch.linalg.norm(cands, dim=-1), dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def se3_log(T):
    """[..., 4, 4] -> (omega, v) [..., 6]; the rotation through its
    quaternion."""
    q = _rotmat_to_quat(T[..., :3, :3])
    qw, qv = q[..., 0], q[..., 1:]
    nv = torch.sqrt(torch.clamp((qv * qv).sum(-1), min=1e-24))
    small = nv < 1e-6
    safe = torch.where(small, torch.ones_like(nv), nv)
    w = torch.where(small, 2.0 + nv * nv / 3.0, 2.0 * torch.atan2(nv, qw) / safe)[..., None] * qv
    theta_sq = (w * w).sum(-1)
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS * _EPS))
    small = theta_sq < 1e-8
    one = torch.ones_like(theta)
    half = torch.where(small, one, theta) * 0.5
    cot = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                      (1.0 - half * torch.cos(half) / torch.sin(half))
                      / torch.where(small, one, theta_sq))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    v_inv = eye - 0.5 * W + cot[..., None, None] * torch.matmul(W, W)
    return torch.cat([w, mat_vec(v_inv, T[..., :3, 3])], -1)


def cubic_spline(knots, t0, dt, t):
    """Cumulative cubic B-spline on SE(3) at times t [Q]: [Q, 4, 4].
    T(u) = T_j exp(B1 W1) exp(B2 W2) exp(B3 W3), W_k = log(T_{j+k-1}^-1 T_{j+k})."""
    s = (t - t0) / dt
    base = torch.clamp(torch.floor(s).to(torch.int32), 0, knots.shape[0] - 4).long()
    u = s - base.to(s.dtype)
    u2, u3 = u * u, u * u * u
    basis = ((5.0 + 3.0 * u - 3.0 * u2 + u3) / 6.0, (1.0 + 3.0 * u + 3.0 * u2 - 2.0 * u3) / 6.0,
             u3 / 6.0)
    out = knots[base]
    for k, b in enumerate(basis, start=1):
        rel = se3_log(torch.matmul(se3_inverse(knots[base + k - 1]), knots[base + k]))
        out = torch.matmul(out, se3_exp(b[:, None] * rel))
    return out


def virtual_times(t_start, exposure, n: int):
    """n times spread uniformly over the exposure [t, t + exposure]."""
    frac = (torch.arange(n, dtype=torch.float32, device=t_start.device) + 0.5) / n
    return t_start + frac * exposure


def look_at(eye, device) -> torch.Tensor:
    """World-to-camera matrix of a camera at `eye` looking at the origin,
    +y of the world up."""
    f32 = dict(dtype=torch.float32, device=device)
    eye = torch.as_tensor(eye, **f32)
    fwd = -eye / torch.linalg.norm(eye)
    right = torch.linalg.cross(fwd, torch.tensor([0.0, 1.0, 0.0], **f32))
    right = right / torch.linalg.norm(right)
    down = torch.linalg.cross(fwd, right)
    R = torch.stack([right, down, fwd], 0)
    return rt_to_mat(R, -mat_vec(R, eye))


def orbit_viewmat(angle: float, radius: float, height: float, device) -> torch.Tensor:
    """The orbit camera at `angle` (radians) about the y axis."""
    return look_at((radius * np.sin(angle), height, -radius * np.cos(angle)), device)
