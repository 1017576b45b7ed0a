"""Continuous-time SE(3) camera trajectories.

Counterpart of casualhdrsplat_tpu/geometry/spline.py: linear interpolation
and the cumulative cubic B-spline over 4x4 knots, differentiable w.r.t.
the knots through the closed-form exp/log of geometry/lie.py.  All query
times evaluate as one batch (the reference vmaps over them).

Knot layout: `knots[M, 4, 4]` with uniformly spaced knot times
`t_j = t0 + j * dt`.  Queries are continuous times `t`.
"""

from __future__ import annotations

import math

import torch

from casualhdrsplat_torch.geometry import lie


def _segment_and_u(t, t0, dt, num_knots, order):
    """Map continuous time -> (base knot index, local parameter u in [0,1])."""
    s = (t - t0) / dt
    max_base = num_knots - order  # highest valid starting knot index
    base = torch.clamp(torch.floor(s).to(torch.int32), 0, max_base).long()
    u = s - base.to(s.dtype)
    return base, u


def _times(knots: torch.Tensor, t) -> torch.Tensor:
    return torch.atleast_1d(torch.as_tensor(t, dtype=knots.dtype, device=knots.device))


def linear_interpolation(knots: torch.Tensor, t0, dt, t) -> torch.Tensor:
    """Piecewise-geodesic interpolation between adjacent knots:
    T(u) = T_j @ exp(u * log(T_j^-1 @ T_{j+1}))."""
    base, u = _segment_and_u(_times(knots, t), t0, dt, knots.shape[0], order=2)
    Ta, Tb = knots[base], knots[base + 1]
    rel = lie.se3_log(lie.mat_mul(lie.se3_inverse(Ta), Tb))
    return lie.mat_mul(Ta, lie.se3_exp(u[:, None] * rel))


def cubic_bspline_interpolation(knots: torch.Tensor, t0, dt, t) -> torch.Tensor:
    """Cumulative cubic B-spline on SE(3) (C^2 trajectory).

    T(u) = T_j @ exp(B1(u) W1) @ exp(B2(u) W2) @ exp(B3(u) W3)
    with W_k = log(T_{j+k-1}^-1 @ T_{j+k}) and the cumulative basis
      B1 = (5 + 3u - 3u^2 + u^3)/6, B2 = (1 + 3u + 3u^2 - 2u^3)/6, B3 = u^3/6.
    """
    base, u = _segment_and_u(_times(knots, t), t0, dt, knots.shape[0], order=4)
    u2 = u * u
    u3 = u2 * u
    b1 = (5.0 + 3.0 * u - 3.0 * u2 + u3) / 6.0
    b2 = (1.0 + 3.0 * u + 3.0 * u2 - 2.0 * u3) / 6.0
    b3 = u3 / 6.0
    # the three segments' W_k and exp(B_k W_k) as one batch [Q, 3, ...]
    # (a third of the small kernels of three calls)
    idx = base[:, None] + torch.arange(3, device=base.device)
    rel = lie.se3_log(lie.mat_mul(lie.se3_inverse(knots[idx]), knots[idx + 1]))
    steps = lie.se3_exp(torch.stack([b1, b2, b3], dim=-1)[..., None] * rel)
    out = knots[base]
    for k in range(3):
        out = lie.mat_mul(out, steps[:, k])
    return out


def interpolate(knots, t0, dt, t, mode: str = "cubic"):
    if mode == "linear":
        return linear_interpolation(knots, t0, dt, t)
    if mode == "cubic":
        return cubic_bspline_interpolation(knots, t0, dt, t)
    raise ValueError(f"unknown spline mode {mode!r}")


def sample_virtual_times(t_start: torch.Tensor, delta_t, n: int) -> torch.Tensor:
    """n timestamps uniformly spanning the exposure window [t, t+delta_t]
    (on `t_start`'s device)."""
    t_start = torch.as_tensor(t_start, dtype=torch.float32)
    frac = (torch.arange(n, dtype=torch.float32, device=t_start.device) + 0.5) / n
    return t_start + frac * delta_t


def dense_grid(num_frames: int, per_frame: int, pad: int = 2, tail: float = 1.0,
               device="cuda"):
    """Uniform sub-frame knot grid: `per_frame` knots per frame interval
    over frame times [0, num_frames-1] plus `tail` intervals of exposure
    overhang plus `pad` knots beyond each end.  Returns (times [M], t0, dt)
    with dt = 1/per_frame."""
    k = per_frame
    j = torch.arange(
        -pad, (num_frames - 1) * k + math.ceil(tail * k) + pad + 1,
        dtype=torch.float32, device=device,
    )
    return j / k, -pad / k, 1.0 / k


def resample_knots(
    knots: torch.Tensor,
    t0,
    dt,
    num_frames: int,
    per_frame: int,
    pad: int = 2,
    tail: float = 1.0,
    mode: str = "cubic",
):
    """Resample a frame-rate knot grid onto dense_grid: new knot j =
    spline(old knots; clamp(t_j, 0, num_frames-1)).  Returns
    (knots' [M',4,4], t0', dt')."""
    times, t0n, dtn = dense_grid(num_frames, per_frame, pad=pad, tail=tail,
                                 device=knots.device)
    q = torch.clamp(times, 0.0, float(num_frames - 1))
    return interpolate(knots, t0, dt, q, mode=mode), t0n, dtn


def knots_for_frames(frame_poses: torch.Tensor, pad: int = 2):
    """Spline knots from per-frame poses, boundary poses repeated `pad`
    times; returns (knots[M,4,4], t0, dt) for frame timestamps 0..N-1."""
    first = frame_poses[:1].repeat(pad, 1, 1)
    last = frame_poses[-1:].repeat(pad, 1, 1)
    return torch.cat([first, frame_poses, last], dim=0), -float(pad), 1.0
