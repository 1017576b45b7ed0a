"""Real spherical harmonics, degree 0..3, as linear HDR radiance.

Counterpart of casualhdrsplat_tpu/ops/sh.py: the `+0.5` DC offset is
applied and values are clamped at 0 but not above 1.  Elementwise over
Gaussians, so plain tensor code (autograd gives the backward).
"""

from __future__ import annotations

import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh(degree: int, coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """coeffs [..., K, 3] (K >= num_sh_bases(degree)), dirs [..., 3] ->
    [..., 3] linear radiance (>= 0, unbounded above)."""
    d = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-8)
    x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]

    result = _C0 * coeffs[..., 0, :]
    if degree >= 1:
        result = result + _C1 * (
            -y * coeffs[..., 1, :] + z * coeffs[..., 2, :] - x * coeffs[..., 3, :]
        )
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result = result + (
            _C2[0] * xy * coeffs[..., 4, :]
            + _C2[1] * yz * coeffs[..., 5, :]
            + _C2[2] * (2.0 * zz - xx - yy) * coeffs[..., 6, :]
            + _C2[3] * xz * coeffs[..., 7, :]
            + _C2[4] * (xx - yy) * coeffs[..., 8, :]
        )
    if degree >= 3:
        result = result + (
            _C3[0] * y * (3 * xx - yy) * coeffs[..., 9, :]
            + _C3[1] * xy * z * coeffs[..., 10, :]
            + _C3[2] * y * (4 * zz - xx - yy) * coeffs[..., 11, :]
            + _C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * coeffs[..., 12, :]
            + _C3[4] * x * (4 * zz - xx - yy) * coeffs[..., 13, :]
            + _C3[5] * z * (xx - yy) * coeffs[..., 14, :]
            + _C3[6] * x * (xx - 3 * yy) * coeffs[..., 15, :]
        )
    return torch.clamp(result + 0.5, min=0.0)


def rgb_to_sh_dc(rgb: torch.Tensor) -> torch.Tensor:
    """Inverse of the DC term: rgb -> coeff such that eval_sh(0) == rgb."""
    return (rgb - 0.5) / _C0
