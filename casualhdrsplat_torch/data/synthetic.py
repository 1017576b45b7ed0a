"""Synthetic scene sources, numpy-seeded.  Counterpart of the scene half
of casualhdrsplat_tpu/data/synthetic.py (`make_casual_video` is not
ported yet).

The same numpy generator state yields the same draws in both packages.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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
