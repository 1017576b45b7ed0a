"""Pinhole camera.  Counterpart of casualhdrsplat_tpu/geometry/camera.py."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from casualhdrsplat_torch.geometry import lie


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera with a world-to-camera extrinsic.

    viewmat: [4,4] world->camera (X_cam = R X_world + t).
    fx, fy, cx, cy: 0-dim float32 tensors, in pixels.
    width/height: Python ints.
    """

    viewmat: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int

    @staticmethod
    def make(viewmat, fx, fy, cx, cy, width, height, device="cuda") -> "Camera":
        def f32(v):
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        return Camera(
            viewmat=f32(viewmat), fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy),
            width=int(width), height=int(height),
        )

    def camtoworld(self) -> torch.Tensor:
        return lie.se3_inverse(self.viewmat)


def look_at(eye, target, up=(0.0, 1.0, 0.0), device="cuda") -> torch.Tensor:
    """World-to-camera viewmat for a camera at `eye` looking at `target`.

    Camera convention: +z forward, +x right, +y down (COLMAP/OpenCV).
    """

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    eye, target, up = f32(eye), f32(target), f32(up)
    fwd = target - eye
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.norm(right)
    down = torch.linalg.cross(fwd, right)
    R = torch.stack([right, down, fwd], dim=0)  # world->cam rotation
    return lie.rt_to_mat(R, -lie.mat_vec(R, eye))
