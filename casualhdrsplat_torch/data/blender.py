"""Blender / NeRF-synthetic `transforms.json` loader.  Counterpart of
casualhdrsplat_tpu/data/blender.py.

Standard NeRF-synthetic scenes (and any tool that writes
`transforms*.json`) load straight into the trainer.  Camera-to-world
matrices use the OpenGL convention (x right, y up, z backward); they are
converted to the COLMAP/OpenCV world-to-camera convention used throughout
the package.  Host-side numpy, like every loader.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

# OpenGL cam-to-world -> OpenCV: flip the y and z camera axes.
_GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def load_blender_dataset(
    path: str,
    split: str = "train",
    downscale: int = 1,
    white_background: bool = True,
    max_frames: Optional[int] = None,
):
    """Load `<path>/transforms_<split>.json` (or `transforms.json`)."""
    from casualhdrsplat_torch.data.dataset import Dataset, _load_image

    for cand in (f"transforms_{split}.json", "transforms.json"):
        meta_path = os.path.join(path, cand)
        if os.path.exists(meta_path):
            break
    else:
        raise FileNotFoundError(f"no transforms json under {path}")
    with open(meta_path) as f:
        meta = json.load(f)

    frames = meta["frames"]
    if max_frames:
        frames = frames[:max_frames]
    images, viewmats = [], []
    for fr in frames:
        fp = os.path.join(path, fr["file_path"])
        if not os.path.splitext(fp)[1]:
            fp += ".png"
        images.append(_load_image(fp, downscale, background=1.0 if white_background else 0.0))
        c2w = np.asarray(fr["transform_matrix"], np.float32) @ _GL_TO_CV
        viewmats.append(np.linalg.inv(c2w).astype(np.float32))

    h, w = images[0].shape[:2]
    if "camera_angle_x" in meta:
        fx = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
        fy = fx
    else:
        fx = float(meta["fl_x"]) / downscale
        fy = float(meta.get("fl_y", meta["fl_x"])) / downscale
    cx = float(meta.get("cx", w / 2.0 * downscale)) / downscale
    cy = float(meta.get("cy", h / 2.0 * downscale)) / downscale

    # no SfM points in this format: seed a uniform cloud inside the camera
    # rig's bounding sphere (the lineage's random-init fallback)
    cams = np.stack([np.linalg.inv(v)[:3, 3] for v in viewmats])
    center = cams.mean(axis=0)
    radius = float(np.linalg.norm(cams - center, axis=1).max()) * 0.6
    rng = np.random.default_rng(0)
    pts = center + rng.uniform(-radius, radius, size=(20_000, 3)).astype(np.float32)
    rgb = rng.uniform(0.3, 0.7, size=(20_000, 3)).astype(np.float32)

    ts = [float(fr.get("time", i)) for i, fr in enumerate(frames)]
    return Dataset(
        images=np.stack(images),
        timestamps=np.asarray(ts, np.float32),
        viewmats=np.stack(viewmats),
        fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h,
        points_xyz=pts, points_rgb=rgb,
    )
