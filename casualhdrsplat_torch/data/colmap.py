"""COLMAP sparse-model parser.  The port's own copy of
casualhdrsplat_tpu/data/colmap.py.

Reads the standard COLMAP binary and text formats (`cameras.bin`,
`images.bin`, `points3D.bin` or their `.txt` forms) produced by the
offline SfM step: COLMAP stays an external process, its output is read
here.

A native C++ reader of the (large) points3D file lives in
native/chs_native.cc; this module uses it when data/_native.py can build
the shared library (at first use, with the host compiler), else the
pure-Python reader.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

# COLMAP camera model ids -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class ColmapCamera:
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific

    def pinhole(self) -> Tuple[float, float, float, float]:
        """Return (fx, fy, cx, cy).  Distortion terms are handled by
        `data/undistort.py` at image-load time (the lineage shells out to
        COLMAP's image_undistorter instead)."""
        p = self.params
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
            # single-focal models: (f, cx, cy, ...)
            return float(p[0]), float(p[0]), float(p[1]), float(p[2])
        # (fx, fy, cx, cy, ...) models — incl. FOV, whose params are
        # fx fy cx cy omega (not single-focal).
        return float(p[0]), float(p[1]), float(p[2]), float(p[3])

    def has_distortion(self) -> bool:
        p = np.asarray(self.params, np.float64)
        if self.model in ("SIMPLE_PINHOLE", "PINHOLE"):
            return False
        if self.model in ("SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
            return bool(np.any(np.abs(p[3:]) > 1e-12))
        return bool(np.any(np.abs(p[4:]) > 1e-12))


@dataclass
class ColmapImage:
    camera_id: int
    name: str
    qvec: np.ndarray  # [4] (w,x,y,z) world->cam rotation
    tvec: np.ndarray  # [3] world->cam translation

    def viewmat(self) -> np.ndarray:
        w, x, y, z = self.qvec
        R = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        M = np.eye(4)
        M[:3, :3] = R
        M[:3, 3] = self.tvec
        return M.astype(np.float32)


def _read(fid, fmt):
    return struct.unpack(fmt, fid.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cams[cam_id] = ColmapCamera(name, int(width), int(height), params)
    return cams


def read_images_bin(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            image_id, qw, qx, qy, qz, tx, ty, tz, cam_id = _read(f, "<idddddddi")
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n_pts,) = _read(f, "<Q")
            f.read(24 * n_pts)  # skip 2D points (x, y, point3D_id)
            images[image_id] = ColmapImage(
                camera_id=cam_id,
                name=name.decode("utf-8"),
                qvec=np.array([qw, qx, qy, qz]),
                tvec=np.array([tx, ty, tz]),
            )
    return images


def read_points3d_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (xyz[M,3] float32, rgb[M,3] float32 in [0,1])."""
    native = _try_native_points3d(path)
    if native is not None:
        return native
    xyzs, rgbs = [], []
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            _pid, x, y, z, r, g, b, _err = _read(f, "<QdddBBBd")
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
            xyzs.append((x, y, z))
            rgbs.append((r, g, b))
    xyz = np.asarray(xyzs, np.float32).reshape(-1, 3)
    rgb = np.asarray(rgbs, np.float32).reshape(-1, 3) / 255.0
    return xyz, rgb


def _try_native_points3d(path: str):
    from casualhdrsplat_torch.data import _native

    lib = _native.load()
    if lib is None:
        return None
    return _native.read_points3d(lib, path)


def read_text_model(model_dir: str):
    """Text-format fallback (cameras.txt/images.txt/points3D.txt)."""
    cams, images = {}, {}
    with open(os.path.join(model_dir, "cameras.txt")) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            cams[int(parts[0])] = ColmapCamera(
                parts[1], int(parts[2]), int(parts[3]),
                np.array([float(v) for v in parts[4:]]),
            )
    with open(os.path.join(model_dir, "images.txt")) as f:
        lines = [l for l in f if not l.startswith("#") and l.strip()]
    for meta in lines[0::2]:
        parts = meta.split()
        images[int(parts[0])] = ColmapImage(
            camera_id=int(parts[8]),
            name=parts[9],
            qvec=np.array([float(v) for v in parts[1:5]]),
            tvec=np.array([float(v) for v in parts[5:8]]),
        )
    xyzs, rgbs = [], []
    pts_path = os.path.join(model_dir, "points3D.txt")
    if os.path.exists(pts_path):
        with open(pts_path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                parts = line.split()
                xyzs.append([float(v) for v in parts[1:4]])
                rgbs.append([float(v) / 255.0 for v in parts[4:7]])
    xyz = np.asarray(xyzs, np.float32).reshape(-1, 3)
    rgb = np.asarray(rgbs, np.float32).reshape(-1, 3)
    return cams, images, xyz, rgb


def load_model(model_dir: str):
    """Load a COLMAP sparse model dir (binary preferred, text fallback).

    Returns (cameras, images, xyz[M,3], rgb[M,3]).
    """
    if os.path.exists(os.path.join(model_dir, "cameras.bin")):
        cams = read_cameras_bin(os.path.join(model_dir, "cameras.bin"))
        images = read_images_bin(os.path.join(model_dir, "images.bin"))
        xyz, rgb = read_points3d_bin(os.path.join(model_dir, "points3D.bin"))
        return cams, images, xyz, rgb
    return read_text_model(model_dir)
