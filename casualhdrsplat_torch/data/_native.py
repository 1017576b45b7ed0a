"""ctypes loader for the repository's optional native host helpers
(native/*.cc, built with `make -C native` into native/libchs_native.so).
The port's own copy of casualhdrsplat_tpu/data/_native.py.

These are plain C++ host code (a COLMAP points3D reader and a k-NN), not
kernels.  Everything here is optional: each caller falls back to its
Python implementation when the library is absent.
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache

import numpy as np

_LIB_NAMES = ("libchs_native.so",)


@lru_cache(maxsize=1)
def load():
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for name in _LIB_NAMES:
        for sub in ("native", "native/build"):
            path = os.path.join(root, sub, name)
            if os.path.exists(path):
                try:
                    lib = ctypes.CDLL(path)
                    _bind(lib)
                    return lib
                except OSError:
                    return None
    return None


def _bind(lib):
    lib.chs_read_points3d_count.argtypes = [ctypes.c_char_p]
    lib.chs_read_points3d_count.restype = ctypes.c_longlong
    lib.chs_read_points3d.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_longlong,
    ]
    lib.chs_read_points3d.restype = ctypes.c_int
    lib.chs_knn_mean_dist.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_longlong,
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
    ]
    lib.chs_knn_mean_dist.restype = ctypes.c_int


def read_points3d(lib, path: str):
    n = lib.chs_read_points3d_count(path.encode())
    if n < 0:
        return None
    xyz = np.empty((n, 3), np.float32)
    rgb = np.empty((n, 3), np.float32)
    if lib.chs_read_points3d(path.encode(), xyz, rgb, n) != 0:
        return None
    return xyz, rgb


def knn_mean_dist(lib, points: np.ndarray, k: int) -> np.ndarray:
    points = np.ascontiguousarray(points, np.float32)
    out = np.empty((points.shape[0],), np.float32)
    if lib.chs_knn_mean_dist(points, points.shape[0], k, out) != 0:
        raise RuntimeError("native knn failed")
    return out
