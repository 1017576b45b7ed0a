"""ctypes loader for the repository's native host helpers (native/chs_native.cc):
the uniform-grid k-NN that initialises the Gaussians' scales
(`chs_knn_mean_dist`, called by ops/knn.py) and a COLMAP points3D reader.
The port's own copy of casualhdrsplat_tpu/data/_native.py.

These are plain C++ host code, not kernels.  The port builds the library
itself at first use, as it builds its kernels: `ops/cuda_build.build_host`
compiles native/chs_native.cc with the host compiler (or nvcc) into
casualhdrsplat_torch/_build/, named by a hash of the source and the
command, under the span `chs.kernel.build`.  `load()` is None where it
cannot be built (no compiler): the COLMAP reader then falls back to
Python and the k-NN, on the CPU, to its NumPy brute force; `library()`
raises instead, for the k-NN on a card, whose brute force cannot hold a
large cloud.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "chs_native.cc"
_LOCK = threading.Lock()


@lru_cache(maxsize=1)
def _open():
    from casualhdrsplat_torch.ops import cuda_build

    lib = ctypes.CDLL(str(cuda_build.build_host(SOURCE)))
    _bind(lib)
    return lib


def library():
    """The native library, built at first use; raises RuntimeError or
    OSError where it cannot be built or loaded."""
    with _LOCK:  # one build a process, whichever thread asks first
        return _open()


def load():
    """The native library, or None where it cannot be built or loaded."""
    try:
        return library()
    except (RuntimeError, OSError):
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
    """The grid search: each point's mean distance to its k nearest
    neighbours (itself excluded, duplicates counted), exact in float32;
    [M, 3] -> [M] float32."""
    points = np.ascontiguousarray(points, np.float32)
    out = np.empty((points.shape[0],), np.float32)
    if lib.chs_knn_mean_dist(points, points.shape[0], k, out) != 0:
        raise RuntimeError("native knn failed")
    return out
