"""k-NN mean distance for Gaussian scale initialization.

The port's own copy of casualhdrsplat_tpu/ops/knn.py's NumPy path: it runs
once at init time on the host, so it is not a device kernel.
"""

from __future__ import annotations

import numpy as np


def knn_mean_dist(points: np.ndarray, k: int = 3, chunk: int = 2048) -> np.ndarray:
    """Mean Euclidean distance from each point to its k nearest neighbors
    (excluding itself).  [M,3] -> [M]."""
    points = np.asarray(points, np.float32)
    m = len(points)
    if m <= 1:
        return np.full((m,), 0.01, np.float32)
    k = min(k, m - 1)
    out = np.empty((m,), np.float32)
    sq = (points**2).sum(-1)
    for s in range(0, m, chunk):
        e = min(s + chunk, m)
        d2 = sq[s:e, None] + sq[None, :] - 2.0 * points[s:e] @ points.T
        np.maximum(d2, 0.0, out=d2)
        idx = np.argpartition(d2, k, axis=1)[:, : k + 1]
        part = np.take_along_axis(d2, idx, axis=1)
        part.sort(axis=1)
        out[s:e] = np.sqrt(part[:, 1 : k + 1]).mean(axis=1)
    return out
