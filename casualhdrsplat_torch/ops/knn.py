"""k-NN mean distance for Gaussian scale initialization.

Counterpart of casualhdrsplat_tpu/ops/knn.py.  `knn_mean_dist` computes the
reference's brute-force blocks in torch on the device it is asked for: one
[2048, M] squared-distance block at a time (a plain matrix product) and its
k + 1 smallest entries by `torch.topk`.  `knn_mean_dist_numpy` is the port's
own copy of the reference's NumPy path, kept as the tests' yardstick.
"""

from __future__ import annotations

import numpy as np
import torch


def knn_mean_dist(points, k: int = 3, chunk: int = 2048, device="cuda") -> torch.Tensor:
    """Mean Euclidean distance from each point to its k nearest neighbours
    (excluding itself).  [M,3] -> [M] float32 on `device`."""
    points = torch.as_tensor(np.asarray(points, np.float32), device=device)
    m = points.shape[0]
    if m <= 1:
        return torch.full((m,), 0.01, dtype=torch.float32, device=device)
    k = min(k, m - 1)
    out = torch.empty((m,), dtype=torch.float32, device=device)
    sq = (points ** 2).sum(-1)
    for s in range(0, m, chunk):
        e = min(s + chunk, m)
        d2 = sq[s:e, None] + sq[None, :] - 2.0 * points[s:e] @ points.T
        d2.clamp_(min=0.0)
        # ascending: entry 0 is the point itself (or a duplicate of it)
        part = torch.topk(d2, k + 1, dim=1, largest=False, sorted=True).values
        out[s:e] = torch.sqrt(part[:, 1:k + 1]).mean(dim=1)
    return out


def knn_mean_dist_numpy(points: np.ndarray, k: int = 3, chunk: int = 2048) -> np.ndarray:
    """The same on the host in NumPy.  [M,3] -> [M]."""
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
