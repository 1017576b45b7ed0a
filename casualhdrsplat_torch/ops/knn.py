"""k-NN mean distance for Gaussian scale initialization.

Counterpart of casualhdrsplat_tpu/ops/knn.py, on the reference's own
route: `knn_mean_dist` runs on the host, through the uniform-grid search
of native/chs_native.cc (an exact search that widens rings of cells until
the k-th distance is safe; data/_native.py builds the library at first use
into casualhdrsplat_torch/_build/), and copies the result to `device` once.
Where the library cannot be built it falls back to the NumPy brute force
`knn_mean_dist_numpy` on the CPU; on a card it raises instead, as a
kernel's failed build does, since a brute force's [chunk, M] blocks
cannot hold a large cloud (24 GiB a block at M = 3,145,728).

Each call is the span `chs.init.knn` and leaves its record in `LAST`:
points, route and host-clock ms after a sync (the library's build not
counted: it is the span `chs.kernel.build`).

`knn_mean_dist_numpy` is also the tests' yardstick, and
`knn_mean_dist_brute`, the same brute force in torch, the card's (on a
subset small enough for its blocks).  Both brute forces pick candidates
by |p|^2 + |q|^2 - 2 p.q in blocks of `chunk` rows and then take the
distances of those candidates from the coordinate differences,
(dx^2 + dy^2) + dz^2 in float32 as the grid search does, so that the
expanded form's cancellation (errors of 1e-7 |p|^2 in d^2, 3e-4 of the
distance at 262,144 points in [-1, 1]^3) never reaches a value.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from casualhdrsplat_torch.data import _native
from casualhdrsplat_torch.utils import profiling

# candidates beyond the k + 1 nearest by the expanded form, re-measured
# exactly: far more than the expanded form's rounding can reorder
EXTRA_CANDIDATES = 16


class KnnCall(NamedTuple):
    """The record of one `knn_mean_dist` call."""

    points: int
    route: str  # "grid" (native/chs_native.cc) or "brute" (the fallback)
    ms: float  # host clock, from the search's start to the result on `device`


# the last call's record, None before the first
LAST: Optional[KnnCall] = None


def knn_mean_dist(points, k: int = 3, chunk: int = 2048, device="cuda") -> torch.Tensor:
    """Mean Euclidean distance from each point to its k nearest neighbours
    (excluding itself).  [M,3] -> [M] float32 on `device`.  `chunk` is the
    fallback's block of rows."""
    global LAST
    device = torch.device(device)
    points = np.ascontiguousarray(points, np.float32)
    with profiling.span("init.knn", len(points)):
        lib = _native.library() if device.type == "cuda" else _native.load()
        t0 = time.perf_counter()
        if lib is not None:
            out = torch.from_numpy(_native.knn_mean_dist(lib, points, k)).to(device)
            route = "grid"
        else:
            out = torch.from_numpy(knn_mean_dist_numpy(points, k, chunk)).to(device)
            route = "brute"
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        LAST = KnnCall(len(points), route, (time.perf_counter() - t0) * 1e3)
    return out


def knn_mean_dist_brute(points, k: int = 3, chunk: int = 2048, device="cpu") -> torch.Tensor:
    """The brute force in torch on `device`, the grid's yardstick on the
    card: [chunk, M] blocks of the expanded form, the k + 1 +
    EXTRA_CANDIDATES smallest of each row (the point itself forced in)
    re-measured from the coordinates.  [M,3] -> [M]."""
    points = torch.as_tensor(np.asarray(points, np.float32), device=device)
    m = points.shape[0]
    if m <= 1:
        return torch.full((m,), 0.01, dtype=torch.float32, device=device)
    k = min(k, m - 1)
    c = min(k + 1 + EXTRA_CANDIDATES, m)
    out = torch.empty((m,), dtype=torch.float32, device=device)
    sq = (points ** 2).sum(-1)
    for s in range(0, m, chunk):
        e = min(s + chunk, m)
        d2 = sq[s:e, None] + sq[None, :] - 2.0 * points[s:e] @ points.T
        d2.clamp_(min=0.0)
        rows = torch.arange(e - s, device=device)
        d2[rows, rows + s] = -1.0  # the point itself, the entry dropped below
        cand = torch.topk(d2, c, dim=1, largest=False, sorted=False).indices
        del d2
        exact = _sq_dist(points[cand], points[s:e, None]).sort(dim=1).values
        out[s:e] = torch.sqrt(exact[:, 1:k + 1]).mean(dim=1)
    return out


def _sq_dist(q, p):
    """(dx^2 + dy^2) + dz^2 of q - p, in this order (a reduction over the
    last axis would pick its own)."""
    d = q - p
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def knn_mean_dist_numpy(points: np.ndarray, k: int = 3, chunk: int = 2048) -> np.ndarray:
    """The brute force in NumPy on the host.  [M,3] -> [M]."""
    points = np.asarray(points, np.float32)
    m = len(points)
    if m <= 1:
        return np.full((m,), 0.01, np.float32)
    k = min(k, m - 1)
    c = min(k + 1 + EXTRA_CANDIDATES, m)
    out = np.empty((m,), np.float32)
    sq = (points**2).sum(-1)
    for s in range(0, m, chunk):
        e = min(s + chunk, m)
        d2 = sq[s:e, None] + sq[None, :] - 2.0 * points[s:e] @ points.T
        np.maximum(d2, 0.0, out=d2)
        rows = np.arange(e - s)
        d2[rows, rows + s] = -1.0  # the point itself, the entry dropped below
        cand = np.argpartition(d2, c - 1, axis=1)[:, :c]
        exact = np.sort(_sq_dist(points[cand], points[s:e, None]), axis=1)
        out[s:e] = np.sqrt(exact[:, 1:k + 1]).mean(axis=1)
    return out
