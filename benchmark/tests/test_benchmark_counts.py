"""The frozen work counts against a brute-force walk of every pixel."""

from __future__ import annotations

import math

import pytest
import torch

from benchmark.counts import ops, work
from benchmark.reference import geometry as geo
from benchmark.reference import render as ref

CASES = {
    "packed": ref.Raster(True, 8, 16, 1024, 32, 32, 6, True, 0.05, 0.99, 1 / 255, 1e-4),
    "packed, per view, waterfilled": ref.Raster(True, 8, 16, 1024, 32, 32, 2, False, 0.05,
                                                0.99, 1 / 255, 1e-4),
    "dense": ref.Raster(False, 8, 8, 64, 32, 32, 6, False, 0.05, 0.99, 1 / 255, 1e-4),
}


def _binned(r: ref.Raster, n=300, size=48):
    g = torch.Generator().manual_seed(3)
    q = torch.randn(n, 4, generator=g)
    means = torch.rand(n, 3, generator=g) * 2 - 1
    vms = torch.stack([geo.orbit_viewmat(a, 4.0, 0.6, "cpu") for a in (0.0, 0.08)])
    cam = (0.9 * size, 0.9 * size, size / 2, size / 2, size, size)
    return ref.bin_views(means, q / q.norm(dim=-1, keepdim=True),
                         torch.rand(n, 3, generator=g) * 0.08 + 0.02,
                         torch.rand(n, generator=g) * 0.65 + 0.3,
                         torch.rand(2, n, 3, generator=g), vms, cam, r)


def _brute(b: ref.Binned, r: ref.Raster):
    """Every pixel on its own: walk its tile's slots in order, count the
    pairs with alpha >= threshold while T >= eps, and the slots some pixel
    of the tile still needs, and their distinct payload rows."""
    pairs = slots = 0
    rows = set()
    tiles = b.ntx * b.nty
    for row in range(b.windows.shape[0]):
        t = row % tiles
        ox, oy = (t % b.ntx) * r.tile_w, (t // b.ntx) * r.tile_h
        entries = []
        for k in range(int(b.windows[row])):
            index, in_list = b.slot_of(torch.tensor([row]), k)
            entries += [int(i) for i, keep in zip(index[0], in_list[0]) if keep]
        trans = {}
        for idx in entries:
            mx, my, cxx, cxy, cyy, opa = (float(v) for v in b.payload[idx, :6])
            needed = False
            for y in range(r.tile_h):
                for x in range(r.tile_w):
                    tr = trans.get((x, y), 1.0)
                    if tr < r.transmittance_eps:
                        continue
                    needed = True
                    dx, dy = ox + x + 0.5 - mx, oy + y + 0.5 - my
                    power = -(0.5 * (cxx * dx * dx + cyy * dy * dy) + cxy * dx * dy)
                    a = min(opa * math.exp(min(power, 0.0)), r.alpha_clip)
                    if a >= r.alpha_threshold:
                        pairs += 1
                        trans[(x, y)] = tr * (1.0 - a)
            if needed:
                slots += 1
                rows.add(idx)
    return pairs, slots, len(rows)


@pytest.mark.parametrize("name", list(CASES))
def test_composite_work_equals_a_walk_of_every_pixel(name):
    r = CASES[name]
    b = _binned(r)
    got = work.composite_work(b, r)
    want = _brute(b, r)
    # float32 against float64 transmittance: a pair within rounding of eps
    # may fall on either side
    assert got[1:] == want[1:] and abs(got[0] - want[0]) <= 2, (got, want)
    assert got[0] > 0


def test_kernel_counts_follow_the_work():
    w = work.Work(pairs=1000, slots=100, rows=50, pixels=64, gaussian_views=10, params=20,
                  crf_pixels=64, loss_pixels=32, units=1)
    assert ops.b1(w) == (26_000, 36 * 100 + 16 * 64)
    assert ops.b2(w) == (63_000, 72 * 100 + 32 * 64)
    assert ops.b3(w) == (26_000, 4 * 100 + 36 * 50 + 16 * 64)
    assert ops.b4(w) == (63_000, 4 * 100 + 72 * 50 + 32 * 64)
    assert ops.roofline_seconds(67e12, 0) == 1.0
    assert ops.step_ops(w, 32) > ops.render_ops(w, 32) > 26_000
