"""The plain reference against the system under test's CPU path on tiny
scenes: the rasterizer on both paths, one training cell's compared steps
and one serving cell's renders, driven through the harness."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, loops
from benchmark.reference import geometry as geo
from benchmark.reference import render as ref
from benchmark.tests.tiny import tiny_cell

RASTERS = {
    "packed, shared binning": dict(packed=True, shared_binning=True, tile_h=8, tile_w=16,
                                   chunk=32, stream_factor=6),
    "packed, per view, waterfilled": dict(packed=True, shared_binning=False, tile_h=8, tile_w=16,
                                          chunk=32, stream_factor=2),
    "dense, over capacity": dict(packed=False, tile_h=8, tile_w=8, chunk=32, tile_capacity=64),
}


def _cloud(n=400, seed=1):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(n, 4, generator=g)
    return (torch.rand(n, 3, generator=g) * 2 - 1, q / q.norm(dim=-1, keepdim=True),
            torch.rand(n, 3, generator=g) * 0.06 + 0.02, torch.rand(n, generator=g) * 0.65 + 0.3,
            torch.rand(3, n, 3, generator=g) * 2)


@pytest.mark.parametrize("name", list(RASTERS))
def test_rasterizer_matches_the_program(name):
    from casualhdrsplat_torch.config import RasterizeConfig
    from casualhdrsplat_torch.ops import rasterize as prog

    means, quats, scales, opac, rgb = _cloud()
    vms = torch.stack([geo.orbit_viewmat(a, 4.0, 0.6, "cpu") for a in (0.0, 0.05, 0.1)])
    size = 64
    cam = (0.9 * size, 0.9 * size, size / 2, size / 2, size, size)
    rc = RasterizeConfig(**RASTERS[name])
    img, alpha, aux = prog.rasterize(means, quats, scales, opac, rgb, vms,
                                     *[torch.tensor(c) for c in cam[:4]], size, size, rc)
    out = ref.rasterize(means, quats, scales, opac, rgb, vms, cam, ref.raster_from(vars(rc)))
    assert torch.allclose(out.hdr, img, rtol=1e-6, atol=1e-6)
    assert torch.allclose(out.alpha, alpha, rtol=1e-6, atol=1e-6)
    assert out.dropped == int(aux.num_dropped) and out.clipped == int(aux.num_clipped)
    assert (name == "packed, shared binning") == (out.dropped == 0)


@pytest.mark.parametrize("workload", ["ladder4.train", "ladder4-dense.train",
                                      "ladder4.serve", "ladder4-dense.serve"])
def test_cell_readings_on_the_cpu(workload):
    """The compared steps (train) and the kept requests' renders (serve)
    of a tiny cell agree with the reference inside the cell's limits."""
    cell = tiny_cell(workload)
    loop = loops.load_kind(cell.traffic["kind"])(cell, 4294967311, torch.device("cpu"))
    loop.setup()
    if cell.traffic["kind"] == "serve":
        loop.window(0.5)
        assert loop.kept and {req[2] for _, req, _ in loop.kept} <= {"ldr", "hdr"}
    loop.release()
    readings = loop.readings()
    for name, limit in cell.limits.items():
        assert readings[name] <= limit, (name, readings[name], limit)


def test_run_cell_reports_the_contract_fields():
    cell = tiny_cell("ladder4.serve")
    res = harness.run_cell(cell, 12, 0.5, False, torch.device("cpu"), 0.0, log=lambda *a, **k: 0)
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"render_p50_ms", "render_p95_ms", "setup_s"}
    assert res["checks"]["image_gap"]["limit"] == cell.limits["image_gap"]
