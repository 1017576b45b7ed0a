"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: 300
Gaussians at 48x48, 2 virtual views, 8x16 tiles, chunk 32 (the dense
path's capacity 64), 3 frames, and short slices."""

from __future__ import annotations

import copy

from benchmark import harness

GAUSSIANS, SIZE, VIEWS, FRAMES = 300, 48, 2, 3


def tiny_cell(workload: str, limits=None) -> harness.Cell:
    cell = harness.resolve(harness.load_spec(), workload)
    config = copy.deepcopy(cell.config)
    model = config["config"]["model"]
    model["max_gaussians"] = GAUSSIANS
    model["num_virtual_views"] = VIEWS
    model["rasterize"].update(tile_h=8, tile_w=16, chunk=32,
                              tile_capacity=64 if not model["rasterize"]["packed"] else 1024)
    config["config"]["data"]["eval_every"] = 0
    s = config["assumed"]["scene"]
    s.update(gaussians=GAUSSIANS, size=SIZE, views=VIEWS, frames=FRAMES, scale_range=[0.02, 0.08],
             gt_tile_capacity=1024)
    traffic = dict(cell.traffic)
    if traffic["kind"] == "train":
        traffic.update(trace_steps=2, setup_rounds=1)
    else:
        traffic.update(warmup_per_mode=1, sample=3, trace_requests=3)
    return cell._replace(config=config, traffic=traffic,
                         limits=dict(cell.limits if limits is None else limits))
