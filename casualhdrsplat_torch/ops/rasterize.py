"""Gaussian rasterization.  Counterpart of
casualhdrsplat_tpu/ops/rasterize.py.  The projection
(ops/projection_fused.py, kernel P1 on the card) makes the payload rows;
`rasterize_projected` bins and composites them, on one of two paths
chosen by the config:

packed (`cfg.packed`, the default):
    projection -> (tile, depth) binning -> budget waterfill -> one row
    gather into the depth-sorted payload stream (ops/stream_gather.py,
    whose transpose is kernel G1) -> streaming compositor
    (ops/rasterize_packed.py) -> tile reassembly
  With `shared_binning` and more than one view, one sort at the views'
  mean position serves every view (`_rasterize_packed_shared`); otherwise
  every view is binned on its own (`_rasterize_packed`).

dense (`cfg.packed = False`):
    projection -> per-view binning into a [tiles, capacity] id table ->
    per-tile compositor reading the payload rows through the id table
    (ops/composite.composite_tile_lists) -> tile reassembly
  With `backend="xla"` the payload is gathered into a [tiles, capacity,
  16] table for the plain compositor (ops/composite.composite_tiles), as
  the reference does.
  Binning is always per view here; a tile keeps its nearest `tile_capacity`
  entries and the overflow is counted in `aux.num_dropped`.

Either way all views of a frame share one compositor launch (views stack
along the output rows).  The device marks project (after the payload
rows), bin (after binning and the gather, or the tile lists) and composite
(after the tile reassembly) bracket the stages (utils/profiling.py).

`cfg.backend`: "auto" and "pallas" (the reference's name for its kernels)
both select the hand-written CUDA kernels of the chosen path, or their
plain versions when the tensors lie on the CPU.  "xla" asks, whatever
`packed` says, for the dense path through the plain compositor without the
kernels' chunk schedule, on whatever device the tensors are: the
reference's XLA compositor.  The reference's "auto" picks that one on a
CPU; the port's never does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from casualhdrsplat_torch.config import RasterizeConfig
from casualhdrsplat_torch.ops import binning, projection_fused, rasterize_packed, stream_gather
from casualhdrsplat_torch.ops.composite import (
    CompositeStatics,
    composite_tile_lists,
    composite_tiles,
)
from casualhdrsplat_torch.ops.projection import Projected
from casualhdrsplat_torch.utils import profiling


class RasterizeAux(NamedTuple):
    radii: torch.Tensor  # [V, N] screen radii (0 = culled)
    depths: torch.Tensor  # [V, N]
    # dropped contributions: num_dropped by the stream budget (waterfilled
    # far tails; on the dense path by the tile capacity), num_clipped by the
    # mtpg centre-clamp (bbox cells).  The per-view paths sum over views; the
    # shared path counts its one stream.
    num_dropped: torch.Tensor
    num_clipped: torch.Tensor


def rasterize(
    means3d: torch.Tensor,  # [N,3]
    quats: torch.Tensor,  # [N,4]
    scales: torch.Tensor,  # [N,3] activated
    opacities: torch.Tensor,  # [N] activated
    colors: torch.Tensor,  # [N,3] or per-view [V,N,3] linear HDR radiance
    viewmats: torch.Tensor,  # [V,4,4] world->cam
    fx,
    fy,
    cx,
    cy,
    width: int,
    height: int,
    cfg: RasterizeConfig,
    background: Optional[torch.Tensor] = None,  # [3]
    means2d_offset: Optional[torch.Tensor] = None,  # [N,2]
):
    """Render V views of the same Gaussian set.

    Returns (images [V,H,W,3], alphas [V,H,W], aux).
    """
    _check_backend(cfg)
    if viewmats.dim() == 2:
        viewmats = viewmats[None]
    payload, projs = projection_fused.project_payload(
        means3d, quats, scales, opacities, colors, viewmats, fx, fy, cx, cy, width, height,
        near_plane=cfg.near_plane, antialias=cfg.antialias, means2d_offset=means2d_offset,
    )  # payload [V, N+1, 16], every leaf of projs [V, N, ...]
    return rasterize_projected(projs, payload, width, height, cfg, background)


def rasterize_projected(projs: Projected, payload: torch.Tensor, width: int, height: int,
                        cfg: RasterizeConfig, background: Optional[torch.Tensor] = None):
    """Bin and composite V views of projected Gaussians: `payload` [V, N+1,
    16] and `projs` as ops/projection_fused.py (or models/gaussians.py
    `project`) returns them.  Returns (images [V,H,W,3], alphas [V,H,W],
    aux)."""
    _check_backend(cfg)
    profiling.mark("project", payload)
    if not cfg.packed or cfg.backend == "xla":
        out = _rasterize_dense(projs, payload, width, height, cfg, background)
    elif cfg.shared_binning and projs.depths.shape[0] > 1:
        out = _rasterize_packed_shared(projs, payload, width, height, cfg, background)
    else:
        out = _rasterize_packed(projs, payload, width, height, cfg, background)
    profiling.mark("composite", out[0])
    return out


def _check_backend(cfg: RasterizeConfig):
    if cfg.backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown rasterizer backend {cfg.backend!r}")


def _statics(v: int, width: int, height: int, cfg: RasterizeConfig) -> CompositeStatics:
    ntx, nty = binning.tile_grid(width, height, cfg.tile_h, cfg.tile_w)
    return CompositeStatics(
        num_views=v, ntx=ntx, nty=nty, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
        chunk=cfg.chunk, alpha_clip=cfg.alpha_clip,
        alpha_threshold=cfg.alpha_threshold,
        transmittance_eps=cfg.transmittance_eps,
        backend="xla" if cfg.backend == "xla" else "pallas",
    )


def _rasterize_dense(projs, payload, width, height, cfg: RasterizeConfig, background):
    """Dense path: every view gets its own [tiles, capacity] id table; the
    tables stack along the tile axis, so one compositor launch serves all
    views.  The kernels read the payload rows through the ids; the plain
    compositor of backend "xla" takes them gathered."""
    v = projs.depths.shape[0]
    lists = [
        binning.assign_tiles_arrays(
            projs.means2d[k], projs.radii[k], projs.depths[k], projs.valid[k],
            width, height, cfg.tile_h, cfg.tile_w, cfg.tile_capacity,
            cfg.max_tiles_per_gaussian,
        )
        for k in range(v)
    ]
    tiles = binning.TileLists(
        indices=torch.stack([t.indices for t in lists]),  # [V, T, capacity]
        counts=torch.stack([t.counts for t in lists]),
        num_dropped=sum(t.num_dropped for t in lists),
        num_clipped=sum(t.num_clipped for t in lists),
    )
    statics = _statics(v, width, height, cfg)
    tt = v * statics.ntx * statics.nty
    counts = tiles.counts.reshape(tt)
    if statics.backend == "xla":
        gathered = binning.gather_payload(payload, tiles)  # [V, T, capacity, 16]
        profiling.mark("bin", gathered)
        out4 = composite_tiles(gathered.reshape(tt, cfg.tile_capacity, binning.PAYLOAD_DIM),
                               statics, counts=counts)
    else:
        profiling.mark("bin", counts)
        out4 = composite_tile_lists(payload.reshape(-1, binning.PAYLOAD_DIM),
                                    tiles.indices.reshape(tt, cfg.tile_capacity), statics,
                                    counts=counts)  # [tt, 4, P]
    images, alphas = _assemble_tiles(out4, tt, statics, height, width, background)
    aux = RasterizeAux(radii=projs.radii, depths=projs.depths,
                       num_dropped=tiles.num_dropped, num_clipped=tiles.num_clipped)
    return images, alphas, aux


def _stream_budget(n: int, cfg: RasterizeConfig) -> int:
    """Static per-view stream budget, rounded to whole chunks."""
    s_budget = min(n * cfg.max_tiles_per_gaussian, cfg.stream_factor * n)
    return -(-s_budget // cfg.chunk) * cfg.chunk


def _rasterize_packed(projs, payload, width, height, cfg: RasterizeConfig, background):
    """Per-view binning: every view gets its own (tile, depth) sort,
    waterfilled to the stream budget (far tails dropped)."""
    v, n = projs.depths.shape
    s_budget = _stream_budget(n, cfg)
    ids, segs, starts_cs, dropped, clipped = [], [], [], 0, 0
    for k in range(v):
        s_gauss, starts, seg_len, clip_k = binning.sorted_stream(
            projs.means2d[k], projs.radii[k], projs.depths[k], projs.valid[k],
            width, height, cfg.tile_h, cfg.tile_w, cfg.max_tiles_per_gaussian,
        )
        seg_c, starts_c = binning.waterfill_segments(seg_len, s_budget)
        ids.append(binning.compact_stream_ids(s_gauss, starts, starts_c, s_budget, n))
        segs.append(seg_c)
        starts_cs.append(starts_c)
        dropped = dropped + seg_len.sum() - seg_c.sum()
        clipped = clipped + clip_k
    # the one row gather: payload rows in compacted stream order, every
    # view's by its own ids (transpose: kernel G1).  Each view's unused
    # budget tail is one run of the pad id N, which G1 does not walk.
    streams = stream_gather.gather_stream(payload, torch.stack(ids))
    segs, starts_cs = torch.stack(segs), torch.stack(starts_cs)
    profiling.mark("bin", streams)
    images, alphas = _composite(streams, segs, starts_cs, width, height, cfg, background)
    aux = RasterizeAux(radii=projs.radii, depths=projs.depths,
                       num_dropped=dropped, num_clipped=clipped)
    return images, alphas, aux


def _rasterize_packed_shared(projs, payload, width, height, cfg: RasterizeConfig,
                             background):
    """Shared binning: one (tile, depth) sort at each Gaussian's mean
    position over the views, with radii inflated by the Chebyshev distance
    to every view's position, so the shared bbox covers every view's
    3-sigma footprint.  Alpha still evaluates each view's own payload; only
    the within-tile depth order is shared."""
    v, n = projs.depths.shape
    s_budget = _stream_budget(n, cfg)
    validf = projs.valid.to(torch.float32)  # [V,N]
    denom = torch.clamp(validf.sum(0), min=1.0)
    ref_m2d = (projs.means2d * validf[..., None]).sum(0) / denom[:, None]
    ref_depth = (projs.depths * validf).sum(0) / denom
    cheb = torch.abs(projs.means2d - ref_m2d[None]).amax(-1)  # [V,N]
    r_shared = torch.where(projs.valid, cheb + projs.radii, 0.0).amax(0)
    valid_any = projs.valid.any(0)

    s_gauss, starts, seg_len, clipped = binning.sorted_stream(
        ref_m2d, r_shared, ref_depth, valid_any,
        width, height, cfg.tile_h, cfg.tile_w, cfg.max_tiles_per_gaussian,
    )
    seg_c, starts_c = binning.waterfill_segments(seg_len, s_budget)
    stream_ids = binning.compact_stream_ids(s_gauss, starts, starts_c, s_budget, n)
    streams = stream_gather.gather_stream(payload, stream_ids)
    profiling.mark("bin", streams)
    images, alphas = _composite(streams, seg_c.expand(v, -1), starts_c.expand(v, -1), width,
                                height, cfg, background)
    aux = RasterizeAux(radii=projs.radii, depths=projs.depths,
                       num_dropped=seg_len.sum() - seg_c.sum(), num_clipped=clipped)
    return images, alphas, aux


def _composite(streams, seg_c, starts_c, width, height, cfg: RasterizeConfig,
               background):
    """Per-view streams [V, S, 16] with compacted segments [V, T] / starts
    [V, T+1] -> one compositor launch over all views' tiles."""
    v, s_budget, _ = streams.shape
    # row k * T + t owns [k * S + starts_c[k, t], + seg_c[k, t])
    view_off = (torch.arange(v, device=streams.device) * s_budget)[:, None]
    row_lo = (starts_c[:, :-1] + view_off).to(torch.int32).reshape(-1)
    row_hi = row_lo + seg_c.reshape(-1)
    statics = _statics(v, width, height, cfg)
    out4 = rasterize_packed.composite_stream(
        streams.reshape(v * s_budget, binning.PAYLOAD_DIM), row_lo, row_hi, statics
    )
    return _assemble_tiles(out4, v * statics.ntx * statics.nty, statics, height, width,
                           background)


def _assemble_tiles(out4, num_rows, statics: CompositeStatics, height, width, background):
    """[rows, 4, P] tile composites -> ([V,H,W,3] images, [V,H,W] alphas)."""
    v, ntx, nty = statics.num_views, statics.ntx, statics.nty
    th, tw = statics.tile_h, statics.tile_w
    out4 = out4[:num_rows].reshape(v, nty, ntx, 4, th, tw)
    out4 = out4.permute(0, 3, 1, 4, 2, 5).reshape(v, 4, nty * th, ntx * tw)
    out4 = out4[:, :, :height, :width]
    images = out4[:, :3].permute(0, 2, 3, 1)  # [V,H,W,3]
    alphas = torch.clamp(out4[:, 3], 0.0, 1.0)  # [V,H,W]
    if background is not None:
        images = images + (1.0 - alphas)[..., None] * background
    return images, alphas
