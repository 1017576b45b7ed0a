"""Sharded rendering over the (data, gauss) mesh.  Counterpart of
casualhdrsplat_tpu/parallel/render.py (its shard_map rasterizer).

Gaussians are the moving keys, pixel tiles the stationary queries.  On
every rank (d, g), in one SPMD program:

1. project Gaussian block g for the views of data row d;
2. all-gather the 16-float payload rows (and the radius, depth and
   validity columns) along `gauss`, into the one-device order;
3. the `gauss` axis then splits the tiles: the packed branch bins each
   view once (views round-robin over `gauss`, the starts and ids
   all-gathered), gathers every view's stream (ops/stream_gather.py,
   backward kernel G1) and composites the rank's tile slice of every view
   with kernel B1 (backward B2); the dense branch (`packed=False`) bins every
   view and composites the rank's tiles of the id tables with kernel B3
   (backward B4), reading the payload rows through the ids;
4. all-gather every rank's tiles into the full images.

CRF x exposure, the blur mean and the loss then run replicated on every
rank.  The backward runs through each collective's hand-written rule
(parallel/collectives.py).  A rank that held nothing to do for a step
(no view left to bin, no tile in the image) still takes part in every
collective: the ranks must call them in the same order or they wait for
each other forever.
"""

from __future__ import annotations

from typing import Optional

import torch

from casualhdrsplat_torch.config import ModelConfig, RasterizeConfig
from casualhdrsplat_torch.geometry import lie
from casualhdrsplat_torch.models import crf as crf_mod
from casualhdrsplat_torch.models import gaussians as gauss_mod
from casualhdrsplat_torch.models import image_formation as imf
from casualhdrsplat_torch.ops import binning, rasterize_packed, stream_gather
from casualhdrsplat_torch.ops import rasterize as rast
from casualhdrsplat_torch.ops.composite import composite_tile_lists
from casualhdrsplat_torch.ops.projection import cull_invisible, project_gaussians
from casualhdrsplat_torch.parallel import collectives
from casualhdrsplat_torch.parallel.mesh import DATA_AXIS, GAUSS_AXIS, WORLD_AXIS, Mesh

_I32 = torch.int32


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _packed_local_tiles(payload, aux, mesh: Mesh, cfg: RasterizeConfig, width, height,
                        tpd, num_tiles, real_view):
    """The packed branch's tile stage: (out4 [v_local, tpd, 4, P] this
    rank's tiles of every local view, this rank's share of the dropped
    count).

    Binning runs once per view: view j of the data row is binned by gauss
    rank j % gauss and the results all-gathered.  It bins per view
    whatever `shared_binning` says (the reference's
    `compact_stream_ids(..., unconditional=True)`), so its yardstick is the
    one-device per-view branch.  Each view's stream is the one-device
    stream; the rank composites the rows of its tiles, row v * T + t as on
    one device (the kernels take the tile's origin from the row), the
    others left empty."""
    v_local, n_full, _ = payload.shape
    dev = payload.device
    n_gauss, g = mesh.size(GAUSS_AXIS), mesh.axis_index(GAUSS_AXIS)
    s_budget = rast._stream_budget(n_full, cfg)
    n_bin = -(-v_local // n_gauss)

    starts_b = torch.zeros((n_bin, num_tiles + 1), dtype=_I32, device=dev)
    ids_b = torch.full((n_bin, s_budget), n_full, dtype=_I32, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(n_bin):
        v = g + k * n_gauss
        if v >= v_local:
            continue  # the slot stays empty; the collective still runs
        s_gauss, starts, seg_len, clipped = binning.sorted_stream(
            payload[v, :, binning.COL_MX:binning.COL_MY + 1].detach(), aux[v, :, 0],
            aux[v, :, 1], aux[v, :, 2] > 0.5, width, height, cfg.tile_h, cfg.tile_w,
            cfg.max_tiles_per_gaussian,
        )
        # budget overflow drops each overloaded tile's far tail, as on one device
        seg_c, starts_c = binning.waterfill_segments(seg_len, s_budget)
        starts_b[k] = starts_c
        ids_b[k] = binning.compact_stream_ids(s_gauss, starts, starts_c, s_budget, n_full)
        if real_view[v]:  # the view pad's copies re-bin a real view: not counted
            dropped = dropped + (seg_len.sum() - seg_c.sum() + clipped)
    starts_all = collectives.all_gather(starts_b, mesh, GAUSS_AXIS, "bin_starts")
    ids_all = collectives.all_gather(ids_b, mesh, GAUSS_AXIS, "bin_ids")

    lo_t, hi_t = g * tpd, min((g + 1) * tpd, num_tiles)  # this rank's real tiles
    pad_row = torch.zeros((v_local, 1, binning.PAYLOAD_DIM), dtype=payload.dtype, device=dev)
    starts = [starts_all[v % n_gauss][v // n_gauss] for v in range(v_local)]
    ids = torch.stack([ids_all[v % n_gauss][v // n_gauss] for v in range(v_local)])
    # the one row gather, every view by its own ids (transpose: kernel G1).
    # B2 and its plain version write zeros to the rows of other ranks'
    # tiles, so the reference's clip_cotangent_rows has nothing to do here
    streams = stream_gather.gather_stream(torch.cat([payload, pad_row], dim=1), ids)
    # row v T + t owns [v S + starts[v, t], v S + starts[v, t + 1]) where
    # t is one of this rank's tiles, and nothing elsewhere
    starts = torch.stack(starts) + (torch.arange(v_local, device=dev) * s_budget)[:, None]
    mine = torch.zeros(num_tiles, dtype=torch.bool, device=dev)
    mine[lo_t:hi_t].fill_(True)  # a fill on the device: no copy of a Python bool
    lo = torch.where(mine, starts[:, :-1], 0).to(_I32).reshape(-1)
    hi = torch.where(mine, starts[:, 1:], 0).to(_I32).reshape(-1)
    statics = rast._statics(v_local, width, height, cfg)
    out = rasterize_packed.composite_stream(streams.reshape(-1, binning.PAYLOAD_DIM), lo, hi,
                                            statics)
    p = cfg.tile_h * cfg.tile_w
    out4 = out[:-1].reshape(v_local, num_tiles, 4, p)[:, lo_t:hi_t]
    if hi_t - lo_t < tpd:  # the padded tiles past the image: empty
        out4 = torch.cat([out4, out4.new_zeros((v_local, tpd - max(hi_t - lo_t, 0), 4, p))],
                         dim=1)
    return out4, dropped


def _dense_local_tiles(payload, aux, mesh: Mesh, cfg: RasterizeConfig, width, height,
                       tpd, tiles_pad, num_tiles, real_view):
    """The dense branch's tile stage: every rank bins every local view (as
    the reference does) and composites its slice of the tiles through the
    list form (ops/composite.composite_tile_lists), never a gathered table.

    The reference composites its slice of a gathered table with
    tile_indices (g tpd + i) % num_tiles and one view; the list form takes
    a tile's view from tile_indices // tiles_per_view, so local tile i of
    view v passes v tiles_pad + g tpd + i with tiles_per_view = tiles_pad,
    and the padded tiles past the image get the count 0."""
    v_local, n_full, _ = payload.shape
    dev = payload.device
    g = mesh.axis_index(GAUSS_AXIS)
    cap = cfg.tile_capacity
    ids, counts, dropped = [], [], torch.zeros((), dtype=torch.int64, device=dev)
    for v in range(v_local):
        tiles = binning.assign_tiles_arrays(
            payload[v, :, binning.COL_MX:binning.COL_MY + 1].detach(), aux[v, :, 0],
            aux[v, :, 1], aux[v, :, 2] > 0.5, width, height, cfg.tile_h, cfg.tile_w, cap,
            cfg.max_tiles_per_gaussian,
        )
        ids.append(tiles.indices)
        counts.append(tiles.counts)
        # every gauss rank binned the same views: rank 0 of the row counts them
        if real_view[v] and g == 0:
            dropped = dropped + tiles.num_dropped
    pad_t = tiles_pad - num_tiles
    ids = torch.stack(ids)  # [v_local, T, cap]
    counts = torch.stack(counts)
    if pad_t:
        ids = torch.cat([ids, ids.new_full((v_local, pad_t, cap), n_full)], dim=1)
        counts = torch.cat([counts, counts.new_zeros((v_local, pad_t))], dim=1)
    local = slice(g * tpd, (g + 1) * tpd)
    ids_l = ids[:, local].reshape(v_local * tpd, cap)
    counts_l = counts[:, local].reshape(v_local * tpd)
    tile_indices = ((torch.arange(v_local, dtype=_I32, device=dev) * tiles_pad)[:, None]
                    + g * tpd + torch.arange(tpd, dtype=_I32, device=dev)[None, :]).reshape(-1)
    statics = rast._statics(v_local, width, height, cfg)._replace(tiles_per_view=tiles_pad)
    pad_row = torch.zeros((v_local, 1, binning.PAYLOAD_DIM), dtype=payload.dtype, device=dev)
    rows = torch.cat([payload, pad_row], dim=1).reshape(-1, binning.PAYLOAD_DIM)
    out4 = composite_tile_lists(rows, ids_l, statics, tile_indices=tile_indices,
                                counts=counts_l)
    return out4.reshape(v_local, tpd, 4, cfg.tile_h * cfg.tile_w), dropped


def rasterize_sharded(
    gauss_params,  # this rank's block of the store: dict of [N / gauss, ...]
    viewmats: torch.Tensor,  # [V, 4, 4], the same on every rank
    fx, fy, cx, cy,
    width: int,
    height: int,
    cfg: RasterizeConfig,
    mesh: Mesh,
    sh_degree: int,
    means2d_offset: Optional[torch.Tensor] = None,  # [N / gauss, 2] this rank's block
):
    """Render V views of the store spread over the mesh.  Returns, the same
    on every rank, (hdr [V, H, W, 3], alphas [V, H, W], radii [V, N],
    depths [V, N], dropped): the full images, the projection of the whole
    store, and the contributions dropped by the stream budget or the tile
    capacity (with the packed branch's bbox clamp), counted once per real
    view.  Differentiable in the block, `viewmats` and `means2d_offset`."""
    th, tw = cfg.tile_h, cfg.tile_w
    ntx, nty = binning.tile_grid(width, height, th, tw)
    num_tiles = ntx * nty
    n_data, n_gauss = mesh.size(DATA_AXIS), mesh.size(GAUSS_AXIS)
    d = mesh.axis_index(DATA_AXIS)
    num_views = viewmats.shape[0]
    v_pad = _round_up(num_views, n_data)
    if v_pad > num_views:
        # pad the views to the data axis (the copies are dropped after
        # assembly), so that any mesh takes any view count
        viewmats = torch.cat([viewmats, viewmats[-1:].expand(v_pad - num_views, 4, 4)])
    v_local = v_pad // n_data
    tiles_pad = _round_up(num_tiles, n_gauss)
    tpd = tiles_pad // n_gauss
    if means2d_offset is None:
        means2d_offset = torch.zeros((gauss_params["means"].shape[0], 2),
                                     device=viewmats.device)

    # Inputs replicated into the body, each rank adding a partial of their
    # gradient: the view matrices over the world (every rank projects its
    # block for its views), the block and the screen-gradient probe over
    # `data` (every data row renders its own views of the block).
    viewmats = collectives.sum_grad(viewmats, mesh, WORLD_AXIS, "viewmats.grad")
    gp = {k: collectives.sum_grad(v, mesh, DATA_AXIS, "store.grad")
          if v.is_floating_point() else v for k, v in gauss_params.items()}
    offset = collectives.sum_grad(means2d_offset, mesh, DATA_AXIS, "offset.grad")

    vms = viewmats[d * v_local:(d + 1) * v_local]
    real_view = [d * v_local + j < num_views for j in range(v_local)]
    act = gauss_mod.activate(gp)
    colors = gauss_mod.colors_for_view(act, lie.se3_inverse(vms), sh_degree)
    proj = project_gaussians(
        act.means3d, act.quats, act.scales, vms, fx, fy, cx, cy, width, height,
        near_plane=cfg.near_plane, antialias=cfg.antialias,
    )
    proj = cull_invisible(proj._replace(means2d=proj.means2d + offset), act.opacities)
    opa = torch.where(proj.valid, act.opacities * proj.compensation, 0.0)
    payload_l = binning.build_payload_rows(proj.means2d, proj.conics, opa, colors)
    aux_l = torch.stack([proj.radii, proj.depths, proj.valid.float()], -1).detach()

    # the pivot: gather the payload rows along gauss, then split the tiles.
    # The blocks land at [g B, (g + 1) B): the one-device order, so the
    # binning sorts break their ties as on one device.
    payload = collectives.gather_blocks(payload_l, mesh, GAUSS_AXIS, 1, "payload")
    aux = torch.cat(collectives.all_gather(aux_l, mesh, GAUSS_AXIS, "aux"), dim=1)
    if cfg.packed and cfg.backend != "xla":
        out4, dropped = _packed_local_tiles(payload, aux, mesh, cfg, width, height, tpd,
                                            num_tiles, real_view)
    else:
        out4, dropped = _dense_local_tiles(payload, aux, mesh, cfg, width, height, tpd,
                                           tiles_pad, num_tiles, real_view)

    # assembly: every rank's tiles into the full images, the same on every rank
    full = collectives.assemble(out4, mesh, "images")  # [world, v_local, tpd, 4, P]
    full = full.reshape(n_data, n_gauss, v_local, tpd, 4, th * tw).permute(0, 2, 1, 3, 4, 5)
    full = full.reshape(v_pad, tiles_pad, 4, th * tw)[:num_views, :num_tiles]
    statics = rast._statics(num_views, width, height, cfg)
    hdr, alphas = rast._assemble_tiles(full.reshape(num_views * num_tiles, 4, th * tw),
                                       num_views * num_tiles, statics, height, width, None)
    rd = torch.stack([proj.radii, proj.depths]).detach()  # [2, v_local, N / gauss]
    rd = torch.stack(collectives.all_gather(rd, mesh, WORLD_AXIS, "radii_depths"))
    rd = rd.reshape(n_data, n_gauss, 2, v_local, -1).permute(2, 0, 3, 1, 4)
    rd = rd.reshape(2, v_pad, -1)[:, :num_views]
    dropped = collectives.all_reduce(dropped.reshape(1), mesh, WORLD_AXIS, "dropped")[0]
    return hdr, alphas, rd[0], rd[1], dropped


def render_frame_sharded(
    params,
    scene: imf.SceneStatic,
    frame_id,
    cfg: ModelConfig,
    mesh: Mesh,
    sh_degree: Optional[int] = None,
    means2d_offset: Optional[torch.Tensor] = None,
) -> imf.FrameRender:
    """The sharded twin of models.image_formation.render_frame: the same
    math, rasterized over the mesh, with `params["gaussians"]` this rank's
    block.  Returns the same FrameRender on every rank; `aux.num_dropped`
    is the one combined counter and `aux.num_clipped` 0, as in the
    reference."""
    n = cfg.num_virtual_views
    deg = cfg.sh_degree if sh_degree is None else sh_degree
    dt = imf.exposure_of(params, frame_id)
    viewmats = imf._virtual_viewmats(params, scene, frame_id, cfg, n)
    hdr, alphas, radii, depths, dropped = rasterize_sharded(
        params["gaussians"], viewmats, scene.fx, scene.fy, scene.cx, scene.cy,
        scene.width, scene.height, cfg.rasterize, mesh, deg, means2d_offset=means2d_offset,
    )
    if cfg.white_background:
        hdr = hdr + (1.0 - alphas)[..., None]
    ldr = crf_mod.apply(params["crf"], hdr * dt, cfg.crf)
    aux = rast.RasterizeAux(radii=radii, depths=depths, num_dropped=dropped,
                            num_clipped=torch.zeros((), dtype=torch.int64, device=hdr.device))
    return imf.FrameRender(blurred_ldr=ldr.mean(0), sharp_ldr=ldr, sharp_hdr=hdr,
                           alphas=alphas, aux=aux)
