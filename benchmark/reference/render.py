"""The plain reference of the renderer: projection, spherical harmonics,
tile binning with its stream budget or tile capacity, the compositor, the
monotone CRF and the blurred frame.

Plain float32 PyTorch, written from the method's equations and from the
semantics of the system under test that change a result:
- binning: every Gaussian covers the tiles of its 3-sigma box (radius
  ceil(3 sqrt(lambda_max))), centre-clamped to at most
  `max_tiles_per_gaussian` tiles; a tile's entries are in depth order, ties
  by index;
- packed path: one stream of at most stream_factor * N slots per view (a
  multiple of the chunk); an overfull stream keeps in every tile its
  nearest `cap` entries, cap the largest level that fits ("waterfill");
  with shared binning one sort, at each Gaussian's mean position over the
  views with its radius grown by its largest move, serves every view;
- dense path: a tile keeps its nearest `tile_capacity` entries;
- compositing: alpha = min(opa exp(-q), alpha_clip), 0 below
  alpha_threshold; front to back in windows of `chunk` slots (for the
  packed path aligned to multiples of the chunk in the stream, for the
  dense path in the tile's list); a tile stops before the first window at
  which no pixel's transmittance is >= transmittance_eps.
The compositor's gradient is autograd's, through the same windows,
recomputed per batch of rows (torch.utils.checkpoint) so that it fits.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference import geometry as geo

BLUR_2D = 0.3
COLS = 10  # payload: mx, my, conic xx, xy, yy, opacity, r, g, b, 1
_SH_C0 = 0.28209479177387814
_SH_C1 = 0.4886025119029199
_SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792,
          0.5462742152960396)
_SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
          -0.4570457994644658, 1.445305721320277, -0.5900435899266435)
# (window, pixel) elements of one batch of compositor rows: 1024 windows
# of 128 slots over 2048 pixels, about 12 GiB of autograd's intermediates
BATCH_ELEMENTS = 1024 * 128 * 2048


class Raster(NamedTuple):
    """The rasterizer settings a configuration states."""

    packed: bool
    tile_h: int
    tile_w: int
    tile_capacity: int
    max_tiles_per_gaussian: int
    chunk: int
    stream_factor: int
    shared_binning: bool
    near_plane: float
    alpha_clip: float
    alpha_threshold: float
    transmittance_eps: float


def raster_from(cfg: dict) -> Raster:
    return Raster(**{k: cfg[k] for k in Raster._fields})


# -- Gaussians -------------------------------------------------------------


def activate(g: dict):
    """(means, quats, scales, opacities, sh [N, 16, 3]) of a store."""
    return (g["means"], g["quats"], torch.exp(g["log_scales"]),
            torch.sigmoid(g["opacity_logit"]) * g["alive"],
            torch.cat([g["sh_dc"], g["sh_rest"]], 1))


def eval_sh(degree: int, coeffs, dirs):
    """Real SH radiance + 0.5, clamped at 0: coeffs [..., K, 3], dirs [..., 3]."""
    d = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-8)
    x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    c = [coeffs[..., i, :] for i in range(coeffs.shape[-2])]
    out = _SH_C0 * c[0]
    if degree >= 1:
        out = out + _SH_C1 * (-y * c[1] + z * c[2] - x * c[3])
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out = out + (_SH_C2[0] * xy * c[4] + _SH_C2[1] * yz * c[5]
                     + _SH_C2[2] * (2.0 * zz - xx - yy) * c[6] + _SH_C2[3] * xz * c[7]
                     + _SH_C2[4] * (xx - yy) * c[8])
    if degree >= 3:
        out = out + (_SH_C3[0] * y * (3 * xx - yy) * c[9] + _SH_C3[1] * xy * z * c[10]
                     + _SH_C3[2] * y * (4 * zz - xx - yy) * c[11]
                     + _SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * c[12]
                     + _SH_C3[4] * x * (4 * zz - xx - yy) * c[13]
                     + _SH_C3[5] * z * (xx - yy) * c[14] + _SH_C3[6] * x * (xx - 3 * yy) * c[15])
    return torch.clamp(out + 0.5, min=0.0)


def colors(means, sh, camtoworlds, degree: int):
    """[V, N, 3] radiance seen from each camera [V, 4, 4]."""
    d = means - camtoworlds[:, None, :3, 3]
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-8)
    return eval_sh(degree, sh, d)


class Projected(NamedTuple):
    means2d: torch.Tensor  # [V, N, 2]
    depths: torch.Tensor  # [V, N]
    conics: torch.Tensor  # [V, N, 3]
    radii: torch.Tensor  # [V, N] (0 = culled)
    valid: torch.Tensor  # [V, N]


def project(means, quats, scales, opacities, viewmats, cam, near_plane: float) -> Projected:
    """EWA projection of N Gaussians into V views [V, 4, 4]: Sigma2d = J W
    Sigma W^T J^T + 0.3 I with gsplat's tangent-plane clamp; culled behind
    the near plane, off screen, degenerate or at zero opacity."""
    fx, fy, cx, cy, width, height = cam
    fx, fy, cx, cy = (torch.tensor(v, dtype=torch.float32, device=means.device)
                      for v in (fx, fy, cx, cy))
    R = viewmats[:, :3, :3]
    t = (means[None, :, None, :] * R[:, None]).sum(-1) + viewmats[:, None, :3, 3]
    tx, ty, depth = t.unbind(-1)
    in_front = depth > near_plane
    tz = torch.where(in_front, depth, torch.ones_like(depth))
    inv_z = 1.0 / tz
    # gsplat's tangent-plane clamp, in float32
    lim_x = 1.3 * (0.5 * width / fx + torch.abs((cx - 0.5 * width) / fx))
    lim_y = 1.3 * (0.5 * height / fy + torch.abs((cy - 0.5 * height) / fy))
    txz = torch.clamp(tx * inv_z, -lim_x, lim_x) * tz
    tyz = torch.clamp(ty * inv_z, -lim_y, lim_y) * tz
    rot = geo.quat_to_rotmat(quats)
    m = [[rot[:, i, j] * scales[:, j] for j in range(3)] for i in range(3)]
    sig = {(i, j): sum(m[i][k] * m[j][k] for k in range(3)) for i in range(3) for j in range(i, 3)}

    def s(i, j):
        return sig[(min(i, j), max(i, j))]

    def w(i, k):
        return R[:, i, k, None]

    a = [[sum(w(i, k) * s(k, j) for k in range(3)) for j in range(3)] for i in range(3)]

    def c(i, j):
        return sum(a[i][k] * w(j, k) for k in range(3))

    c00, c01, c02, c11, c12, c22 = c(0, 0), c(0, 1), c(0, 2), c(1, 1), c(1, 2), c(2, 2)
    j00, j11 = fx * inv_z, fy * inv_z
    j02, j12 = -fx * txz * inv_z * inv_z, -fy * tyz * inv_z * inv_z
    sxx = j00 * j00 * c00 + 2.0 * j00 * j02 * c02 + j02 * j02 * c22
    sxy = j00 * j11 * c01 + j00 * j12 * c02 + j02 * j11 * c12 + j02 * j12 * c22
    syy = j11 * j11 * c11 + 2.0 * j11 * j12 * c12 + j12 * j12 * c22
    sxx, syy = sxx + BLUR_2D, syy + BLUR_2D
    det = sxx * syy - sxy * sxy
    ok = det > 1e-10
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    conics = torch.stack([syy * inv_det, -sxy * inv_det, sxx * inv_det], -1)
    mid = 0.5 * (sxx + syy)
    radii = torch.ceil(3.0 * torch.sqrt(mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.01))))
    means2d = torch.stack([fx * tx * inv_z + cx, fy * ty * inv_z + cy], -1)
    on_screen = ((means2d[..., 0] + radii > 0) & (means2d[..., 0] - radii < width)
                 & (means2d[..., 1] + radii > 0) & (means2d[..., 1] - radii < height))
    valid = in_front & ok & on_screen & (opacities > 0.0)
    return Projected(means2d, depth, conics,
                     torch.where(valid, radii, torch.zeros_like(radii)), valid)


# -- binning ---------------------------------------------------------------


def tile_grid(width: int, height: int, r: Raster):
    return -(-width // r.tile_w), -(-height // r.tile_h)


def _tile_boxes(means2d, radii, valid, width, height, r: Raster):
    """Per Gaussian the first tile column and row and the box's width and
    height in tiles after the centre clamp, and the tile cells the clamp
    cut: (tx0, ty0, w, h, clipped)."""
    ntx, nty = tile_grid(width, height, r)

    def cell(v, size, hi):
        return torch.clamp(torch.floor(v / size).to(torch.int32), 0, hi - 1)

    mx, my = means2d[:, 0], means2d[:, 1]
    tx0, tx1 = cell(mx - radii, r.tile_w, ntx), cell(mx + radii, r.tile_w, ntx)
    ty0, ty1 = cell(my - radii, r.tile_h, nty), cell(my + radii, r.tile_h, nty)
    w, h = tx1 - tx0 + 1, ty1 - ty0 + 1
    mtpg = r.max_tiles_per_gaussian
    area = w * h
    over = area > mtpg
    # the largest aspect-preserving block of at most mtpg tiles, centred
    sc = torch.sqrt(mtpg / torch.clamp(area, min=1).to(torch.float32))
    hc = torch.minimum(torch.clamp(torch.floor(h * sc).to(torch.int32), min=1), h)
    wc = torch.minimum(torch.clamp(mtpg // hc, min=1), w)
    hc = torch.minimum(torch.clamp(mtpg // wc, min=1), h)
    wf, hf = torch.where(over, wc, w), torch.where(over, hc, h)
    tx0 = torch.where(over, tx0 + (w - wf) // 2, tx0)
    ty0 = torch.where(over, ty0 + (h - hf) // 2, ty0)
    clipped = torch.where(valid, area - wf * hf, 0).sum()
    return tx0, ty0, wf, hf, clipped


def sorted_entries(means2d, radii, depths, valid, width, height, r: Raster):
    """Every (tile, Gaussian) entry in (tile, depth, index) order: (Gaussian
    ids [E], per-tile starts [T + 1], entries clipped by the clamp)."""
    n = means2d.shape[0]
    dev = means2d.device
    ntx, nty = tile_grid(width, height, r)
    tx0, ty0, w, h, clipped = _tile_boxes(means2d, radii, valid, width, height, r)
    cells = (w * h * valid).long()
    gid = torch.repeat_interleave(torch.arange(n, device=dev), cells)
    first = torch.cumsum(cells, 0) - cells
    k = torch.arange(gid.shape[0], device=dev) - first[gid]
    tile = (ty0[gid] + k // w[gid]) * ntx + tx0[gid] + k % w[gid]
    rank = torch.empty(n, dtype=torch.long, device=dev)
    rank[torch.argsort(depths, stable=True)] = torch.arange(n, device=dev)
    order = torch.argsort(tile * n + rank[gid])
    tile = tile[order]
    starts = torch.searchsorted(tile, torch.arange(ntx * nty + 1, device=dev))
    return gid[order], starts, clipped


def waterfill(seg_len, budget: int):
    """The largest level cap with sum(min(seg_len, cap)) <= budget (or no
    cap when all fit): the kept segment lengths."""
    s = torch.sort(seg_len).values
    t = s.shape[0]
    before = torch.cumsum(s, 0) - s
    level = torch.div(budget - before, t - torch.arange(t, device=s.device), rounding_mode="floor")
    short = level < s
    if not bool(short.any()):
        return seg_len
    return torch.minimum(seg_len, level[short.nonzero()[0, 0]])


def stream_budget(n: int, r: Raster) -> int:
    s = min(n * r.max_tiles_per_gaussian, r.stream_factor * n)
    return -(-s // r.chunk) * r.chunk


def packed_stream(ids, starts, n: int, r: Raster):
    """The budgeted stream of one binning: (slot ids [S] with the pad id n
    past the kept entries, row bounds lo, hi [T]) for S = stream_budget."""
    seg = starts[1:] - starts[:-1]
    budget = stream_budget(n, r)
    kept = waterfill(seg, budget)
    lo = torch.cumsum(kept, 0) - kept
    keep_mask = (torch.arange(ids.shape[0], device=ids.device)
                 - torch.repeat_interleave(starts[:-1], seg)) < torch.repeat_interleave(kept, seg)
    slots = torch.full((budget,), n, dtype=torch.long, device=ids.device)
    kept_ids = ids[keep_mask]
    slots[:kept_ids.shape[0]] = kept_ids
    return slots, lo, lo + kept, int(seg.sum() - kept.sum())


def dense_lists(ids, starts, n: int, r: Raster):
    """The [T, capacity] id table of one binning (pad id n), its counts and
    the entries past capacity."""
    seg = starts[1:] - starts[:-1]
    k = torch.arange(r.tile_capacity, device=ids.device)
    src = torch.clamp(starts[:-1, None] + k, max=max(ids.shape[0] - 1, 0))
    table = torch.where(k < seg[:, None], ids[src] if ids.shape[0] else n, n)
    return table, torch.clamp(seg, max=r.tile_capacity), int(torch.clamp(seg - r.tile_capacity,
                                                                         min=0).sum())


# -- compositing -----------------------------------------------------------


def _pixels(rows, tiles_per_view: int, ntx: int, r: Raster):
    """Pixel centres (px, py) [rows, 1, P] of output rows (tiles)."""
    t = rows % tiles_per_view
    ox, oy = (t % ntx) * r.tile_w, (t // ntx) * r.tile_h
    idx = torch.arange(r.tile_h * r.tile_w, device=rows.device)
    px = (idx % r.tile_w + ox[:, None]).to(torch.float32)[:, None] + 0.5
    py = (idx // r.tile_w + oy[:, None]).to(torch.float32)[:, None] + 0.5
    return px, py


def _window(chunk, px, py, t_in, r: Raster):
    """Composite one window chunk [s, G, COLS] over pixels [s, 1, P] from
    transmittance t_in [s, 1, P]: (rgb + alpha [s, 4, P], t_out)."""
    mx, my, cxx, cxy, cyy, opa = (chunk[..., i:i + 1] for i in range(6))
    dx, dy = px - mx, py - my
    power = -(0.5 * (cxx * dx * dx + cyy * dy * dy) + cxy * dx * dy)
    alpha = torch.clamp(opa * torch.exp(torch.clamp(power, max=0.0)), max=r.alpha_clip)
    alpha = torch.where(alpha >= r.alpha_threshold, alpha, 0.0)
    log1m = torch.log1p(-alpha)
    incl = torch.cumsum(log1m, 1)
    weight = alpha * torch.exp(incl - log1m) * t_in
    return torch.matmul(chunk[..., 6:10].transpose(1, 2), weight), t_in * torch.exp(incl[:, -1:])


def _composite_rows(payload, rows, slot_of, windows, tiles_per_view: int, ntx: int, r: Raster):
    """[len(rows), 4, P] for the rows `rows`: window k of a row holds the
    payload rows slot_of(rows, k) -> (index [s, G], in list [s, G])."""
    p = r.tile_h * r.tile_w
    px, py = _pixels(rows, tiles_per_view, ntx, r)
    t = torch.ones((rows.shape[0], 1, p), dtype=torch.float32, device=payload.device)
    acc = torch.zeros((rows.shape[0], 4, p), dtype=torch.float32, device=payload.device)
    count = windows[rows]
    for k in range(int(count.max()) if rows.numel() else 0):
        live = (count > k) & (t.detach().amax(dim=(1, 2)) >= r.transmittance_eps)
        sel = live.nonzero()[:, 0]
        if sel.numel() == 0:
            break
        index, in_list = slot_of(rows[sel], k)
        chunk = payload[index]
        chunk = torch.cat([chunk[..., :5], chunk[..., 5:6] * in_list[..., None],
                           chunk[..., 6:]], -1)
        contrib, t_out = _window(chunk, px[sel], py[sel], t[sel], r)
        acc = acc.index_put((sel,), acc[sel] + contrib)
        t = t.index_put((sel,), t_out)
    return acc


def row_batches(windows, per_window: int):
    """The rows in batches of similar window counts, longest first, each
    batch at most BATCH_ELEMENTS (window, pixel) elements (or one row):
    (batches of row indices, the permutation they concatenate to)."""
    order = torch.argsort(windows, descending=True, stable=True)
    counts = windows[order].tolist()
    budget = max(1, BATCH_ELEMENTS // per_window)
    batches, start, total = [], 0, 0
    for i, c in enumerate(counts):
        if i > start and total + c > budget:
            batches.append(order[start:i])
            start, total = i, 0
        total += c
    if start < len(counts):
        batches.append(order[start:])
    return batches, order


def composite(payload, slot_of, windows, n_rows: int, tiles_per_view: int, ntx: int, r: Raster):
    """Every row's tile composite [n_rows, 4, P], differentiable in
    `payload` [rows, COLS], in batches of rows whose intermediates autograd
    recomputes in the backward."""
    batches, order = row_batches(windows, r.chunk * r.tile_h * r.tile_w)
    outs = []
    for rows in batches:
        if payload.requires_grad:
            outs.append(checkpoint(_composite_rows, payload, rows, slot_of, windows,
                                   tiles_per_view, ntx, r, use_reentrant=False))
        else:
            outs.append(_composite_rows(payload, rows, slot_of, windows, tiles_per_view, ntx, r))
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(n_rows, device=order.device)
    return torch.cat(outs)[inverse]


def stream_slots(slots, lo, hi, chunk: int, views: int, rows_per_view: int, n1: int):
    """The packed path's windows: blocks of `chunk` stream positions aligned
    to multiples of the chunk; view v reads payload rows v (N + 1) + id.
    Returns (slot_of, window counts [views * rows_per_view])."""
    s = slots.shape[-1]
    lo = lo.reshape(-1, rows_per_view)
    hi = hi.reshape(-1, rows_per_view)
    lo = lo.expand(views, -1).reshape(-1)
    hi = hi.expand(views, -1).reshape(-1)
    first = lo // chunk
    windows = torch.where(hi > lo, (hi - 1) // chunk - first + 1, 0)
    slots = slots.reshape(-1, s).expand(views, -1)
    offs = torch.arange(chunk, device=slots.device)

    def slot_of(rows, k):
        pos = (first[rows] + k)[:, None] * chunk + offs
        in_seg = (pos >= lo[rows, None]) & (pos < hi[rows, None])
        view = rows // rows_per_view
        ids = slots[view[:, None], torch.clamp(pos, max=s - 1)]
        return view[:, None] * n1 + ids, in_seg

    return slot_of, windows


def list_slots(table, counts, chunk: int, n1: int, rows_per_view: int):
    """The dense path's windows: chunk k of a tile's list, ceil(count /
    chunk) of them."""
    windows = (counts + chunk - 1) // chunk
    offs = torch.arange(chunk, device=table.device)

    def slot_of(rows, k):
        pos = k * chunk + offs
        ids = table[rows[:, None], pos[None, :]]
        return (rows // rows_per_view)[:, None] * n1 + ids, pos[None] < counts[rows, None]

    return slot_of, windows


class Binned(NamedTuple):
    """The compositor's input for V views: payload rows [V (N + 1), COLS]
    (row N of each view zero), the rows' windows and the binning's counts."""

    payload: torch.Tensor
    slot_of: object  # (rows, k) -> (payload row index [s, G], in list [s, G])
    windows: torch.Tensor  # [V * T] windows of every output row
    views: int
    ntx: int
    nty: int
    radii: torch.Tensor  # [V, N]
    dropped: int
    clipped: int


def bin_views(means, quats, scales, opacities, rgb, viewmats, cam, r: Raster,
              offset=None) -> Binned:
    """Project, build the payload and bin V views [V, 4, 4] of the
    Gaussians with per-view radiance rgb [V, N, 3]."""
    v, n = viewmats.shape[0], means.shape[0]
    width, height = cam[4], cam[5]
    proj = project(means, quats, scales, opacities, viewmats, cam, r.near_plane)
    m2d = proj.means2d if offset is None else proj.means2d + offset
    opa = torch.where(proj.valid, opacities, 0.0)
    rows = torch.cat([m2d, proj.conics, opa[..., None].expand(v, n, 1), rgb,
                      torch.ones((v, n, 1), device=means.device)], -1)
    payload = torch.cat([rows, torch.zeros((v, 1, COLS), device=means.device)], 1)
    payload = payload.reshape(v * (n + 1), COLS)
    ntx, nty = tile_grid(width, height, r)
    tiles = ntx * nty
    m2d, radii, depths = m2d.detach(), proj.radii, proj.depths.detach()
    if r.packed and r.shared_binning and v > 1:
        validf = proj.valid.float()
        denom = torch.clamp(validf.sum(0), min=1.0)
        ref_pos = (m2d * validf[..., None]).sum(0) / denom[:, None]
        depth = (depths * validf).sum(0) / denom
        grow = torch.abs(m2d - ref_pos[None]).amax(-1)
        rad = torch.where(proj.valid, grow + radii, 0.0).amax(0)
        ids, starts, clipped = sorted_entries(ref_pos, rad, depth, proj.valid.any(0), width,
                                              height, r)
        slots, lo, hi, dropped = packed_stream(ids, starts, n, r)
        slot_of, windows = stream_slots(slots, lo, hi, r.chunk, v, tiles, n + 1)
        return Binned(payload, slot_of, windows, v, ntx, nty, radii, dropped, int(clipped))
    binned = [sorted_entries(m2d[k], radii[k], depths[k], proj.valid[k], width, height, r)
              for k in range(v)]
    clipped = sum(int(b[2]) for b in binned)
    if r.packed:
        streams = [packed_stream(ids, starts, n, r) for ids, starts, _ in binned]
        slot_of, windows = stream_slots(torch.stack([s_[0] for s_ in streams]),
                                        torch.cat([s_[1] for s_ in streams]),
                                        torch.cat([s_[2] for s_ in streams]), r.chunk, v, tiles,
                                        n + 1)
        return Binned(payload, slot_of, windows, v, ntx, nty, radii,
                      sum(s_[3] for s_ in streams), clipped)
    lists = [dense_lists(ids, starts, n, r) for ids, starts, _ in binned]
    slot_of, windows = list_slots(torch.cat([l_[0] for l_ in lists]),
                                  torch.cat([l_[1] for l_ in lists]), r.chunk, n + 1, tiles)
    return Binned(payload, slot_of, windows, v, ntx, nty, radii, sum(l_[2] for l_ in lists),
                  clipped)


class RasterOut(NamedTuple):
    hdr: torch.Tensor  # [V, H, W, 3]
    alpha: torch.Tensor  # [V, H, W]
    radii: torch.Tensor  # [V, N]
    dropped: int
    clipped: int


def rasterize(means, quats, scales, opacities, rgb, viewmats, cam, r: Raster, offset=None):
    """V views [V, 4, 4] of the Gaussians with per-view radiance rgb [V, N, 3]."""
    b = bin_views(means, quats, scales, opacities, rgb, viewmats, cam, r, offset)
    v, tiles, width, height = b.views, b.ntx * b.nty, cam[4], cam[5]
    out4 = composite(b.payload, b.slot_of, b.windows, v * tiles, tiles, b.ntx, r)
    out4 = out4.reshape(v, b.nty, b.ntx, 4, r.tile_h, r.tile_w).permute(0, 3, 1, 4, 2, 5)
    out4 = out4.reshape(v, 4, b.nty * r.tile_h, b.ntx * r.tile_w)[:, :, :height, :width]
    return RasterOut(out4[:, :3].permute(0, 2, 3, 1), torch.clamp(out4[:, 3], 0.0, 1.0),
                     b.radii, int(b.dropped), int(b.clipped))


# -- tone mapping ----------------------------------------------------------


class _Clip01(torch.autograd.Function):
    """clip(x, 0, 1) whose gradient is halved where x lies on a bound."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, 0.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        inside = (x > 0.0) & (x < 1.0)
        return g * torch.where(inside, 1.0, torch.where((x == 0.0) | (x == 1.0), 0.5, 0.0))


def _crf_block(x, k, c, w, g, bias, log_min: float, log_max: float):
    e = 0.5 * (x + x.abs())  # max(x, 0), half the gradient at 0
    u = ((torch.log(e + 1e-8) - log_min) / (log_max - log_min)).T[:, :, None]  # [3, B, 1]
    y = (w[:, None, :] * torch.sigmoid(k[:, None, :] * (u - c[:, None, :]))).sum(-1)
    y = y + g[:, None] * u[..., 0] + bias[:, None]
    return _Clip01.apply(torch.sigmoid(y) * 1.004 - 0.002).T


def crf(params: dict, x, crf_cfg: dict, block: int = 1 << 19):
    """The monotone mixture-of-sigmoids CRF of exposed radiance x [..., 3]:
    per channel sigmoid(sum_j w_j sigmoid(k_j (u - c_j)) + g u + b) * 1.004
    - 0.002, clipped to [0, 1], u the normalised log exposure; k = 20
    softplus(unit_k), w = softplus(unit_w), g = softplus(gain)."""
    sp = torch.nn.functional.softplus
    args = (sp(params["unit_k"]) * 20.0, params["unit_c"], sp(params["unit_w"]),
            sp(params["gain"]), params["bias"], crf_cfg["log_min"], crf_cfg["log_max"])
    flat = x.reshape(-1, 3)
    outs = []
    for s in range(0, flat.shape[0], block):
        part = flat[s:s + block]
        if torch.is_grad_enabled():
            outs.append(checkpoint(_crf_block, part, *args, use_reentrant=False))
        else:
            outs.append(_crf_block(part, *args))
    return torch.cat(outs).reshape(x.shape)


def response_curve(params: dict, crf_cfg: dict, num: int):
    e = torch.exp(torch.linspace(crf_cfg["log_min"], crf_cfg["log_max"], num,
                                 device=params["unit_k"].device))
    return crf(params, e[:, None].repeat(1, 3), crf_cfg)


# -- image formation -------------------------------------------------------


class Scene(NamedTuple):
    """What the render takes besides the parameters."""

    base_knots: torch.Tensor  # [M, 4, 4]
    knot_t0: torch.Tensor
    knot_dt: torch.Tensor
    timestamps: torch.Tensor  # [F]
    cam: tuple  # fx, fy, cx, cy (Python floats), width, height


def make_scene(viewmats, timestamps, cam) -> Scene:
    """Spline knots at the frames' poses, the end poses repeated twice,
    on a knot clock scaled to the timestamps."""
    poses = torch.as_tensor(viewmats, dtype=torch.float32)
    knots = torch.cat([poses[:1].repeat(2, 1, 1), poses, poses[-1:].repeat(2, 1, 1)])
    ts = torch.as_tensor(timestamps, dtype=torch.float32, device=poses.device)
    n = ts.shape[0]
    step = (ts[-1] - ts[0]) / max(n - 1, 1)
    return Scene(knots, ts[0] + (-2.0) * step, step * 1.0, ts, cam)


def frame_viewmats(params, scene: Scene, frame: int, views: int):
    """The virtual views' poses [V, 4, 4] over the frame's exposure."""
    knots = torch.matmul(geo.se3_exp(params["knot_deltas"]), scene.base_knots)
    dt = torch.exp(params["log_exposures"][frame])
    times = geo.virtual_times(scene.timestamps[frame], dt, views)
    return geo.cubic_spline(knots, scene.knot_t0, scene.knot_dt, times), dt


def render_frame(params, scene: Scene, frame: int, model: dict, sh_degree: int, offset=None):
    """(blurred LDR frame [H, W, 3], RasterOut) of training frame `frame`."""
    viewmats, dt = frame_viewmats(params, scene, frame, model["num_virtual_views"])
    means, quats, scales, opac, sh = activate(params["gaussians"])
    rgb = colors(means, sh, geo.se3_inverse(viewmats), sh_degree)
    out = rasterize(means, quats, scales, opac, rgb, viewmats, scene.cam,
                    raster_from(model["rasterize"]), offset)
    ldr = crf(params["crf"], out.hdr * dt, model["crf"])
    return ldr[:model.get("blur_views")].mean(0), out


def render_pose(params, scene: Scene, viewmat, model: dict, exposure, hdr: bool, sh_degree: int):
    """A novel view [H, W, 3] from viewmat [4, 4]: HDR radiance, or LDR
    through the CRF at `exposure` (a float32 scalar tensor)."""
    means, quats, scales, opac, sh = activate(params["gaussians"])
    rgb = colors(means, sh, geo.se3_inverse(viewmat[None]), sh_degree)
    out = rasterize(means, quats, scales, opac, rgb, viewmat[None], scene.cam,
                    raster_from(model["rasterize"]))
    if hdr:
        return out.hdr[0]
    return crf(params["crf"], out.hdr[0] * exposure, model["crf"])


def image_diag(width: int, height: int) -> float:
    return float(math.hypot(width, height))
