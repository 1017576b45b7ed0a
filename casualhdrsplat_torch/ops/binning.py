"""Tile binning + depth sort.  Counterpart of
casualhdrsplat_tpu/ops/binning.py.

Every shape stays static (the reference's XLA requirement, kept so the
two packages agree slot for slot): each Gaussian emits up to
`max_tiles_per_gaussian` (tile, depth) keys, one stable sort orders them,
and per-tile segment starts come from a search.  The integer outputs equal
the reference's exactly; that needs stable sorts, since `jnp.argsort` and
`lax.sort` are stable.

The sorted stream feeds both rasterizers: the packed path compacts it to a
stream budget (`waterfill_segments`, `compact_stream_ids`), the dense path
cuts it into a [tiles, capacity] id table (`assign_tiles_arrays`), through
which its kernels read the payload rows; `gather_payload` gathers them into
a [tiles, capacity, 16] table for the plain compositor of backend "xla".
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# Payload column layout: [mx, my, cxx, cxy, cyy, opacity, r, g, b, one, 0 x6]
PAYLOAD_DIM = 16
COL_MX, COL_MY = 0, 1
COL_CXX, COL_CXY, COL_CYY = 2, 3, 4
COL_OPA = 5
COL_R, COL_G, COL_B, COL_ONE = 6, 7, 8, 9

_I32 = torch.int32
# Spare rows of the scatter buffer in gather_payload's backward: the
# gradients of the pad slots (most of a table) are spread over them rather
# than piled onto one pad row by millions of atomic adds, then dropped.
_PAD_GRAD_ROWS = 1 << 16


class TileLists(NamedTuple):
    indices: torch.Tensor  # [..., num_tiles, capacity] int32 Gaussian id (N = pad)
    counts: torch.Tensor  # [..., num_tiles] int32 (clipped at capacity)
    num_dropped: torch.Tensor  # [] tile-capacity overflow
    num_clipped: torch.Tensor  # [] bbox cells cut by the mtpg clamp


def _ceil_log2(x: int) -> int:
    return max(1, (x - 1).bit_length())


def tile_grid(width: int, height: int, tile_h: int, tile_w: int):
    ntx = -(-width // tile_w)
    nty = -(-height // tile_h)
    return ntx, nty


def _tile_bbox(mx, my, r, ntx, nty, tile_h, tile_w):
    def cell(v, size, hi):
        return torch.clamp(torch.floor(v / size).to(_I32), 0, hi - 1)

    return (cell(mx - r, tile_w, ntx), cell(mx + r, tile_w, ntx),
            cell(my - r, tile_h, nty), cell(my + r, tile_h, nty))


def sorted_stream(
    means2d: torch.Tensor,
    radii: torch.Tensor,
    depths: torch.Tensor,
    valid: torch.Tensor,
    width: int,
    height: int,
    tile_h: int,
    tile_w: int,
    max_tiles_per_gaussian: int,
):
    """(tile, depth)-ordered intersection stream.

    Returns (s_gauss [N*mtpg] int32 Gaussian ids grouped by tile in depth
    order, invalid/sentinel pairs at the tail; starts [T+1]; seg_len [T];
    clipped, the count of bbox cells dropped by the mtpg clamp).
    """
    n = means2d.shape[0]
    dev = means2d.device
    ntx, nty = tile_grid(width, height, tile_h, tile_w)
    num_tiles = ntx * nty
    mtpg = max_tiles_per_gaussian

    # depth rank of every Gaussian, ties broken by index (stable)
    order = torch.argsort(depths, stable=True)
    inv_rank = torch.empty(n, dtype=_I32, device=dev)
    inv_rank[order] = torch.arange(n, dtype=_I32, device=dev)

    tx0, tx1, ty0, ty1 = _tile_bbox(
        means2d[:, 0], means2d[:, 1], radii, ntx, nty, tile_h, tile_w
    )
    w_span = tx1 - tx0 + 1
    h_span = ty1 - ty0 + 1

    # A bbox larger than mtpg cells is centre-clamped to the biggest
    # aspect-preserving w_c x h_c <= mtpg block; the cut cells are counted.
    area = w_span * h_span
    over = area > mtpg
    sc = torch.sqrt(mtpg / torch.clamp(area, min=1).to(torch.float32))
    h_c = torch.clamp(torch.floor(h_span * sc).to(_I32), min=1)
    h_c = torch.minimum(h_c, h_span)
    w_c = torch.minimum(torch.clamp(mtpg // h_c, min=1), w_span)
    h_c = torch.minimum(torch.clamp(mtpg // w_c, min=1), h_span)
    w_span_f = torch.where(over, w_c, w_span)
    h_span_f = torch.where(over, h_c, h_span)
    tx0 = torch.where(over, tx0 + (w_span - w_span_f) // 2, tx0)
    ty0 = torch.where(over, ty0 + (h_span - h_span_f) // 2, ty0)
    clipped = torch.where(valid, area - w_span_f * h_span_f, 0).sum().to(_I32)
    w_span, h_span = w_span_f, h_span_f

    # slot s covers bbox cell (s // w_span, s % w_span), row-major
    slots = torch.arange(mtpg, dtype=_I32, device=dev)
    row = slots[None, :] // w_span[:, None]
    col = slots[None, :] % w_span[:, None]
    in_bbox = (row < h_span[:, None]) & valid[:, None]
    tile_ids = torch.where(
        in_bbox, (ty0[:, None] + row) * ntx + tx0[:, None] + col, num_tiles
    ).to(_I32)

    # Within one tile the depth rank is a unique tiebreaker, so
    # key = tile << rank_bits | rank orders (tile, depth) in one sort.
    rank_bits = _ceil_log2(n)
    if rank_bits + _ceil_log2(num_tiles + 1) <= 31:
        key = ((tile_ids << rank_bits) | inv_rank[:, None]).reshape(-1)
    else:
        # the reference's two-key sort; the same order from one int64 key
        key = ((tile_ids.to(torch.int64) << rank_bits)
               | inv_rank[:, None].to(torch.int64)).reshape(-1)
    s_key, perm = torch.sort(key, stable=True)
    s_gauss = (perm // mtpg).to(_I32)
    s_tiles = (s_key >> rank_bits).to(_I32)

    starts = torch.searchsorted(
        s_tiles, torch.arange(num_tiles + 1, dtype=_I32, device=dev)
    ).to(_I32)
    seg_len = starts[1:] - starts[:-1]
    return s_gauss, starts, seg_len, clipped


def tile_demand(
    means2d: torch.Tensor,
    radii: torch.Tensor,
    valid: torch.Tensor,
    width: int,
    height: int,
    tile_h: int,
    tile_w: int,
    max_tiles_per_gaussian: int,
) -> torch.Tensor:
    """Total intersection-stream rows these footprints demand: the sum
    over Gaussians of bbox tiles after the mtpg clamp (no sort)."""
    ntx, nty = tile_grid(width, height, tile_h, tile_w)
    tx0, tx1, ty0, ty1 = _tile_bbox(
        means2d[:, 0], means2d[:, 1], radii, ntx, nty, tile_h, tile_w
    )
    area = torch.clamp((tx1 - tx0 + 1) * (ty1 - ty0 + 1), max=max_tiles_per_gaussian)
    return torch.where(valid, area, 0).sum()


def assign_tiles(proj, width: int, height: int, tile_h: int, tile_w: int,
                 capacity: int, max_tiles_per_gaussian: int) -> TileLists:
    """Per-tile depth-ordered id lists of one view's projection."""
    return assign_tiles_arrays(
        proj.means2d, proj.radii, proj.depths, proj.valid,
        width, height, tile_h, tile_w, capacity, max_tiles_per_gaussian,
    )


def assign_tiles_arrays(
    means2d: torch.Tensor,
    radii: torch.Tensor,
    depths: torch.Tensor,
    valid: torch.Tensor,
    width: int,
    height: int,
    tile_h: int,
    tile_w: int,
    capacity: int,
    max_tiles_per_gaussian: int,
) -> TileLists:
    """The dense [T, capacity] id table: tile t's row holds the nearest
    `capacity` entries of its segment of the sorted stream, then the pad
    id N.  An overfull tile drops its farthest entries, which are counted."""
    n = means2d.shape[0]
    s_gauss, starts, seg_len, clipped = sorted_stream(
        means2d, radii, depths, valid, width, height, tile_h, tile_w,
        max_tiles_per_gaussian,
    )
    counts = torch.clamp(seg_len, max=capacity).to(_I32)
    num_dropped = torch.clamp(seg_len - capacity, min=0).sum()
    # by gather from the sorted id stream, as the reference builds it
    k = torch.arange(capacity, dtype=_I32, device=means2d.device)
    idx = starts[:-1, None] + k[None, :]  # [T, capacity]
    in_seg = k[None, :] < seg_len[:, None]
    gid = s_gauss[torch.clamp(idx, max=s_gauss.shape[0] - 1).long()]
    table = torch.where(in_seg, gid, n).to(_I32)
    return TileLists(indices=table, counts=counts, num_dropped=num_dropped,
                     num_clipped=clipped)


class StreamChunks(NamedTuple):
    """The reference kernel's chunk schedule over the depth-sorted stream.

    The port's compositor derives the same windows from per-row (lo, hi)
    bounds (ops/rasterize_packed.py); this schedule is kept for parity with
    the reference and for the tests that check the two agree.
    """

    block_id: torch.Tensor  # [C] int32 stream block (index * chunk)
    out_row: torch.Tensor  # [C] int32 output row (tile) of the chunk
    first: torch.Tensor  # [C] int32 1 = first chunk of its tile
    seg_lo: torch.Tensor  # [C] int32 stream position where the tile starts
    seg_hi: torch.Tensor  # [C] int32 stream position where the tile ends
    block_new: torch.Tensor  # [C] int32 1 = first chunk touching its block
    num_chunks: torch.Tensor  # [] int32 real chunks


def stream_budget(n: int, mtpg: int, num_tiles: int, chunk: int) -> int:
    """Static chunk-count bound: stream/chunk + num_tiles + 1."""
    return n * mtpg // chunk + num_tiles + 1


def pack_stream_chunks(
    starts: torch.Tensor,  # [T+1]
    seg_len: torch.Tensor,  # [T]
    m: int,
    chunk: int,
    budget: int,
    out_row_offset,
    sentinel_row: int,
) -> StreamChunks:
    """Chunk schedule; unused budget chunks alias `sentinel_row`."""
    num_tiles = seg_len.shape[0]
    dev = seg_len.device
    g = chunk
    ends = starts[:-1] + seg_len
    first_block = starts[:-1] // g
    last_block = torch.where(seg_len > 0, (ends - 1) // g, first_block)
    tile_chunks = last_block - first_block + 1  # >= 1 (empty tiles get 1)
    cum = torch.cat([torch.zeros(1, dtype=_I32, device=dev),
                     torch.cumsum(tile_chunks, 0).to(_I32)])
    total = cum[-1]

    c_ids = torch.arange(budget, dtype=_I32, device=dev)
    tile_of = torch.searchsorted(cum, c_ids, right=True).to(_I32) - 1
    used = c_ids < total
    t = torch.clamp(tile_of, 0, num_tiles - 1).long()
    first = torch.where(used, c_ids == cum[t], True)
    block = first_block[t] + (c_ids - cum[t])
    max_block = m // g - 1
    block_id = torch.where(used, torch.clamp(block, 0, max_block), max_block).to(_I32)
    block_new = torch.cat([torch.ones(1, dtype=_I32, device=dev),
                           (torch.diff(block_id) != 0).to(_I32)])
    return StreamChunks(
        block_id=block_id,
        out_row=torch.where(used, t + out_row_offset, sentinel_row).to(_I32),
        first=first.to(_I32),
        seg_lo=torch.where(used, starts[t], 0).to(_I32),
        seg_hi=torch.where(used, ends[t], 0).to(_I32),
        block_new=block_new,
        num_chunks=total,
    )


def waterfill_segments(seg_len: torch.Tensor, budget: int):
    """Cap per-tile segment lengths at the largest uniform level `cap` with
    sum(min(seg_len, cap)) <= budget: an overloaded tile keeps its nearest
    `cap` intersections.  Returns (seg_c [T], starts_c [T+1])."""
    t = seg_len.shape[0]
    dev = seg_len.device
    s = torch.sort(seg_len).values
    zero = torch.zeros(1, dtype=_I32, device=dev)
    csum0 = torch.cat([zero, torch.cumsum(s, 0)[:-1].to(_I32)])
    rem = (t - torch.arange(t, device=dev)).to(_I32)
    c_i = torch.div(budget - csum0, rem, rounding_mode="floor")
    trunc = c_i < s  # tile i cannot be kept whole
    # c_i at the first truncated tile, gathered on the device (indexing by a
    # 0-d tensor would read it on the host)
    first = c_i.gather(0, torch.argmax(trunc.to(_I32)).reshape(1))[0]
    cap = torch.where(trunc.any(), first, budget)
    seg_c = torch.minimum(seg_len, cap).to(_I32)
    starts_c = torch.cat([zero, torch.cumsum(seg_c, 0).to(_I32)])
    return seg_c, starts_c


def compact_stream_ids(
    s_gauss: torch.Tensor,  # [N*mtpg] sorted intersection stream
    starts: torch.Tensor,  # [T+1] uncapped segment starts in s_gauss
    starts_c: torch.Tensor,  # [T+1] compacted starts (waterfill_segments)
    budget: int,
    pad_id: int,
) -> torch.Tensor:
    """Gaussian ids of the budget-compacted stream: slot j holds entry
    starts[t] + (j - starts_c[t]) of the sorted stream, t = tile owning j.

    The per-slot source offset is piecewise constant, so it is one
    T-sized boundary scatter + a cumsum.  Without overflow the shifts are
    zero and this is the identity prefix, so unlike the reference there is
    no branch on the overflow flag (which would cost a device sync).
    """
    t = starts_c.shape[0] - 1
    dev = s_gauss.device
    j = torch.arange(budget, dtype=_I32, device=dev)
    total = s_gauss.shape[0]
    shift_t = (starts[:t] - starts_c[:t]).to(_I32)
    deltas = torch.diff(shift_t, prepend=torch.zeros(1, dtype=_I32, device=dev))
    # one spare slot takes the boundaries at `budget`, which the reference
    # drops (mode="drop")
    shift = torch.zeros(budget + 1, dtype=_I32, device=dev)
    shift.index_add_(0, starts_c[:t].long(), deltas)
    src = j + torch.cumsum(shift[:budget], 0).to(_I32)
    gathered = s_gauss[torch.clamp(src, max=total - 1).long()]
    return torch.where(j < starts_c[t], gathered, pad_id).to(_I32)


def build_payload(proj, colors: torch.Tensor, opacities: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian screen packet [..., N + 1, 16]; the last row is zero
    padding, targeted by unused stream slots."""
    opa = torch.where(proj.valid, opacities * proj.compensation, 0.0)
    rows = build_payload_rows(proj.means2d, proj.conics, opa, colors)
    pad = torch.zeros(rows.shape[:-2] + (1, PAYLOAD_DIM), dtype=rows.dtype,
                      device=rows.device)
    return torch.cat([rows, pad], dim=-2)


def build_payload_rows(
    means2d: torch.Tensor,
    conics: torch.Tensor,
    opacity_eff: torch.Tensor,
    colors: torch.Tensor,
) -> torch.Tensor:
    """[..., N, 16] packet rows without the padding row."""
    shape = opacity_eff.shape
    colors = colors.expand(shape + (3,))
    one = torch.ones(shape + (1,), dtype=torch.float32, device=opacity_eff.device)
    zeros = torch.zeros(shape + (PAYLOAD_DIM - COL_ONE - 1,), dtype=torch.float32,
                        device=opacity_eff.device)
    return torch.cat(
        [means2d, conics, opacity_eff[..., None], colors, one, zeros], dim=-1
    )


class _GatherRows(torch.autograd.Function):
    """rows[index] whose backward keeps the pad slots' gradients off the
    one pad row (see `gather_payload`)."""

    @staticmethod
    def forward(ctx, rows, index, is_pad):
        ctx.save_for_backward(index, is_pad)
        ctx.num_rows = rows.shape[0]
        return torch.index_select(rows, 0, index)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        index, is_pad = ctx.saved_tensors
        m = ctx.num_rows
        spare = m + torch.arange(index.shape[0], dtype=index.dtype,
                                 device=index.device) % _PAD_GRAD_ROWS
        buf = torch.zeros((m + _PAD_GRAD_ROWS, grad.shape[1]), dtype=grad.dtype,
                          device=grad.device)
        buf.index_add_(0, torch.where(is_pad, spare, index), grad)
        return buf[:m], None, None


def gather_payload(payload: torch.Tensor, tiles: TileLists) -> torch.Tensor:
    """Payload rows [..., N + 1, 16] by id table [..., T, capacity] ->
    [..., T, capacity, 16], all leading (view) dimensions in one gather.

    The transpose is a scatter-add of the per-slot gradients into the
    payload rows (float atomics on a CUDA device).  Most slots of a table
    are pad slots; autograd's own transpose would add all of them into the
    one pad row N.  The pad row is a constant, so here its gradient is
    dropped instead: pad slots scatter into spare rows that are cut off.
    """
    n1 = payload.shape[-2]
    lead = payload.shape[:-2]
    table = tiles.indices
    if table.shape[:-2] != lead:
        raise ValueError(f"payload {tuple(payload.shape)} and id table "
                         f"{tuple(table.shape)} differ in their leading dimensions")
    views = math.prod(lead)
    # row v * (N + 1) + id of the flattened payload
    offset = (torch.arange(views, dtype=_I32, device=table.device) * n1).reshape(
        lead + (1, 1))
    index = (table + offset).reshape(-1)
    is_pad = (table >= n1 - 1).reshape(-1)
    flat = _GatherRows.apply(payload.reshape(views * n1, PAYLOAD_DIM), index, is_pad)
    return flat.reshape(table.shape + (PAYLOAD_DIM,))


def tile_origins(width: int, height: int, tile_h: int, tile_w: int,
                 device="cuda") -> torch.Tensor:
    """[num_tiles, 2] int32 (x0, y0) pixel origin of every tile, row-major."""
    ntx, nty = tile_grid(width, height, tile_h, tile_w)
    ty, tx = torch.meshgrid(torch.arange(nty, dtype=_I32, device=device),
                            torch.arange(ntx, dtype=_I32, device=device), indexing="ij")
    return torch.stack([tx.reshape(-1) * tile_w, ty.reshape(-1) * tile_h], dim=-1)
