"""Per-tile alpha compositing: the chunk math, and the dense
[tiles, capacity] compositor.  Counterpart of
casualhdrsplat_tpu/ops/composite.py.

Per tile, Gaussians come in depth-ordered chunks of G.  Within a chunk the
transmittance is a prefix sum in log space, T_k = T_in * exp(cumsum_excl
log(1 - alpha)), so a chunk is dense [G, P] elementwise work plus a
contraction.  `_chunk_fwd` / `_chunk_bwd` are that plain math; every
function takes leading batch dimensions (tiles), which the reference
vmaps.  The plain versions of both compositors are built from them: the
streaming one in ops/rasterize_packed.py, the dense one here.

The dense compositor takes per-tile depth-ordered lists in two forms, one
kernel per direction for both:
- `composite_tile_lists` reads payload rows [V (N + 1), 16] through the
  [tiles, capacity] id table of binning.assign_tiles_arrays and is
  differentiable in the rows: the dense path of ops/rasterize.py, which so
  makes no gathered table;
- `composite_tiles` composites a gathered payload table [tiles, capacity,
  16] (binning.gather_payload) and is differentiable in it: the
  reference's interface, kept for `backend="xla"` and for callers that
  hold a table.
Either way:
- on CUDA tensors the forward launches csrc/rasterize_dense_fwd.cu and the
  backward csrc/rasterize_dense_bwd.cu through ops/rasterize_dense.py (or
  they raise);
- on CPU tensors they run `composite_tiles_reference` and
  `composite_tiles_backward_reference` (for the list form on the gathered
  lists, `composite_tile_lists_reference` and its backward) on the
  kernels' schedule: only the ceil(counts / G) occupied chunks of a tile,
  and none after the tile's largest transmittance fell below
  `transmittance_eps`;
- with `statics.backend == "xla"` they run the same plain versions without
  that schedule (every chunk, no early stop) on whatever device the
  tensors are: the reference's XLA compositor, an explicit request of the
  config.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from casualhdrsplat_torch.ops import binning

# [tiles, G, P] float32 elements the plain versions hold per intermediate:
# tiles go in batches of this many elements (512 MiB); the backward holds
# several times as many intermediates and takes a quarter.
_REFERENCE_ELEMENTS = 1 << 27
# Float32 roundings by which two evaluations of one alpha may differ (the
# products and sums of the exponent, the exp, the opacity product).
_TIE_ULPS = 8
_EPS32 = 2.0 ** -23


class CompositeStatics(NamedTuple):
    """Static compositor settings.  The reference's `prefix` field selects
    between two in-kernel prefix sums of its TPU kernels; the port's kernels
    carry running products and drop it."""

    num_views: int
    ntx: int
    nty: int
    tile_h: int
    tile_w: int
    chunk: int
    alpha_clip: float
    alpha_threshold: float
    # A tile's remaining windows are skipped once every pixel's
    # transmittance is below this.
    transmittance_eps: float = 1e-4
    # Output-row stride per view for the tile origin (tile = row %
    # tiles_per_view); 0 = ntx * nty.  A caller that composites a padded
    # slice of the tiles passes its padded stride.
    tiles_per_view: int = 0
    # The reference's names, dense compositor only: "pallas" = the
    # hand-written kernels (their plain versions on CPU tensors), "xla" =
    # the plain version without the kernels' chunk schedule, on any device.
    backend: str = "pallas"


class CompositeWork(NamedTuple):
    """What one input asked of a compositor (the plain versions with
    `return_work`)."""

    # list or stream slots in the chunks that were composited (each one's
    # row is read once)
    slots: int
    # (slot, pixel) pairs of those with alpha >= alpha_threshold: only they
    # blend, only they carry a gradient, and only at them does any
    # implementation have to evaluate alpha
    touched: int
    # [rows, P] bool: pixels where some slot's alpha lies within float32
    # rounding of alpha_threshold.  The function jumps there, so two correct
    # evaluations may take different sides.
    tie_pixels: torch.Tensor
    # [tiles, capacity] bool, the dense compositor only: which list slots
    # those are
    slots_read: Optional[torch.Tensor] = None


def tile_origin(tile_index: torch.Tensor, statics: CompositeStatics):
    """Pixel origin (ox, oy) of output row `tile_index` (views stack along
    the rows, `tiles_per_view` rows each)."""
    t = tile_index % (statics.tiles_per_view or statics.ntx * statics.nty)
    return (t % statics.ntx) * statics.tile_w, (t // statics.ntx) * statics.tile_h


def pixel_coords(origin_x, origin_y, tile_h: int, tile_w: int):
    """Pixel-centre coordinates of tiles: origins [...] -> (px, py), each
    [..., 1, P] float32, P = tile_h * tile_w in row-major order."""
    origin_x = torch.as_tensor(origin_x)
    origin_y = torch.as_tensor(origin_y)
    idx = torch.arange(tile_h * tile_w, dtype=torch.int32, device=origin_x.device)
    px = (idx % tile_w + origin_x[..., None, None]).to(torch.float32) + 0.5
    py = (idx // tile_w + origin_y[..., None, None]).to(torch.float32) + 0.5
    return px, py


def _alpha_terms(chunk, px, py, alpha_clip, alpha_threshold):
    """Chunk params [..., G, 16] x pixels [..., 1, P] -> alpha [..., G, P]
    plus the intermediates the backward needs."""

    def col(c):
        return chunk[..., c : c + 1]

    mx, my = col(binning.COL_MX), col(binning.COL_MY)
    cxx, cxy, cyy = col(binning.COL_CXX), col(binning.COL_CXY), col(binning.COL_CYY)
    opa = col(binning.COL_OPA)
    dx = px - mx
    dy = py - my
    power = -(0.5 * (cxx * dx * dx + cyy * dy * dy) + cxy * dx * dy)
    expf = torch.exp(torch.clamp(power, max=0.0))  # power <= 0 for PSD conics
    alpha_raw = opa * expf
    alpha = torch.clamp(alpha_raw, max=alpha_clip)
    alpha = torch.where(alpha >= alpha_threshold, alpha, 0.0)
    return alpha, alpha_raw, expf, dx, dy, (cxx, cxy, cyy)


def _chunk_fwd(chunk, px, py, t_in, alpha_clip, alpha_threshold):
    """One chunk of G depth-ordered Gaussians composited over P pixels.

    chunk [..., G, 16]; px/py [..., 1, P]; t_in [..., 1, P] incoming
    transmittance.  Returns (contrib [..., 4, P], t_out [..., 1, P]).
    """
    alpha, *_ = _alpha_terms(chunk, px, py, alpha_clip, alpha_threshold)
    log1m = torch.log1p(-alpha)
    s_incl = torch.cumsum(log1m, dim=-2)
    s_excl = s_incl - log1m
    w = alpha * torch.exp(s_excl) * t_in  # [..., G, P]
    c4 = chunk[..., binning.COL_R : binning.COL_ONE + 1]  # [..., G, 4]
    contrib = torch.matmul(c4.transpose(-1, -2), w)  # [..., 4, P]
    t_out = t_in * torch.exp(s_incl[..., -1:, :])
    return contrib, t_out


def _chunk_bwd(chunk, px, py, t_in, r_in, tot_dot, g4, alpha_clip, alpha_threshold):
    """Backward for one chunk, front to back.

    The suffix term of dL/dalpha_k is
        term2[k] = sum_c (c4_tot_c - prefix4_incl[k]_c) * g4_c .
    g4 does not depend on the slot k, so the channel dot commutes with the
    prefix over k:
        term2[k] = tot_dot - r_in - cumsum_incl_k(w * (c4 . g4)),
    and the carried per-channel prefix collapses to the scalar per-pixel
    carry r = sum_c prefix4_c * g4_c.

    chunk [..., G, 16]; px/py, t_in (recomputed transmittance carry), r_in
    and tot_dot (sum_c out4_c * g4_c) [..., 1, P]; g4 [..., 4, P] upstream
    gradient.  Returns (d_chunk [..., G, 16], t_out, r_out [..., 1, P]).
    """
    alpha, alpha_raw, expf, dx, dy, (cxx, cxy, cyy) = _alpha_terms(
        chunk, px, py, alpha_clip, alpha_threshold
    )
    log1m = torch.log1p(-alpha)
    s_incl = torch.cumsum(log1m, dim=-2)
    s_excl = s_incl - log1m
    t_k = torch.exp(s_excl) * t_in  # [..., G, P]
    w = alpha * t_k
    c4 = chunk[..., binning.COL_R : binning.COL_ONE + 1]  # [..., G, 4]

    # d colour (and the discarded constant-1 channel)
    d_c4 = torch.matmul(w, g4.transpose(-1, -2))  # [..., G, 4]
    cg = torch.matmul(c4, g4)  # [..., G, P]: c4_k . g4 per pixel
    u = w * cg
    term1 = t_k * cg
    term2 = tot_dot - r_in - torch.cumsum(u, dim=-2)
    dl_da = torch.where(alpha > 0.0, term1 - term2 / (1.0 - alpha), 0.0)

    # chain through alpha = min(opa * expf, clip): zero where clamped
    live = (alpha > 0.0) & (alpha_raw < alpha_clip)
    g_a = torch.where(live, dl_da, 0.0)
    g_pw = g_a * alpha  # d/d power

    d_chunk = torch.zeros_like(chunk)
    d_chunk[..., binning.COL_MX] = (g_pw * (cxx * dx + cxy * dy)).sum(-1)
    d_chunk[..., binning.COL_MY] = (g_pw * (cyy * dy + cxy * dx)).sum(-1)
    d_chunk[..., binning.COL_CXX] = (g_pw * (-0.5 * dx * dx)).sum(-1)
    d_chunk[..., binning.COL_CXY] = (g_pw * (-dx * dy)).sum(-1)
    d_chunk[..., binning.COL_CYY] = (g_pw * (-0.5 * dy * dy)).sum(-1)
    d_chunk[..., binning.COL_OPA] = (g_a * expf).sum(-1)
    d_chunk[..., binning.COL_R : binning.COL_B + 1] = d_c4[..., :3]

    t_out = t_in * torch.exp(s_incl[..., -1:, :])
    r_out = r_in + u.sum(-2, keepdim=True)
    return d_chunk, t_out, r_out


def chunk_work(chunk, px, py, in_list, statics: CompositeStatics):
    """Work report of one batch of chunks [s, G, 16] whose slots outside
    `in_list` [s, G] carry zero opacity: (touched (slot, pixel) pairs,
    [s, P] pixels at a threshold tie).  A tie is |alpha - threshold| <=
    `_TIE_ULPS` float32 roundings of the threshold, each scaled by 1 + the
    sum of the magnitudes of the exponent's terms (the rounding of a
    cancelling sum grows with them)."""
    alpha, alpha_raw, _, dx, dy, (cxx, cxy, cyy) = _alpha_terms(
        chunk, px, py, statics.alpha_clip, statics.alpha_threshold)
    terms = 0.5 * (cxx.abs() * dx * dx + cyy.abs() * dy * dy) + (cxy * dx * dy).abs()
    slack = _TIE_ULPS * _EPS32 * statics.alpha_threshold * (1.0 + terms)
    near = (alpha_raw.clamp(max=statics.alpha_clip) - statics.alpha_threshold).abs() <= slack
    return (alpha > 0.0).sum(), (near & in_list[..., None]).any(dim=1)


# --------------------------------------------------------------------------
# The dense compositor: plain versions
# --------------------------------------------------------------------------


def _tile_batches(tt: int, statics: CompositeStatics, share: int, device):
    rows = max(1, _REFERENCE_ELEMENTS // share
               // (statics.chunk * statics.tile_h * statics.tile_w))
    for start in range(0, tt, rows):
        yield torch.arange(start, min(start + rows, tt), device=device)


def _chunk_counts(counts, cap: int, statics: CompositeStatics, kernel_schedule: bool):
    """Chunks of every tile's list that the schedule visits."""
    if kernel_schedule:
        return (counts.long() + statics.chunk - 1) // statics.chunk
    return torch.full_like(counts, cap // statics.chunk, dtype=torch.int64)


def _list_chunk(gathered, counts, tile, k: int, statics: CompositeStatics,
                kernel_schedule: bool):
    """Chunk k of the lists of `tile` [s]: ([s, G, 16], in_list [s, G]).  On
    the kernels' schedule the slots from counts on, which the kernels do not
    read, get zero opacity (they are pad rows by contract)."""
    g = statics.chunk
    chunk = gathered[tile, k * g:(k + 1) * g]  # a fresh copy
    if not kernel_schedule:
        return chunk, torch.ones(chunk.shape[:2], dtype=torch.bool, device=chunk.device)
    in_list = (k * g + torch.arange(g, device=gathered.device)) < counts[tile, None]
    chunk[..., binning.COL_OPA] = torch.where(in_list, chunk[..., binning.COL_OPA], 0.0)
    return chunk, in_list


def composite_tiles_reference(
    gathered: torch.Tensor,
    tile_indices: torch.Tensor,
    counts: torch.Tensor,
    statics: CompositeStatics,
    kernel_schedule: bool = True,
    return_work: bool = False,
):
    """Plain PyTorch version of `composite_tiles` on any device: [tt, 4, P].

    Tiles go in batches; within a batch, chunk k of every tile that the
    schedule still visits is composited with `_chunk_fwd`.  With
    `kernel_schedule` that is the kernels' schedule (the ceil(counts / G)
    occupied chunks, and none once no pixel of the tile has T >= eps):
    the kernel's yardstick.  Without it every chunk of every list is
    composited, as the reference's XLA compositor does.

    With `return_work`, also returns a `CompositeWork`.
    """
    tt, cap, _ = gathered.shape
    p = statics.tile_h * statics.tile_w
    dev = gathered.device
    out = torch.zeros((tt, 4, p), dtype=torch.float32, device=dev)
    n_chunks = _chunk_counts(counts, cap, statics, kernel_schedule)
    slots = torch.zeros((), dtype=torch.int64, device=dev)
    touched = torch.zeros((), dtype=torch.int64, device=dev)
    tie_pixels = torch.zeros((tt, p), dtype=torch.bool, device=dev)
    slots_read = torch.zeros((tt, cap), dtype=torch.bool, device=dev) if return_work else None
    for rows in _tile_batches(tt, statics, 1, dev):
        ox, oy = tile_origin(tile_indices[rows], statics)
        px, py = pixel_coords(ox, oy, statics.tile_h, statics.tile_w)
        t = torch.ones((rows.shape[0], 1, p), dtype=torch.float32, device=dev)
        acc = torch.zeros((rows.shape[0], 4, p), dtype=torch.float32, device=dev)
        for k in range(int(n_chunks[rows].max()) if rows.numel() else 0):
            live = n_chunks[rows] > k
            if kernel_schedule:
                live &= t.amax(dim=(1, 2)) >= statics.transmittance_eps
            sel = live.nonzero()[:, 0]
            if sel.numel() == 0:
                break
            chunk, in_list = _list_chunk(gathered, counts, rows[sel], k, statics,
                                         kernel_schedule)
            contrib, t_out = _chunk_fwd(chunk, px[sel], py[sel], t[sel],
                                        statics.alpha_clip, statics.alpha_threshold)
            acc[sel] += contrib
            t[sel] = t_out
            if return_work:
                slots += in_list.sum()
                slots_read[rows[sel], k * statics.chunk:(k + 1) * statics.chunk] = in_list
                pairs, ties = chunk_work(chunk, px[sel], py[sel], in_list, statics)
                touched += pairs
                tie_pixels[rows[sel]] |= ties
        out[rows] = acc
    if return_work:
        return out, CompositeWork(int(slots), int(touched), tie_pixels, slots_read)
    return out


def composite_tiles_backward_reference(
    gathered: torch.Tensor,
    tile_indices: torch.Tensor,
    counts: torch.Tensor,
    out4: torch.Tensor,  # [tt, 4, P] the forward's output
    g4: torch.Tensor,  # [tt, 4, P] its upstream gradient
    statics: CompositeStatics,
    kernel_schedule: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of the dense backward on any device:
    d_gathered [tt, capacity, 16], the gradient of every table slot.

    It walks `composite_tiles_reference`'s schedule, front to back, with
    the same vote on the recomputed T, carrying per pixel T and the scalar
    suffix term r through `_chunk_bwd`: the hand-written formula of the
    kernel, not autograd.  Chunks the schedule does not visit stay zero.
    """
    tt, cap, _ = gathered.shape
    g = statics.chunk
    p = statics.tile_h * statics.tile_w
    dev = gathered.device
    d_gathered = torch.zeros_like(gathered)
    n_chunks = _chunk_counts(counts, cap, statics, kernel_schedule)
    for rows in _tile_batches(tt, statics, 4, dev):
        ox, oy = tile_origin(tile_indices[rows], statics)
        px, py = pixel_coords(ox, oy, statics.tile_h, statics.tile_w)
        g4_rows = g4[rows]
        tot_dot = (out4[rows] * g4_rows).sum(1, keepdim=True)  # [b, 1, P]
        t = torch.ones((rows.shape[0], 1, p), dtype=torch.float32, device=dev)
        r_carry = torch.zeros_like(t)
        for k in range(int(n_chunks[rows].max()) if rows.numel() else 0):
            live = n_chunks[rows] > k
            if kernel_schedule:
                live &= t.amax(dim=(1, 2)) >= statics.transmittance_eps
            sel = live.nonzero()[:, 0]
            if sel.numel() == 0:
                break
            chunk, _ = _list_chunk(gathered, counts, rows[sel], k, statics,
                                   kernel_schedule)
            d_chunk, t_out, r_out = _chunk_bwd(
                chunk, px[sel], py[sel], t[sel], r_carry[sel], tot_dot[sel],
                g4_rows[sel], statics.alpha_clip, statics.alpha_threshold,
            )
            d_gathered[rows[sel], k * g:(k + 1) * g] = d_chunk
            t[sel] = t_out
            r_carry[sel] = r_out
    return d_gathered


def list_rows(rows, ids, tile_indices, counts, statics: CompositeStatics):
    """The rows of the flattened payload that the list form reads:
    (row index [tt, capacity], in_list [tt, capacity]).  Slot k of tile i
    is row (tile_indices[i] // tiles_per_view) * (N + 1) + ids[i, k] for
    k < counts[i].  A slot whose id lies outside [0, N + 1), and every slot
    of a tile whose view lies outside [0, num_views), reads nothing (as in
    the kernels); such slots and those from counts on have index 0 and are
    not in the list."""
    view_rows = rows.shape[0] // statics.num_views
    view = tile_indices.long() // (statics.tiles_per_view or statics.ntx * statics.nty)
    ids = ids.long()
    in_list = ((torch.arange(ids.shape[1], device=ids.device)[None, :] < counts[:, None])
               & ((view >= 0) & (view < statics.num_views))[:, None]
               & (ids >= 0) & (ids < view_rows))
    return torch.where(in_list, view[:, None] * view_rows + ids, 0), in_list


def gather_lists(rows, ids, tile_indices, counts, statics: CompositeStatics):
    """The list form as a table [tt, capacity, 16] plus the slots it reads:
    (table, row index [tt, capacity], in_list [tt, capacity]) with
    `list_rows`' index and in_list; slots not in the list are zero rows."""
    index, in_list = list_rows(rows, ids, tile_indices, counts, statics)
    table = torch.index_select(rows, 0, index.reshape(-1)).reshape(ids.shape + (-1,))
    return torch.where(in_list[..., None], table, 0.0), index, in_list


def composite_tile_lists_reference(rows, ids, tile_indices, counts, statics: CompositeStatics,
                                   kernel_schedule: bool = True, return_work: bool = False):
    """Plain PyTorch version of `composite_tile_lists` on any device: the
    lists gathered (`gather_lists`), then `composite_tiles_reference`."""
    table, _, _ = gather_lists(rows, ids, tile_indices, counts, statics)
    return composite_tiles_reference(table, tile_indices, counts, statics,
                                     kernel_schedule=kernel_schedule, return_work=return_work)


def composite_tile_lists_backward_reference(rows, ids, tile_indices, counts, out4, g4,
                                            statics: CompositeStatics,
                                            kernel_schedule: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the list form's backward on any device: the
    gradient of `rows`.  `composite_tiles_backward_reference` on the
    gathered lists, whose slots' gradients are added into their rows with
    `index_add_`; slots from counts on add nothing, so the pad row gets no
    gradient from them."""
    table, index, in_list = gather_lists(rows, ids, tile_indices, counts, statics)
    d_table = composite_tiles_backward_reference(table, tile_indices, counts, out4, g4,
                                                 statics, kernel_schedule=kernel_schedule)
    d_rows = torch.zeros_like(rows)
    d_rows.index_add_(0, index[in_list], d_table[in_list])
    return d_rows


# --------------------------------------------------------------------------
# The differentiable entry points
# --------------------------------------------------------------------------


class _CompositeTiles(torch.autograd.Function):
    """Forward kernel B3 and backward kernel B4 (their plain versions on
    CPU tensors, or for backend "xla") as one differentiable function of
    the lists' rows: the list form's payload rows where `ids` is given,
    else the gathered table."""

    @staticmethod
    def forward(ctx, rows, ids, tile_indices, counts, statics):
        from casualhdrsplat_torch.ops import rasterize_dense

        if statics.backend == "xla" or rows.device.type == "cpu":
            schedule = statics.backend != "xla"
            if ids is None:
                out = composite_tiles_reference(rows, tile_indices, counts, statics,
                                                kernel_schedule=schedule)
            else:
                out = composite_tile_lists_reference(rows, ids, tile_indices, counts, statics,
                                                     kernel_schedule=schedule)
        else:
            out = rasterize_dense.forward(rows, tile_indices, counts, statics, ids)
        ctx.statics = statics
        ctx.save_for_backward(rows, ids, tile_indices, counts, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g4):
        from casualhdrsplat_torch.ops import rasterize_dense

        rows, ids, tile_indices, counts, out4 = ctx.saved_tensors
        statics = ctx.statics
        if statics.backend == "xla" or rows.device.type == "cpu":
            schedule = statics.backend != "xla"
            if ids is None:
                d = composite_tiles_backward_reference(rows, tile_indices, counts, out4, g4,
                                                       statics, kernel_schedule=schedule)
            else:
                d = composite_tile_lists_backward_reference(
                    rows, ids, tile_indices, counts, out4, g4, statics,
                    kernel_schedule=schedule)
        else:
            d = rasterize_dense.backward(rows, tile_indices, counts, out4, g4, statics, ids)
        return d, None, None, None, None


def _default_lists(tt: int, cap: int, device, tile_indices, counts):
    if tile_indices is None:
        tile_indices = torch.arange(tt, dtype=torch.int32, device=device)
    if counts is None:
        counts = torch.full((tt,), cap, dtype=torch.int32, device=device)
    return tile_indices, counts


def composite_tile_lists(
    rows: torch.Tensor,
    ids: torch.Tensor,
    statics: CompositeStatics,
    tile_indices: Optional[torch.Tensor] = None,
    counts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Composite depth-ordered per-tile Gaussian lists read through an id
    table, without gathering them.

    rows: [V * (N + 1), 16] the payload of V = statics.num_views views
      (binning.build_payload, flattened over views); row N of each view is
      the zero pad row.
    ids: [num_tiles_total, capacity] int32 ids into a view's rows
      (binning.assign_tiles_arrays, views stacked); tile i reads row
      (tile_indices[i] // tiles_per_view) * (N + 1) + ids[i, k].
    tile_indices: [num_tiles_total] int32 global tile index of each entry
      (origin from index % tiles_per_view); default arange.
    counts: [num_tiles_total] int32 occupied slots of each list (default:
      the capacity).  Only ids[i, k] for k < counts[i] are read.  A slot
      whose id lies outside [0, N + 1) composites as an empty slot, and a
      tile whose view lies outside [0, num_views) as an empty list: no
      value of ids or tile_indices reads or writes outside `rows`.

    Returns [num_tiles_total, 4, tile_h * tile_w], equal to
    `composite_tiles` of the gathered lists, and so is its gradient with
    respect to `rows`, but for the pad slots' cotangents, which are dropped
    (the pad row is a constant).
    """
    from casualhdrsplat_torch.ops import rasterize_dense

    tile_indices, counts = _default_lists(ids.shape[0], ids.shape[1], ids.device, tile_indices,
                                          counts)
    rasterize_dense.check_lists(rows, ids, tile_indices, counts, statics)
    return _CompositeTiles.apply(rows, ids, tile_indices, counts, statics)


def composite_tiles(
    gathered: torch.Tensor,
    statics: CompositeStatics,
    tile_indices: Optional[torch.Tensor] = None,
    counts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Composite depth-ordered per-tile Gaussian lists.

    gathered: [num_tiles_total, capacity, 16] payload table
      (binning.gather_payload, tiles row-major per view, views stacked).
    tile_indices: [num_tiles_total] int32 global tile index of each entry
      (origin from index % tiles_per_view in the row-major tile grid);
      default arange.  A caller compositing a slice of the tiles passes
      its offset indices.
    counts: [num_tiles_total] int32 occupied slots of each list (default:
      the capacity).  Slots from counts[i] on must be pad rows (zero
      opacity): the kernels do not read them.

    Returns [num_tiles_total, 4, tile_h * tile_w]: RGB radiance and
    accumulated alpha per pixel.  Differentiable in `gathered` through the
    hand-written backward.
    """
    from casualhdrsplat_torch.ops import rasterize_dense

    tile_indices, counts = _default_lists(gathered.shape[0], gathered.shape[1],
                                          gathered.device, tile_indices, counts)
    rasterize_dense.check(gathered, tile_indices, counts, statics)
    return _CompositeTiles.apply(gathered, None, tile_indices, counts, statics)
