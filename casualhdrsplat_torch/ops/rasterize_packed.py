"""Streaming compositor over the depth-sorted intersection stream, forward
and backward.

Counterpart of casualhdrsplat_tpu/ops/rasterize_packed.py (`forward`,
`backward` and their Pallas kernels `_fwd_kernel` and `_bwd_kernel`).
Binning produces one depth-sorted payload stream [M, 16]; output row r
(tile t of view v) owns the stream segment [row_lo[r], row_hi[r]) and
composites it front to back in windows of G = chunk stream positions
aligned to multiples of G.  A row stops at the first window where no pixel
of its tile has transmittance >= eps.  The backward rebuilds T over the
same windows and writes the gradient of every stream slot in stream space.

`composite_stream` is differentiable in the stream:
- on CUDA tensors the forward launches csrc/rasterize_packed_fwd.cu and the
  backward csrc/rasterize_packed_bwd.cu (or they raise), their CTAs taking
  the rows longest first (`row_order`, computed once in the forward and
  kept for the backward) and evaluating each slot only in the warps and
  pixel groups its box meets (`slot_boxes`);
- on CPU tensors they run `composite_stream_reference` and
  `composite_stream_backward_reference`, the plain PyTorch versions: the
  same window schedule, batched over rows, with the chunk math of
  ops/composite.py.  The CPU backward is the hand-written formula the
  kernel implements, not autograd through the plain forward.

The TPU kernels walk a flat chunk schedule (binning.pack_stream_chunks)
and pack their per-chunk words for SMEM; the port passes each row's
(lo, hi) instead and derives the same windows from them (`row_windows`).
"""

from __future__ import annotations

import ctypes
import torch

from casualhdrsplat_torch.ops import binning
from casualhdrsplat_torch.ops.composite import (
    CompositeStatics,
    CompositeWork,
    _chunk_bwd,
    _chunk_fwd,
    chunk_work,
    pixel_coords,
    tile_origin,
)
from casualhdrsplat_torch.ops.cuda_build import CudaKernel

# Most pixels a tile may have: the forward kernel gives each of its 256
# threads at most 16 pixels, the backward each of its 512 at most 8.
MAX_TILE_PIXELS = 4096
# Rows the plain versions composite at once: 512 rows of 16x128 tiles at
# G = 128 make [512, 128, 2048] float32 intermediates of 512 MiB each; the
# backward holds several times as many of them.
_REFERENCE_ROW_BATCH = 512
_REFERENCE_BWD_ROW_BATCH = 128

FWD_KERNEL = CudaKernel(
    "rasterize_packed_fwd.cu",
    "chs_rasterize_packed_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float] * 3
    + [ctypes.c_void_p],
)
BWD_KERNEL = CudaKernel(
    "rasterize_packed_bwd.cu",
    "chs_rasterize_packed_bwd",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float] * 3
    + [ctypes.c_void_p],
)
# The kernels' own slot box (tile_boxes.cuh) launched alone, for tests.
BOX_KERNEL = CudaKernel(
    "rasterize_packed_fwd.cu",
    "chs_packed_slot_boxes",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p],
)
# The box of a slot that reaches no pixel: (x0, x1, y0, y1) that no block meets.
EMPTY_BOX = (32767, -1, 32767, -1)


def row_windows(row_lo: torch.Tensor, row_hi: torch.Tensor, chunk: int):
    """(first block, window count) of every row: the blocks of G stream
    positions that overlap [lo, hi).  Empty rows have no window."""
    lo, hi = row_lo.long(), row_hi.long()
    first = lo // chunk
    count = torch.where(hi > lo, (hi - 1) // chunk - first + 1, 0)
    return first, count


def row_order(row_lo: torch.Tensor, row_hi: torch.Tensor) -> torch.Tensor:
    """int32 permutation of the rows, longest segment first (ties in row
    order): the order in which the kernels' CTAs take their rows.  On the
    device, without a host sync."""
    return torch.argsort(row_hi - row_lo, descending=True, stable=True).to(torch.int32)


def slot_boxes(payload: torch.Tensor, ox, oy, statics: CompositeStatics) -> torch.Tensor:
    """Pixel box of each slot on its tile, as the kernels compute it
    (`slot_box` in csrc/tile_boxes.cuh), in float64.

    payload [..., 16] rows; ox, oy the origins of the tiles they are
    composited on (broadcast against [...]).  Returns int64 [..., 4]:
    (x0, x1, y0, y1), inclusive tile-local bounds outside which the slot's
    alpha is below alpha_threshold, so 0.  With Q = -power = 1/2 d^T C d,
    alpha >= threshold needs Q <= L = ln(opa / threshold): an ellipse of
    half-widths sqrt(2 L cyy / det) and sqrt(2 L cxx / det).  Float32
    evaluation of Q errs by a few roundings of cxx dx^2 + cyy dy^2 <=
    2 Q / (1 - rho), rho = |cxy| / sqrt(cxx cyy); L is raised by 64 of them
    and by the exp's and the product's, and the box padded by a pixel.
    `EMPTY_BOX` where opa or alpha_clip is under the threshold or the box
    misses the tile; the whole tile where the conic is not positive
    definite (power > 0 then gives alpha = opa), too close to singular for
    the rounding bound, or anything is not finite.  A colour that is not
    finite gives the whole tile whatever the opacity: c * 0 is NaN, so the
    blend changes every pixel.
    """
    f32 = torch.float32
    d = payload.double()
    mx, my = d[..., binning.COL_MX], d[..., binning.COL_MY]
    cxx, cxy, cyy = d[..., binning.COL_CXX], d[..., binning.COL_CXY], d[..., binning.COL_CYY]
    opa = payload[..., binning.COL_OPA]
    thr = torch.tensor(statics.alpha_threshold, dtype=f32)
    clip = torch.tensor(statics.alpha_clip, dtype=f32)
    det = cxx * cyy - cxy * cxy
    s = det / (cxx * cyy)  # 1 - rho^2
    slack = 64.0 * 2.0**-23 / (s / (1.0 + torch.sqrt(1.0 - s)))
    big_l = (torch.log(opa.double() / float(thr)) * (1.0 + 1e-6) + 1e-6) / (1.0 - slack)
    ex, ey = torch.sqrt(2.0 * big_l * cyy / det), torch.sqrt(2.0 * big_l * cxx / det)
    cx = mx - torch.as_tensor(ox, dtype=torch.float64) - 0.5
    cy = my - torch.as_tensor(oy, dtype=torch.float64) - 0.5
    rx = ex + 1.0 + 1e-6 * (ex + cx.abs())
    ry = ey + 1.0 + 1e-6 * (ey + cy.abs())
    whole = (~(thr > 0) | ~(cxx > 0) | ~(det > 0) | ~(slack <= 0.5)
             | ~(cx.isfinite() & cy.isfinite() & rx.isfinite() & ry.isfinite()))
    box = torch.stack([
        torch.ceil(cx - rx).clamp(min=0), torch.floor(cx + rx).clamp(max=statics.tile_w - 1),
        torch.ceil(cy - ry).clamp(min=0), torch.floor(cy + ry).clamp(max=statics.tile_h - 1),
    ], dim=-1)
    below = (opa < thr) | (clip < thr)
    box = torch.where((below | whole)[..., None], 0.0, box).long()  # no NaN cast
    missed = (box[..., 0] > box[..., 1]) | (box[..., 2] > box[..., 3])
    whole_box = torch.tensor([0, statics.tile_w - 1, 0, statics.tile_h - 1])
    empty_box = torch.tensor(EMPTY_BOX)
    box = torch.where(whole[..., None], whole_box, torch.where(missed[..., None], empty_box, box))
    box = torch.where(below[..., None], empty_box, box)
    colour = payload[..., binning.COL_R:binning.COL_ONE + 1].isfinite().all(-1)
    return torch.where(colour[..., None], box, whole_box)


def _slot_boxes_cuda(payload, ox, oy, statics: CompositeStatics) -> torch.Tensor:
    """The kernels' own boxes of the slots payload [n, 16] on the tiles at
    origins ox, oy ([n] int32), launched alone: int64 [n, 4] (x0, x1, y0,
    y1), to hold against `slot_boxes`."""
    n = payload.shape[0]
    out = torch.empty((n, 4), dtype=torch.int16, device=payload.device)
    BOX_KERNEL(
        payload.contiguous().data_ptr(), ox.contiguous().data_ptr(), oy.contiguous().data_ptr(),
        out.data_ptr(), n, statics.tile_h, statics.tile_w, statics.alpha_clip,
        statics.alpha_threshold, torch.cuda.current_stream(payload.device).cuda_stream,
    )
    return out.long()


def _check(stream_payload, row_lo, row_hi, statics: CompositeStatics):
    if stream_payload.dim() != 2 or stream_payload.shape[1] != binning.PAYLOAD_DIM:
        raise ValueError(f"stream must be [M, 16], got {tuple(stream_payload.shape)}")
    if stream_payload.dtype != torch.float32:
        raise TypeError(f"stream must be float32, got {stream_payload.dtype}")
    if stream_payload.shape[0] % statics.chunk:
        raise ValueError("stream length must be a multiple of the chunk size")
    for name, b in (("row_lo", row_lo), ("row_hi", row_hi)):
        if b.dtype != torch.int32 or b.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
        if b.device != stream_payload.device:
            raise ValueError(f"{name} is on {b.device}, stream on {stream_payload.device}")
    if row_lo.shape != row_hi.shape:
        raise ValueError("row_lo and row_hi differ in shape")


def _kernel_args(statics: CompositeStatics, device):
    """The trailing arguments both kernels share."""
    return (
        statics.tile_h * statics.tile_w, statics.tile_h, statics.tile_w, statics.ntx,
        statics.ntx * statics.nty, statics.chunk,
        statics.alpha_clip, statics.alpha_threshold, statics.transmittance_eps,
        torch.cuda.current_stream(device).cuda_stream,
    )


def _forward_cuda(stream_payload, row_lo, row_hi, order, statics: CompositeStatics):
    """Launch kernel B1; its CTAs take the rows in `order` (`row_order`)."""
    p = statics.tile_h * statics.tile_w
    if p > MAX_TILE_PIXELS:
        raise ValueError(f"tile of {p} pixels exceeds the kernel's {MAX_TILE_PIXELS}")
    if not (stream_payload.is_contiguous() and row_lo.is_contiguous()
            and row_hi.is_contiguous()):
        raise ValueError("composite_stream takes contiguous tensors")
    m = stream_payload.shape[0]
    r = row_lo.shape[0]
    if r and bool(((row_lo < 0) | (row_hi > m) | (row_hi < row_lo)).any()):
        raise ValueError("row bounds outside the stream")
    out = torch.empty((r + 1, 4, p), dtype=torch.float32, device=stream_payload.device)
    out[r].zero_()
    FWD_KERNEL(
        stream_payload.data_ptr(), row_lo.data_ptr(), row_hi.data_ptr(), order.data_ptr(),
        out.data_ptr(), r, *_kernel_args(statics, stream_payload.device),
    )
    return out


def _backward_cuda(stream_payload, row_lo, row_hi, order, out4, g4,
                   statics: CompositeStatics):
    """Launch kernel B2 on inputs the forward already checked, its CTAs
    taking the rows in the forward's `order`."""
    r = row_lo.shape[0]
    if g4.shape != out4.shape or g4.dtype != torch.float32:
        raise ValueError(f"gradient {tuple(g4.shape)} {g4.dtype} does not match the "
                         f"output {tuple(out4.shape)}")
    g4 = g4.contiguous()
    d_stream = torch.zeros_like(stream_payload)
    BWD_KERNEL(
        stream_payload.data_ptr(), row_lo.data_ptr(), row_hi.data_ptr(), order.data_ptr(),
        out4.data_ptr(), g4.data_ptr(), d_stream.data_ptr(), r,
        *_kernel_args(statics, stream_payload.device),
    )
    return d_stream


class _CompositeStream(torch.autograd.Function):
    """Forward kernel B1 and backward kernel B2 (their plain versions on
    CPU tensors) as one differentiable function of the stream."""

    @staticmethod
    def forward(ctx, stream_payload, row_lo, row_hi, statics):
        ctx.statics = statics
        if stream_payload.device.type == "cpu":
            out = composite_stream_reference(stream_payload, row_lo, row_hi, statics)
            ctx.save_for_backward(stream_payload, row_lo, row_hi, out)
            return out
        order = row_order(row_lo, row_hi)
        out = _forward_cuda(stream_payload, row_lo, row_hi, order, statics)
        ctx.save_for_backward(stream_payload, row_lo, row_hi, out, order)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g4):
        saved = ctx.saved_tensors
        if saved[0].device.type == "cpu":
            stream_payload, row_lo, row_hi, out4 = saved
            d = composite_stream_backward_reference(stream_payload, row_lo, row_hi, out4, g4,
                                                    ctx.statics)
        else:
            stream_payload, row_lo, row_hi, out4, order = saved
            d = _backward_cuda(stream_payload, row_lo, row_hi, order, out4, g4, ctx.statics)
        return d, None, None, None


def composite_stream(
    stream_payload: torch.Tensor,  # [M, 16] depth-sorted payload stream
    row_lo: torch.Tensor,  # [R] int32 segment start of every output row
    row_hi: torch.Tensor,  # [R] int32 segment end
    statics: CompositeStatics,
) -> torch.Tensor:
    """Depth-sorted payload stream -> [R + 1, 4, P] tile composites (RGB +
    accumulated alpha); the last row is the all-zero sentinel row.
    Differentiable in `stream_payload`."""
    _check(stream_payload, row_lo, row_hi, statics)
    if stream_payload.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no compositor for device {stream_payload.device}")
    return _CompositeStream.apply(stream_payload, row_lo, row_hi, statics)


def composite_stream_reference(
    stream_payload: torch.Tensor,
    row_lo: torch.Tensor,
    row_hi: torch.Tensor,
    statics: CompositeStatics,
    return_work: bool = False,
):
    """Plain PyTorch version of `composite_stream` on any device.

    Rows go in batches of `_REFERENCE_ROW_BATCH` (bounding the [rows, G, P]
    intermediates); within a batch, window k of every row that still has
    one and whose tile has a pixel with T >= eps is composited with
    composite._chunk_fwd.  Slots of a window outside the row's segment get
    zero opacity, which zeroes their alpha exactly as the TPU kernel's
    mask does.

    With `return_work`, also returns a `CompositeWork`: the slots and
    (slot, pixel) pairs this input needed, and the pixels at a threshold
    tie (composite.chunk_work).
    """
    g = statics.chunk
    p = statics.tile_h * statics.tile_w
    dev = stream_payload.device
    r = row_lo.shape[0]
    out = torch.zeros((r + 1, 4, p), dtype=torch.float32, device=dev)
    first, count = row_windows(row_lo, row_hi, g)
    lo, hi = row_lo.long(), row_hi.long()
    offs = torch.arange(g, device=dev)
    slots = torch.zeros((), dtype=torch.int64, device=dev)
    touched = torch.zeros((), dtype=torch.int64, device=dev)
    tie_pixels = torch.zeros((r + 1, p), dtype=torch.bool, device=dev)
    for start in range(0, r, _REFERENCE_ROW_BATCH):
        rows = torch.arange(start, min(start + _REFERENCE_ROW_BATCH, r), device=dev)
        ox, oy = tile_origin(rows, statics)
        px, py = pixel_coords(ox, oy, statics.tile_h, statics.tile_w)
        t = torch.ones((rows.shape[0], 1, p), dtype=torch.float32, device=dev)
        acc = torch.zeros((rows.shape[0], 4, p), dtype=torch.float32, device=dev)
        for k in range(int(count[rows].max())):
            live = (count[rows] > k) & (t.amax(dim=(1, 2)) >= statics.transmittance_eps)
            sel = live.nonzero()[:, 0]
            if sel.numel() == 0:
                break
            row = rows[sel]
            pos = (first[row] + k)[:, None] * g + offs  # [s, G]
            in_seg = (pos >= lo[row, None]) & (pos < hi[row, None])
            chunk = stream_payload[pos]  # [s, G, 16], a fresh copy
            chunk[..., binning.COL_OPA] = torch.where(
                in_seg, chunk[..., binning.COL_OPA], 0.0
            )
            contrib, t_out = _chunk_fwd(
                chunk, px[sel], py[sel], t[sel], statics.alpha_clip,
                statics.alpha_threshold,
            )
            acc[sel] += contrib
            t[sel] = t_out
            if return_work:
                slots += in_seg.sum()
                pairs, ties = chunk_work(chunk, px[sel], py[sel], in_seg, statics)
                touched += pairs
                tie_pixels[row] |= ties
        out[rows] = acc
    if return_work:
        return out, CompositeWork(int(slots), int(touched), tie_pixels)
    return out


def composite_stream_backward_reference(
    stream_payload: torch.Tensor,
    row_lo: torch.Tensor,
    row_hi: torch.Tensor,
    out4: torch.Tensor,  # [R + 1, 4, P] the forward's output
    g4: torch.Tensor,  # [R + 1, 4, P] its upstream gradient
    statics: CompositeStatics,
) -> torch.Tensor:
    """Plain PyTorch version of the backward on any device: d_stream
    [M, 16], the gradient of every stream slot.

    It walks `composite_stream_reference`'s window schedule with the same
    skip vote on the recomputed T, carrying per pixel T and the scalar
    suffix term r through composite._chunk_bwd.  Slots of a window outside
    the row's segment get zero opacity and their gradient rows are not
    written, so slots no row owns and windows the early stop skipped stay
    zero, as in the TPU kernel.
    """
    g = statics.chunk
    p = statics.tile_h * statics.tile_w
    dev = stream_payload.device
    r = row_lo.shape[0]
    d_stream = torch.zeros_like(stream_payload)
    first, count = row_windows(row_lo, row_hi, g)
    lo, hi = row_lo.long(), row_hi.long()
    offs = torch.arange(g, device=dev)
    for start in range(0, r, _REFERENCE_BWD_ROW_BATCH):
        rows = torch.arange(start, min(start + _REFERENCE_BWD_ROW_BATCH, r), device=dev)
        ox, oy = tile_origin(rows, statics)
        px, py = pixel_coords(ox, oy, statics.tile_h, statics.tile_w)
        g4_rows = g4[rows]
        tot_dot = (out4[rows] * g4_rows).sum(1, keepdim=True)  # [b, 1, P]
        t = torch.ones((rows.shape[0], 1, p), dtype=torch.float32, device=dev)
        r_carry = torch.zeros_like(t)
        for k in range(int(count[rows].max())):
            live = (count[rows] > k) & (t.amax(dim=(1, 2)) >= statics.transmittance_eps)
            sel = live.nonzero()[:, 0]
            if sel.numel() == 0:
                break
            row = rows[sel]
            pos = (first[row] + k)[:, None] * g + offs  # [s, G]
            in_seg = (pos >= lo[row, None]) & (pos < hi[row, None])
            chunk = stream_payload[pos]  # [s, G, 16], a fresh copy
            chunk[..., binning.COL_OPA] = torch.where(
                in_seg, chunk[..., binning.COL_OPA], 0.0
            )
            d_chunk, t_out, r_out = _chunk_bwd(
                chunk, px[sel], py[sel], t[sel], r_carry[sel], tot_dot[sel],
                g4_rows[sel], statics.alpha_clip, statics.alpha_threshold,
            )
            # every slot belongs to one row: a plain indexed store
            d_stream[pos[in_seg]] = d_chunk[in_seg]
            t[sel] = t_out
            r_carry[sel] = r_out
    return d_stream
