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
  backward csrc/rasterize_packed_bwd.cu (or they raise);
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
from typing import NamedTuple

import torch

from casualhdrsplat_torch.ops import binning
from casualhdrsplat_torch.ops.composite import (
    CompositeStatics,
    _alpha_terms,
    _chunk_bwd,
    _chunk_fwd,
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
# Float32 roundings by which two evaluations of one alpha may differ (the
# products and sums of the exponent, the exp, the opacity product).
_TIE_ULPS = 8
_EPS32 = 2.0 ** -23

FWD_KERNEL = CudaKernel(
    "rasterize_packed_fwd.cu",
    "chs_rasterize_packed_fwd",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float] * 3
    + [ctypes.c_void_p],
)
BWD_KERNEL = CudaKernel(
    "rasterize_packed_bwd.cu",
    "chs_rasterize_packed_bwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float] * 3
    + [ctypes.c_void_p],
)


class CompositeWork(NamedTuple):
    """What one input asked of the compositor (`composite_stream_reference`
    with `return_work`)."""

    # in-segment stream slots in the windows that were composited: each has
    # its alpha evaluated at all P pixels of its tile
    slots: int
    # (slot, pixel) pairs of those with alpha >= alpha_threshold: only they
    # blend, and only they carry a gradient
    touched: int
    # [R + 1, P] bool: pixels where some slot's alpha lies within float32
    # rounding of alpha_threshold.  The function jumps there, so two correct
    # evaluations may take different sides.
    tie_pixels: torch.Tensor


def row_windows(row_lo: torch.Tensor, row_hi: torch.Tensor, chunk: int):
    """(first block, window count) of every row: the blocks of G stream
    positions that overlap [lo, hi).  Empty rows have no window."""
    lo, hi = row_lo.long(), row_hi.long()
    first = lo // chunk
    count = torch.where(hi > lo, (hi - 1) // chunk - first + 1, 0)
    return first, count


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


def _forward_cuda(stream_payload, row_lo, row_hi, statics: CompositeStatics):
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
        stream_payload.data_ptr(), row_lo.data_ptr(), row_hi.data_ptr(),
        out.data_ptr(), r, *_kernel_args(statics, stream_payload.device),
    )
    return out


def _backward_cuda(stream_payload, row_lo, row_hi, out4, g4, statics: CompositeStatics):
    """Launch kernel B2 on inputs the forward already checked."""
    r = row_lo.shape[0]
    if g4.shape != out4.shape or g4.dtype != torch.float32:
        raise ValueError(f"gradient {tuple(g4.shape)} {g4.dtype} does not match the "
                         f"output {tuple(out4.shape)}")
    g4 = g4.contiguous()
    d_stream = torch.zeros_like(stream_payload)
    BWD_KERNEL(
        stream_payload.data_ptr(), row_lo.data_ptr(), row_hi.data_ptr(),
        out4.data_ptr(), g4.data_ptr(), d_stream.data_ptr(), r,
        *_kernel_args(statics, stream_payload.device),
    )
    return d_stream


class _CompositeStream(torch.autograd.Function):
    """Forward kernel B1 and backward kernel B2 (their plain versions on
    CPU tensors) as one differentiable function of the stream."""

    @staticmethod
    def forward(ctx, stream_payload, row_lo, row_hi, statics):
        if stream_payload.device.type == "cpu":
            out = composite_stream_reference(stream_payload, row_lo, row_hi, statics)
        else:
            out = _forward_cuda(stream_payload, row_lo, row_hi, statics)
        ctx.statics = statics
        ctx.save_for_backward(stream_payload, row_lo, row_hi, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g4):
        stream_payload, row_lo, row_hi, out4 = ctx.saved_tensors
        backward = (composite_stream_backward_reference
                    if stream_payload.device.type == "cpu" else _backward_cuda)
        return backward(stream_payload, row_lo, row_hi, out4, g4, ctx.statics), None, None, None


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
    tie.  A tie is |alpha - threshold| <= `_TIE_ULPS` float32 roundings of
    the threshold, each scaled by 1 + the sum of the magnitudes of the
    exponent's terms (the rounding of a cancelling sum grows with them).
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
                alpha, alpha_raw, _, dx, dy, (cxx, cxy, cyy) = _alpha_terms(
                    chunk, px[sel], py[sel], statics.alpha_clip, statics.alpha_threshold)
                touched += (alpha > 0.0).sum()
                terms = 0.5 * (cxx.abs() * dx * dx + cyy.abs() * dy * dy) + (cxy * dx * dy).abs()
                slack = _TIE_ULPS * _EPS32 * statics.alpha_threshold * (1.0 + terms)
                near = (alpha_raw.clamp(max=statics.alpha_clip)
                        - statics.alpha_threshold).abs() <= slack
                tie_pixels[row] |= (near & in_seg[..., None]).any(dim=1)
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
