"""Streaming compositor over the depth-sorted intersection stream, forward.

Counterpart of casualhdrsplat_tpu/ops/rasterize_packed.py (`forward` and
its Pallas kernel `_fwd_kernel`).  Binning produces one depth-sorted
payload stream [M, 16]; output row r (tile t of view v) owns the stream
segment [row_lo[r], row_hi[r]) and composites it front to back in windows
of G = chunk stream positions aligned to multiples of G.  A row stops at
the first window where no pixel of its tile has transmittance >= eps.

- On a CUDA tensor `composite_stream` launches the hand-written kernel
  csrc/rasterize_packed_fwd.cu (or raises).
- On a CPU tensor it runs `composite_stream_reference`, the plain PyTorch
  version: the same window schedule, batched over rows, with the chunk
  math of ops/composite.py.

The TPU kernel walks a flat chunk schedule (binning.pack_stream_chunks)
and packs its per-chunk words for SMEM; the port passes each row's
(lo, hi) instead and derives the same windows from them
(`row_windows`).  The backward kernel is not ported yet (ROADMAP.md,
queue B, B2): a CUDA call that needs a gradient raises.
"""

from __future__ import annotations

import ctypes

import torch

from casualhdrsplat_torch.ops import binning
from casualhdrsplat_torch.ops.composite import (
    CompositeStatics,
    _chunk_fwd,
    pixel_coords,
    tile_origin,
)
from casualhdrsplat_torch.ops.cuda_build import CudaKernel

# Most pixels a tile may have: the kernel gives each of its 256 threads at
# most 16 pixels.
MAX_TILE_PIXELS = 4096
# Rows the plain version composites at once: 512 rows of 16x128 tiles at
# G = 128 make [512, 128, 2048] float32 intermediates of 512 MiB each.
_REFERENCE_ROW_BATCH = 512

FWD_KERNEL = CudaKernel(
    "rasterize_packed_fwd.cu",
    "chs_rasterize_packed_fwd",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float] * 3
    + [ctypes.c_void_p],
)


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


def composite_stream(
    stream_payload: torch.Tensor,  # [M, 16] depth-sorted payload stream
    row_lo: torch.Tensor,  # [R] int32 segment start of every output row
    row_hi: torch.Tensor,  # [R] int32 segment end
    statics: CompositeStatics,
) -> torch.Tensor:
    """Depth-sorted payload stream -> [R + 1, 4, P] tile composites (RGB +
    accumulated alpha); the last row is the all-zero sentinel row."""
    _check(stream_payload, row_lo, row_hi, statics)
    if stream_payload.device.type == "cpu":
        return composite_stream_reference(stream_payload, row_lo, row_hi, statics)
    if stream_payload.device.type != "cuda":
        raise ValueError(f"no compositor for device {stream_payload.device}")
    if torch.is_grad_enabled() and stream_payload.requires_grad:
        raise NotImplementedError(
            "backward kernel B2 not yet ported (ROADMAP.md, queue B); "
            "render under torch.inference_mode()"
        )
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
        out.data_ptr(), r, p, statics.tile_h, statics.tile_w, statics.ntx,
        statics.ntx * statics.nty, statics.chunk,
        statics.alpha_clip, statics.alpha_threshold, statics.transmittance_eps,
        torch.cuda.current_stream(stream_payload.device).cuda_stream,
    )
    return out


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

    With `return_work`, also returns the number of in-segment stream slots
    in the windows that were composited: the intersections this input
    needed, each evaluated at all P pixels of its tile.
    """
    g = statics.chunk
    p = statics.tile_h * statics.tile_w
    dev = stream_payload.device
    r = row_lo.shape[0]
    out = torch.zeros((r + 1, 4, p), dtype=torch.float32, device=dev)
    first, count = row_windows(row_lo, row_hi, g)
    lo, hi = row_lo.long(), row_hi.long()
    offs = torch.arange(g, device=dev)
    work = torch.zeros((), dtype=torch.int64, device=dev)
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
            work += in_seg.sum()
        out[rows] = acc
    if return_work:
        return out, int(work)
    return out
