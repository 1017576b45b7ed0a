"""Launchers of the dense per-tile compositor kernels, forward and backward.

Counterpart of casualhdrsplat_tpu/ops/rasterize_pallas.py (`forward`,
`backward` and their Pallas kernels `_fwd_kernel` and `_bwd_kernel`); named
for what it composites, the dense [tiles, capacity] lists, since the port's
kernels are CUDA C++ (csrc/rasterize_dense_fwd.cu,
csrc/rasterize_dense_bwd.cu), not Pallas.

Tile i composites its own depth-ordered list front to back over its
pixels, in chunks of G = chunk slots: only the ceil(counts[i] / G)
occupied chunks, and none once no pixel of the tile has transmittance
>= eps.  The tile's pixel origin comes from tile_indices[i] %
tiles_per_view, not from its position in the launch, so a caller may pass
a slice of the tiles.  A list comes in one of two forms:
- the list form (`ids` given): `rows` is the flattened payload
  [V (N + 1), 16] of V = statics.num_views views and `ids` the id table
  [tiles, capacity] int32 (binning.assign_tiles_arrays); slot k of tile i
  is row (tile_indices[i] // tiles_per_view) (N + 1) + ids[i, k];
- the table form (`ids` None): `rows` is a gathered table
  [tiles, capacity, 16] (binning.gather_payload), slot k of tile i its
  row [i, k].
The backward rebuilds T over the same chunks and adds every visited
slot's gradient into a zeroed gradient laid out as `rows`.

`forward` and `backward` take CUDA tensors and launch the kernels; the
differentiable entry points, their dispatch and the plain PyTorch versions
are in ops/composite.py (`composite_tile_lists`, `composite_tiles`).
"""

from __future__ import annotations

import ctypes

import torch

from casualhdrsplat_torch.ops import binning
from casualhdrsplat_torch.ops.composite import CompositeStatics
from casualhdrsplat_torch.ops.cuda_build import CudaKernel

# Most pixels a tile may have: the forward kernel gives each of its 256
# threads at most 16 pixels, the backward each of its 512 at most 8.
MAX_TILE_PIXELS = 4096

FWD_KERNEL = CudaKernel(
    "rasterize_dense_fwd.cu",
    "chs_rasterize_dense_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float] * 3
    + [ctypes.c_void_p],
)
BWD_KERNEL = CudaKernel(
    "rasterize_dense_bwd.cu",
    "chs_rasterize_dense_bwd",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_float] * 3
    + [ctypes.c_void_p],
)


def _check_device(t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no compositor for device {t.device}")


def _check_tiles(tt: int, device, tile_indices, counts) -> None:
    for name, b in (("tile_indices", tile_indices), ("counts", counts)):
        if b.dtype != torch.int32 or b.shape != (tt,):
            raise TypeError(f"{name} must be an int32 tensor of shape [tiles]")
        if b.device != device:
            raise ValueError(f"{name} is on {b.device}, the lists on {device}")


def check(gathered, tile_indices, counts, statics: CompositeStatics) -> None:
    """Shapes, types and devices `composite_tiles` takes, on any device."""
    if gathered.dim() != 3 or gathered.shape[2] != binning.PAYLOAD_DIM:
        raise ValueError(f"table must be [tiles, capacity, 16], got {tuple(gathered.shape)}")
    if gathered.dtype != torch.float32:
        raise TypeError(f"table must be float32, got {gathered.dtype}")
    if gathered.shape[1] % statics.chunk:
        raise ValueError(
            f"capacity {gathered.shape[1]} must be a multiple of chunk {statics.chunk}")
    _check_device(gathered)
    _check_tiles(gathered.shape[0], gathered.device, tile_indices, counts)


def check_lists(rows, ids, tile_indices, counts, statics: CompositeStatics) -> None:
    """Shapes, types and devices `composite_tile_lists` takes, on any
    device.  The values of ids and tile_indices are not read here (that
    would wait for the device): the kernels and the plain versions take a
    slot whose id lies outside [0, N + 1) as an empty slot, and a tile
    whose view (tile_indices[i] // tiles_per_view) lies outside
    [0, num_views) as an empty list."""
    if rows.dim() != 2 or rows.shape[1] != binning.PAYLOAD_DIM:
        raise ValueError(f"rows must be [views * (N + 1), 16], got {tuple(rows.shape)}")
    if rows.dtype != torch.float32:
        raise TypeError(f"rows must be float32, got {rows.dtype}")
    if rows.shape[0] % statics.num_views or rows.shape[0] == 0:
        raise ValueError(f"{rows.shape[0]} rows do not split into {statics.num_views} views")
    if ids.dim() != 2 or ids.dtype != torch.int32:
        raise TypeError("ids must be an int32 tensor of shape [tiles, capacity]")
    if ids.shape[1] % statics.chunk:
        raise ValueError(f"capacity {ids.shape[1]} must be a multiple of chunk {statics.chunk}")
    _check_device(rows)
    if ids.device != rows.device:
        raise ValueError(f"ids are on {ids.device}, the rows on {rows.device}")
    _check_tiles(ids.shape[0], rows.device, tile_indices, counts)


def _kernel_args(tt: int, cap: int, view_rows: int, statics: CompositeStatics, device):
    """The trailing arguments both kernels share."""
    return (
        tt, cap, view_rows, statics.num_views,
        statics.tile_h * statics.tile_w, statics.tile_h, statics.tile_w, statics.ntx,
        statics.tiles_per_view or statics.ntx * statics.nty, statics.chunk,
        statics.alpha_clip, statics.alpha_threshold, statics.transmittance_eps,
        torch.cuda.current_stream(device).cuda_stream,
    )


def _form(rows, ids, statics: CompositeStatics):
    """(tiles, capacity, rows of a view; 0 for the table form)."""
    if ids is None:
        return rows.shape[0], rows.shape[1], 0
    return ids.shape[0], ids.shape[1], rows.shape[0] // statics.num_views


def forward(rows, tile_indices, counts, statics: CompositeStatics, ids=None) -> torch.Tensor:
    """Launch kernel B3: the lists (table form [tt, capacity, 16], or list
    form: rows [V (N + 1), 16] through `ids` [tt, capacity]) ->
    [tt, 4, P].  The table form's counts come from the caller and are
    checked to lie in [0, capacity]; the list form's come from binning,
    clamped there (the kernel clamps them too), and are not read here."""
    if ids is None:
        check(rows, tile_indices, counts, statics)  # pointers go to the kernel
    else:
        check_lists(rows, ids, tile_indices, counts, statics)
    tt, cap, view_rows = _form(rows, ids, statics)
    p = statics.tile_h * statics.tile_w
    if p > MAX_TILE_PIXELS:
        raise ValueError(f"tile of {p} pixels exceeds the kernel's {MAX_TILE_PIXELS}")
    tensors = (rows, tile_indices, counts) + (() if ids is None else (ids,))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the dense compositor takes contiguous tensors")
    if rows.data_ptr() % 16:
        raise ValueError("the payload rows must be 16-byte aligned")
    if ids is None and tt and bool(((counts < 0) | (counts > cap)).any()):
        raise ValueError("counts outside [0, capacity]")
    out = torch.empty((tt, 4, p), dtype=torch.float32, device=rows.device)
    FWD_KERNEL(
        rows.data_ptr(), None if ids is None else ids.data_ptr(), tile_indices.data_ptr(),
        counts.data_ptr(), out.data_ptr(), *_kernel_args(tt, cap, view_rows, statics,
                                                         rows.device),
    )
    return out


def backward(rows, tile_indices, counts, out4, g4, statics: CompositeStatics,
             ids=None) -> torch.Tensor:
    """Launch kernel B4 on inputs the forward already checked: the gradient
    of `rows`, zeroed here and added into by the kernel (the pad row and
    every row no tile reads stay zero)."""
    if g4.shape != out4.shape or g4.dtype != torch.float32:
        raise ValueError(f"gradient {tuple(g4.shape)} {g4.dtype} does not match the "
                         f"output {tuple(out4.shape)}")
    g4 = g4.contiguous()
    tt, cap, view_rows = _form(rows, ids, statics)
    d_rows = torch.zeros_like(rows)
    BWD_KERNEL(
        rows.data_ptr(), None if ids is None else ids.data_ptr(), tile_indices.data_ptr(),
        counts.data_ptr(), out4.data_ptr(), g4.data_ptr(), d_rows.data_ptr(),
        *_kernel_args(tt, cap, view_rows, statics, rows.device),
    )
    return d_rows
