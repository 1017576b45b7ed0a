"""Launchers of the dense per-tile compositor kernels, forward and backward.

Counterpart of casualhdrsplat_tpu/ops/rasterize_pallas.py (`forward`,
`backward` and their Pallas kernels `_fwd_kernel` and `_bwd_kernel`); named
for what it composites, the dense [tiles, capacity, 16] payload table,
since the port's kernels are CUDA C++ (csrc/rasterize_dense_fwd.cu,
csrc/rasterize_dense_bwd.cu), not Pallas.

Tile i composites its own depth-ordered list gathered[i] front to back
over its pixels, in chunks of G = chunk slots: only the ceil(counts[i] /
G) occupied chunks, and none once no pixel of the tile has transmittance
>= eps.  The tile's pixel origin comes from tile_indices[i] %
tiles_per_view, not from its position in the table, so a caller may pass
a slice of the tiles.  The backward rebuilds T over the same chunks and
writes the gradient of every table slot, zero where nothing was visited.

`forward` and `backward` take CUDA tensors and launch the kernels; the
differentiable entry point, its dispatch and the plain PyTorch versions
are in ops/composite.py (`composite_tiles`).
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
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float] * 3
    + [ctypes.c_void_p],
)
BWD_KERNEL = CudaKernel(
    "rasterize_dense_bwd.cu",
    "chs_rasterize_dense_bwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float] * 3
    + [ctypes.c_void_p],
)


def check(gathered, tile_indices, counts, statics: CompositeStatics) -> None:
    """Shapes, types and devices `composite_tiles` takes, on any device."""
    if gathered.dim() != 3 or gathered.shape[2] != binning.PAYLOAD_DIM:
        raise ValueError(f"table must be [tiles, capacity, 16], got {tuple(gathered.shape)}")
    if gathered.dtype != torch.float32:
        raise TypeError(f"table must be float32, got {gathered.dtype}")
    if gathered.shape[1] % statics.chunk:
        raise ValueError(
            f"capacity {gathered.shape[1]} must be a multiple of chunk {statics.chunk}")
    if gathered.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no compositor for device {gathered.device}")
    for name, b in (("tile_indices", tile_indices), ("counts", counts)):
        if b.dtype != torch.int32 or b.shape != gathered.shape[:1]:
            raise TypeError(f"{name} must be an int32 tensor of shape [tiles]")
        if b.device != gathered.device:
            raise ValueError(f"{name} is on {b.device}, the table on {gathered.device}")


def _kernel_args(gathered, statics: CompositeStatics):
    """The trailing arguments both kernels share."""
    return (
        gathered.shape[0], gathered.shape[1],
        statics.tile_h * statics.tile_w, statics.tile_h, statics.tile_w, statics.ntx,
        statics.tiles_per_view or statics.ntx * statics.nty, statics.chunk,
        statics.alpha_clip, statics.alpha_threshold, statics.transmittance_eps,
        torch.cuda.current_stream(gathered.device).cuda_stream,
    )


def forward(gathered, tile_indices, counts, statics: CompositeStatics) -> torch.Tensor:
    """Launch kernel B3: [tt, capacity, 16] -> [tt, 4, P]."""
    check(gathered, tile_indices, counts, statics)  # pointers go to the kernel
    tt, cap, _ = gathered.shape
    p = statics.tile_h * statics.tile_w
    if p > MAX_TILE_PIXELS:
        raise ValueError(f"tile of {p} pixels exceeds the kernel's {MAX_TILE_PIXELS}")
    if not (gathered.is_contiguous() and tile_indices.is_contiguous()
            and counts.is_contiguous()):
        raise ValueError("composite_tiles takes contiguous tensors")
    if tt and bool(((counts < 0) | (counts > cap)).any()):
        raise ValueError("counts outside [0, capacity]")
    out = torch.empty((tt, 4, p), dtype=torch.float32, device=gathered.device)
    FWD_KERNEL(
        gathered.data_ptr(), tile_indices.data_ptr(), counts.data_ptr(),
        out.data_ptr(), *_kernel_args(gathered, statics),
    )
    return out


def backward(gathered, tile_indices, counts, out4, g4,
             statics: CompositeStatics) -> torch.Tensor:
    """Launch kernel B4 on inputs the forward already checked: the gradient
    [tt, capacity, 16] of the table, every row of it written by the kernel."""
    if g4.shape != out4.shape or g4.dtype != torch.float32:
        raise ValueError(f"gradient {tuple(g4.shape)} {g4.dtype} does not match the "
                         f"output {tuple(out4.shape)}")
    g4 = g4.contiguous()
    d_gathered = torch.empty_like(gathered)
    BWD_KERNEL(
        gathered.data_ptr(), tile_indices.data_ptr(), counts.data_ptr(),
        out4.data_ptr(), g4.data_ptr(), d_gathered.data_ptr(),
        *_kernel_args(gathered, statics),
    )
    return d_gathered
