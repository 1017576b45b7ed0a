"""The packed stream gather, payload rows in stream order, with its
transpose as kernel G1 (CUDA C++ for sm_90a: csrc/stream_gather_bwd.cu).

Counterpart of the row gather `payload[stream_ids]` in
casualhdrsplat_tpu/ops/rasterize.py (:192 per view, :310 with shared
binning under vmap) and `padded[ids_one]` in
casualhdrsplat_tpu/parallel/render.py:134.  The reference has no Pallas
kernel there: XLA emits the gather's transpose, which reduces the per-slot
gradients deterministically, with no atomics.  PyTorch's own backward of
a gather adds with float atomics on a card, in an order that changes from
run to run; this module's does not.

`gather_stream(payload [V, R, 16], ids)` returns the streams [V, S, 16]:
stream[v, s] = payload[v, ids[s]] with one id list for every view (`ids`
[S], shared binning) or payload[v, ids[v, s]] (`ids` [V, S], per-view
binning).  The ids are int32 in [0, R); R - 1 is the pad id, the zero row
the budget's unused tail names.

- Forward: a library gather (`torch.gather` of the shared ids expanded
  over the views, `index_select` of the per-view ones), deterministic.
  Without grad the function is that gather alone.
- Backward: d payload[v, r] = the sum over the slots s with ids[s] = r of
  d stream[v, s], for r < R - 1, over all 16 columns; the pad row gets
  zeros (its gradient is dropped by `binning.build_payload`'s cat in any
  case).
  - On CUDA tensors: `slot_index`, the inverse of the ids built by a
    counting pass (csrc/stream_gather_index.cu: a histogram,
    torch.cumsum's scan and a placement that is stable by construction;
    each real row's slots in increasing slot order, the pad row's left
    out; integer work with static shapes and no host read, so a CUDA
    graph holds it), then kernel G1, which adds each row's slots in that
    order, one fp32 add at a time, and stores each element once.  A failed
    build or launch raises.
  - On CPU tensors: `stream_gather_backward_reference`, the plain version:
    `index_add_`, which adds in index order on a CPU, so it gives the bits
    of the autograd transpose the port used before (scatter_add_ /
    index_add_), the pad row zeroed.
- `inverse_index` (a stable sort of the ids and a searchsorted) is the
  index's plain version and yardstick; no path on a card calls it.
  `slot_index_emulation` repeats the counting pass in PyTorch, with the
  bucketing order as an argument (the atomics' order changes from run to
  run); `stream_gather_backward_emulation` repeats G1's schedule on that
  index.  The tests hold the kernels and the plain version to them, to the
  bit.
"""

from __future__ import annotations

import ctypes

import torch

from casualhdrsplat_torch.ops.binning import PAYLOAD_DIM
from casualhdrsplat_torch.ops.cuda_build import CudaKernel

KERNEL = CudaKernel(
    "stream_gather_bwd.cu", "chs_stream_gather_bwd",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)
# The counting pass that builds G1's index, two calls of its library with a
# torch.cumsum between them: the histogram (not counted), then bucketing
# and placement, whose launch `INDEX` counts once per pass.
INDEX_COUNT = CudaKernel(
    "stream_gather_index.cu", "chs_stream_gather_index_count",
    [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3, counted=False,
)
INDEX = CudaKernel(
    "stream_gather_index.cu", "chs_stream_gather_index_place",
    [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4,
)


def _check(payload: torch.Tensor, ids: torch.Tensor) -> None:
    if payload.dim() != 3 or payload.shape[2] != PAYLOAD_DIM:
        raise ValueError(f"payload must be [V, R, 16], got {tuple(payload.shape)}")
    if payload.dtype != torch.float32:
        raise TypeError(f"payload must be float32, got {payload.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"stream ids must be int32, got {ids.dtype}")
    if ids.dim() not in (1, 2) or ids.dim() == 2 and ids.shape[0] != payload.shape[0]:
        raise ValueError(f"stream ids must be [S] or [V, S] with V = {payload.shape[0]}, "
                         f"got {tuple(ids.shape)}")
    if ids.device != payload.device:
        raise ValueError(f"stream ids are on {ids.device}, the payload on {payload.device}")
    if payload.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no stream gather for device {payload.device}")
    views, rows = payload.shape[:2]
    if views * rows >= 2**31 or views * ids.shape[-1] >= 2**31:
        raise ValueError("the stream gather takes fewer than 2^31 rows and slots")


def _keys(ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Flat int32 keys of the slots: the ids, or v R + ids per view."""
    if ids.dim() == 1:
        return ids
    v = ids.shape[0]
    return (ids + (torch.arange(v, dtype=torch.int32, device=ids.device)
                   * num_rows)[:, None]).reshape(-1)


def _gather(payload: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    v, rows = payload.shape[:2]
    if ids.dim() == 1:
        return torch.gather(payload, 1, ids.long()[None, :, None].expand(v, -1, PAYLOAD_DIM))
    flat = payload.reshape(v * rows, PAYLOAD_DIM).index_select(0, _keys(ids, rows))
    return flat.reshape(v, ids.shape[1], PAYLOAD_DIM)


def inverse_index(ids: torch.Tensor, num_rows: int):
    """The inverse of the stream ids: (offsets, slots), int32.

    Shared ids [S]: row r's slots are slots[offsets[r]:offsets[r + 1]],
    numbers s of the stream.  Per-view ids [V, S]: row r of view v's are
    slots[offsets[v R + r]:offsets[v R + r + 1]], flat numbers v S + s.
    Within a row they increase (a stable sort).  Static shapes, integer
    work, no host read."""
    keys = _keys(ids, num_rows)
    sorted_keys, perm = torch.sort(keys, stable=True)
    n_keys = num_rows * (1 if ids.dim() == 1 else ids.shape[0])
    bounds = torch.arange(n_keys + 1, dtype=torch.int32, device=ids.device)
    offsets = torch.searchsorted(sorted_keys, bounds, out_int32=True)
    return offsets, perm.to(torch.int32)


def slot_index_emulation(ids: torch.Tensor, num_rows: int, order=None):
    """The counting pass of csrc/stream_gather_index.cu in PyTorch, on any
    device: (offsets, slots) int32 of the kernel's shapes, each real row's
    slots in increasing order, the pad rows empty, slots[offsets[-1]:] -1.

    - Histogram of the keys of the slots that name a real row, and its
      exclusive scan: the offsets.
    - Bucketing: the slots are placed into their rows in the order `order`
      (a permutation of the flat slot numbers; by default increasing), as
      the kernel's atomics place them in an order that changes from run to
      run.
    - Placement: the slot at bucketed position p goes to its row's offset
      plus the number of its row's slots below it, whatever the bucketing
      order was."""
    keys = _keys(ids, num_rows).long()
    flat = ids.reshape(-1)
    real = (flat >= 0) & (flat < num_rows - 1)  # not the pad id
    n, dev = keys.numel(), ids.device
    n_keys = num_rows * (1 if ids.dim() == 1 else ids.shape[0])
    counts = torch.zeros(n_keys, dtype=torch.int64, device=dev).index_add_(
        0, keys[real], torch.ones_like(keys[real]))
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    order = torch.arange(n, device=dev) if order is None else order.to(dev).long()
    placed = order[real[order]]  # the real slots in bucketing order
    # the bucket: rows in key order, each row's slots in bucketing order
    bucket = placed[torch.sort(keys[placed], stable=True).indices]
    row = keys[bucket]
    lo, hi = offsets[row], offsets[row + 1]
    rank = torch.zeros_like(bucket)
    for d in range(int((hi - lo).max()) if bucket.numel() else 0):
        q = torch.clamp(lo + d, max=max(bucket.numel() - 1, 0))
        rank += ((lo + d < hi) & (bucket[q] < bucket)).long()
    slots = torch.full((n,), -1, dtype=torch.int64, device=dev)
    slots[lo + rank] = bucket
    return offsets.to(torch.int32), slots.to(torch.int32)


def slot_index(ids: torch.Tensor, num_rows: int):
    """G1's index on the card, (offsets, slots) int32: row r's slots (of
    view v for per-view ids, key v R + r) in slots[offsets[key]:offsets[key
    + 1]], in increasing order; the pad rows empty and the tail of slots
    unwritten, as `slot_index_emulation` gives it.  The counting pass:
    histogram, torch.cumsum, bucketing and placement.  CUDA tensors only:
    on the CPU the backward is index_add_, which needs no index."""
    if ids.device.type != "cuda":
        raise ValueError(f"the counting index runs on a card, not on {ids.device}")
    ids = ids.contiguous()
    views = 1 if ids.dim() == 1 else ids.shape[0]
    keys = views * num_rows
    dev, stream = ids.device, _stream(ids)
    offsets = torch.empty(keys + 1, dtype=torch.int32, device=dev)
    counts = torch.empty(keys, dtype=torch.int32, device=dev)
    INDEX_COUNT(ids.data_ptr(), views, ids.shape[-1], num_rows, offsets.data_ptr(),
                counts.data_ptr(), stream)
    # offsets[1 + k] = the counts of the keys below k; the last key is a pad
    # row's, never counted
    torch.cumsum(counts[:-1], 0, dtype=torch.int32, out=offsets[2:])
    slots = torch.empty(ids.numel(), dtype=torch.int32, device=dev)
    bucket = torch.empty((ids.numel(), 2), dtype=torch.int32, device=dev)  # (slot, key)
    INDEX(ids.data_ptr(), views, ids.shape[-1], num_rows, offsets.data_ptr(), slots.data_ptr(),
          bucket.data_ptr(), stream)
    return offsets, slots


def stream_gather_backward_reference(grad: torch.Tensor, ids: torch.Tensor,
                                     num_rows: int) -> torch.Tensor:
    """Plain version of the backward on any device: grad [V, S, 16] ->
    d payload [V, R, 16] by `index_add_`, the pad row zeroed.  On a CPU
    index_add_ adds in index order; on a card it adds with float atomics."""
    v, s = grad.shape[:2]
    if ids.dim() == 1:
        out = grad.new_zeros((v, num_rows, PAYLOAD_DIM))
        out.index_add_(1, ids, grad)
    else:
        out = grad.new_zeros((v * num_rows, PAYLOAD_DIM))
        out.index_add_(0, _keys(ids, num_rows), grad.reshape(v * s, PAYLOAD_DIM))
        out = out.reshape(v, num_rows, PAYLOAD_DIM)
    out[:, num_rows - 1].zero_()
    return out


def stream_gather_backward_emulation(grad: torch.Tensor, ids: torch.Tensor,
                                     num_rows: int, index=None) -> torch.Tensor:
    """G1's schedule in PyTorch, on any device (for the tests: it reads the
    longest row's length on the host).  The index `slot_index_emulation`
    builds (or the given (offsets, slots)); every (view, row) but the pad
    row starts from 0 and adds its slots in index order, the k-th slot of
    every row at step k."""
    v, s = grad.shape[:2]
    offsets, slots = slot_index_emulation(ids, num_rows) if index is None else index
    dev = grad.device
    rows = torch.arange(num_rows - 1, device=dev)
    if ids.dim() == 1:
        key = rows.expand(v, -1)
        base = (torch.arange(v, device=dev) * s)[:, None]
    else:
        key = torch.arange(v, device=dev)[:, None] * num_rows + rows
        base = torch.zeros((v, 1), dtype=torch.int64, device=dev)
    start = offsets.long()[key]
    count = offsets.long()[key + 1] - start
    flat = grad.reshape(v * s, PAYLOAD_DIM)
    acc = grad.new_zeros((v, num_rows - 1, PAYLOAD_DIM))
    top = max(slots.shape[0] - 1, 0)
    for k in range(int(count.max()) if count.numel() else 0):
        live = count > k
        slot = slots.long()[torch.clamp(start + k, max=top)] + base
        acc = acc + torch.where(live[..., None], flat[torch.where(live, slot, 0)], 0.0)
    return torch.cat([acc, grad.new_zeros((v, 1, PAYLOAD_DIM))], dim=1)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(grad, offsets, slots, num_rows: int, shared: bool) -> torch.Tensor:
    """Launch kernel G1 on grad [V, S, 16] and an inverse index (contiguous
    CUDA tensors): d payload [V, R, 16]."""
    v, s = grad.shape[:2]
    if grad.data_ptr() % 16:  # the kernel reads 16-byte vectors
        grad = grad.clone()
    out = torch.empty((v, num_rows, PAYLOAD_DIM), dtype=torch.float32, device=grad.device)
    KERNEL(grad.data_ptr(), offsets.data_ptr(), slots.data_ptr(), out.data_ptr(), v, s,
           num_rows, int(shared), _stream(grad))
    return out


def _backward_cuda(grad: torch.Tensor, ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The backward on the card: the counting pass, then kernel G1."""
    if grad.dtype != torch.float32 or grad.dim() != 3 or grad.shape[2] != PAYLOAD_DIM:
        raise ValueError(f"stream gradient {tuple(grad.shape)} {grad.dtype}: expected "
                         "[V, S, 16] float32")
    offsets, slots = slot_index(ids, num_rows)
    return _launch(grad.contiguous(), offsets, slots, num_rows, ids.dim() == 1)


class _GatherStream(torch.autograd.Function):
    """The gather, with kernel G1 (its plain version on CPU tensors) as its
    backward."""

    @staticmethod
    def forward(ctx, payload, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows = payload.shape[1]
        return _gather(payload, ids)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        if grad.device.type == "cpu":
            return stream_gather_backward_reference(grad, ids, ctx.num_rows), None
        return _backward_cuda(grad, ids, ctx.num_rows), None


def gather_stream(payload: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """payload [V, R, 16] rows in stream order: [V, S, 16] by the shared ids
    [S] or the per-view ids [V, S] (int32).  Differentiable in `payload`."""
    _check(payload, ids)
    if torch.is_grad_enabled() and payload.requires_grad:
        return _GatherStream.apply(payload, ids)
    return _gather(payload, ids)
