"""The CRF's monotone MLP as one fused pass, forward and backward (kernel
T1, CUDA C++ for sm_90a: csrc/crf_mlp_fwd.cu and csrc/crf_mlp_bwd.cu).

Counterpart of casualhdrsplat_tpu/models/crf.py::apply with kind "mlp"
(`_norm_log` and `_monotone_mlp`, :132).  The reference has no Pallas
kernel here: XLA fuses the chain into loops that keep the hidden units in
registers.  Eager PyTorch instead materialises [3, B, H] float tensors (at
B = 8 x 800^2 pixels, H = 32, each is 1.97 GB) and their autograd twins.
This module computes every element's whole chain in one pass:

    e = max(x, 0)
    u = (log(e + 1e-8) - log_min) / (log_max - log_min)
    y = sum_j w_j sigmoid(k_j (u - c_j)) + g u + bias        (per channel)
    out = clip(sigmoid(y) 1.004 - 0.002, 0, 1)

with k = 20 softplus(unit_k), w = softplus(unit_w) and g = softplus(gain)
computed by the caller on the [3, H] parameters (autograd chains through
them there).  The backward saves only the input, recomputes the units and
returns d x per element and d(k, c, w) [3, H], d(g, bias) [3].

`monotone_crf` is differentiable in x and the five parameters:
- on CUDA tensors the forward launches `chs_crf_mlp_fwd` and the backward
  `chs_crf_mlp_bwd` (its kernel and the fixed-order sum of its partial
  rows, counted as one launch), or they raise;
- on CPU tensors they run `monotone_crf_reference` (the plain chain of
  models/crf.py, the same operations in the same order) and
  `monotone_crf_backward_reference`, the closed-form backward the kernel
  implements.

Subgradients at the clamps are the reference's: `jnp.maximum(x, 0)` and
`jnp.clip` give each side half the gradient where the input equals the
bound (so d out / d x at x = 0 carries a factor 0.5, and an output
exactly at 0 or 1 passes half its gradient), where `torch.clamp`'s
autograd passes the whole gradient there.

What bounds it on an H100: each unit's exp and reciprocal run on the
special-function units, 16 results a clock per SM against 128 fp32 FMAs
(an eighth of the rate), and they, not the bytes (12 read and 12 written a
pixel forward), set the pace.  The forward shares one reciprocal among
four units; the backward splits an element's units over a group of lanes.
The sources say how.  Both grids are persistent, a fixed number of blocks
per SM (fewer for a small call), so the backward's partial sums, and the
bits of the parameter gradients, depend on the input and the card alone:
no float atomics.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from casualhdrsplat_torch.ops.cuda_build import CudaKernel

_EPS = 1e-8
_MAX_HIDDEN = 64
# The grids: the .cu's kBlocksPerSM blocks per SM, fewer where the pixels
# fill fewer.  A forward block takes 256 threads x 2 pixels a pass; a
# backward block has 2 warps a channel, with `_bwd_lanes` lanes an element
# (16 units a lane): 64 / lanes pixels a pass.
_FWD_BLOCKS_PER_SM, _FWD_BLOCK_PIXELS = 4, 256 * 2
_BWD_BLOCKS_PER_SM, _BWD_WARPS_PER_CHANNEL, _BWD_UNITS_PER_LANE = 2, 2, 16

FWD_KERNEL = CudaKernel(
    "crf_mlp_fwd.cu", "chs_crf_mlp_fwd",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p],
)
# the backward pass: its kernel and the fixed-order column sum, counted once
BWD_KERNEL = CudaKernel(
    "crf_mlp_bwd.cu", "chs_crf_mlp_bwd",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p],
)


def _padded_hidden(h: int) -> int:
    """The kernels' unit count: 8, 16, 32 or 64 (padded units have w = 0)."""
    return max(1 << (h - 1).bit_length(), 8)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _fwd_blocks(n: int, sms: int) -> int:
    return min(sms * _FWD_BLOCKS_PER_SM, -(-n // _FWD_BLOCK_PIXELS))


def _bwd_lanes(hp: int) -> int:
    """The lanes of the backward that share an element at hp units."""
    return max(hp // _BWD_UNITS_PER_LANE, 1)


def _bwd_blocks(n: int, hp: int, sms: int) -> int:
    """The backward's grid, and so its partial rows, for n pixels: a
    function of n only below sms x _BWD_BLOCKS_PER_SM blocks' first pass."""
    return min(sms * _BWD_BLOCKS_PER_SM, -(-n // (_BWD_WARPS_PER_CHANNEL * 32 // _bwd_lanes(hp))))


def _split_total(total: torch.Tensor, h: int, hp: int):
    """The backward's summed row per channel [3, 3 hp + 2] as (d k, d c,
    d w [3, H], d g, d bias [3])."""
    return (total[:, :h], total[:, hp:hp + h], total[:, 2 * hp:2 * hp + h], total[:, 3 * hp],
            total[:, 3 * hp + 1])


def _check(x, params):
    if x.shape[-1] != 3:
        raise ValueError(f"the CRF takes [..., 3] images, got {tuple(x.shape)}")
    if x.numel() >= 2**31:
        raise ValueError(f"the fused CRF takes fewer than 2^31 elements, got {x.numel()}")
    h = params[0].shape[-1]
    if h > _MAX_HIDDEN:
        raise ValueError(f"the fused CRF takes up to {_MAX_HIDDEN} units, got {h}")
    for name, p, shape in zip(("k", "c", "w", "g", "bias"), params,
                              ((3, h), (3, h), (3, h), (3,), (3,))):
        if tuple(p.shape) != shape or p.dtype != torch.float32:
            raise ValueError(f"CRF parameter {name}: {tuple(p.shape)} {p.dtype}, "
                             f"expected {shape} float32")
        if p.device != x.device:
            raise ValueError(f"CRF parameter {name} is on {p.device}, the image on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the CRF takes float32 images, got {x.dtype}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _forward_cuda(x, k, c, w, g, bias, log_min: float, span: float) -> torch.Tensor:
    """Launch the forward kernel on x [B, 3] and the parameters (contiguous
    CUDA tensors): the LDR image [B, 3].  An empty x launches nothing."""
    n, h = x.shape[0], k.shape[1]
    out = torch.empty_like(x)
    if n:
        FWD_KERNEL(x.data_ptr(), k.data_ptr(), c.data_ptr(), w.data_ptr(), g.data_ptr(),
                   bias.data_ptr(), out.data_ptr(), n, h, _padded_hidden(h),
                   _fwd_blocks(n, _sm_count(x.device.index)), log_min, span, _stream(x))
    return out


def _backward_cuda(x, go, k, c, w, g, bias, log_min: float, span: float):
    """Launch the backward kernel and its column sum: (d x [B, 3], d k, d c,
    d w [3, H], d g, d bias [3]).  An empty x launches nothing: zero
    parameter gradients."""
    n, h = x.shape[0], k.shape[1]
    hp = _padded_hidden(h)
    dx = torch.empty_like(x)
    total = (torch.empty if n else torch.zeros)((3, 3 * hp + 2), dtype=torch.float32,
                                                device=x.device)
    if n:
        blocks = _bwd_blocks(n, hp, _sm_count(x.device.index))
        part = torch.empty((blocks, 3, 3 * hp + 2), dtype=torch.float32, device=x.device)
        BWD_KERNEL(x.data_ptr(), go.data_ptr(), k.data_ptr(), c.data_ptr(), w.data_ptr(),
                   g.data_ptr(), bias.data_ptr(), dx.data_ptr(), part.data_ptr(),
                   total.data_ptr(), n, h, hp, blocks, log_min, span, _stream(x))
    return (dx, *_split_total(total, h, hp))


def monotone_crf_reference(x, k, c, w, g, bias, log_min: float, log_max: float):
    """Plain PyTorch version of the forward on any device: models/crf.py's
    `_norm_log` and `_monotone_mlp` on the activated parameters, the same
    operations in the same order.  x [..., 3] -> LDR [..., 3]."""
    e = torch.clamp(x, min=0.0)
    u = (torch.log(e + _EPS) - log_min) / (log_max - log_min)
    batch_shape = u.shape[:-1]
    uc = u.reshape(-1, 3).T[:, :, None]  # [3, B, 1]
    y = (w[:, None, :] * torch.sigmoid(k[:, None, :] * (uc - c[:, None, :]))).sum(-1)
    y = y + g[:, None] * uc[..., 0] + bias[:, None]
    out = torch.sigmoid(y) * 1.004 - 0.002
    return torch.clamp(out, 0.0, 1.0).T.reshape(*batch_shape, 3)


def _half_at_ties(inside, at_bound):
    """1 strictly inside, 0.5 at a bound, 0 outside: the subgradient of
    jnp.maximum and jnp.clip."""
    return torch.where(inside, 1.0, torch.where(at_bound, 0.5, 0.0))


def monotone_crf_backward_reference(x, go, k, c, w, g, bias, log_min: float,
                                    log_max: float):
    """Plain PyTorch version of the backward on any device, in closed form
    (the formula the kernel implements): (d x [..., 3], d k, d c, d w
    [3, H], d g, d bias [3]) for the upstream gradient go [..., 3]."""
    span = log_max - log_min
    de = _half_at_ties(x > 0.0, x == 0.0)
    ee = torch.clamp(x, min=0.0) + _EPS
    u = ((torch.log(ee) - log_min) / span).reshape(-1, 3).T  # [3, B]
    d = u[:, :, None] - c[:, None, :]  # [3, B, H]
    s = torch.sigmoid(k[:, None, :] * d)
    y = (w[:, None, :] * s).sum(-1) + g[:, None] * u + bias[:, None]
    sy = torch.sigmoid(y)
    o = sy * 1.004 - 0.002
    dq = _half_at_ties((o > 0.0) & (o < 1.0), (o == 0.0) | (o == 1.0))
    t = go.reshape(-1, 3).T * dq * 1.004 * (sy * (1.0 - sy))  # [3, B]
    ws = w[:, None, :] * (s * (1.0 - s))
    tt = t[:, :, None]
    dk = (tt * ws * d).sum(1)
    dc = -(tt * ws * k[:, None, :]).sum(1)
    dw = (tt * s).sum(1)
    dydu = (ws * k[:, None, :]).sum(-1) + g[:, None]
    dx = (t * dydu).T.reshape(x.shape) / (ee * span) * de
    return dx, dk, dc, dw, (t * u).sum(1), t.sum(1)


class _MonotoneCRF(torch.autograd.Function):
    """Kernel T1 forward and backward (their plain versions on CPU tensors)
    as one differentiable function of the image and the five activated
    parameters.  Saves the input and the parameters only."""

    @staticmethod
    def forward(ctx, x, k, c, w, g, bias, log_min, log_max):
        ctx.bounds = (log_min, log_max)
        ctx.save_for_backward(x, k, c, w, g, bias)
        if x.device.type == "cpu":
            return monotone_crf_reference(x, k, c, w, g, bias, log_min, log_max)
        flat = x.contiguous().reshape(-1, 3)
        params = [p.contiguous() for p in (k, c, w, g, bias)]
        return _forward_cuda(flat, *params, log_min, log_max - log_min).reshape(x.shape)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, go):
        x, k, c, w, g, bias = ctx.saved_tensors
        log_min, log_max = ctx.bounds
        if x.device.type == "cpu":
            grads = monotone_crf_backward_reference(x, go, k, c, w, g, bias, log_min, log_max)
        else:
            flat = x.contiguous().reshape(-1, 3)
            params = [p.contiguous() for p in (k, c, w, g, bias)]
            dx, *rest = _backward_cuda(flat, go.contiguous().reshape(-1, 3), *params, log_min,
                                       log_max - log_min)
            grads = (dx.reshape(x.shape), *rest)
        return (*grads, None, None)


def monotone_crf(x: torch.Tensor, k: torch.Tensor, c: torch.Tensor, w: torch.Tensor,
                 g: torch.Tensor, bias: torch.Tensor, log_min: float,
                 log_max: float) -> torch.Tensor:
    """The monotone CRF of exposed HDR radiance x [..., 3] -> LDR [..., 3]
    in [0, 1], differentiable in x and the activated parameters k, c, w
    [3, H] and g, bias [3]."""
    params: Tuple[torch.Tensor, ...] = (k, c, w, g, bias)
    _check(x, params)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no CRF kernel for device {x.device}")
    return _MonotoneCRF.apply(x, *params, log_min, log_max)
