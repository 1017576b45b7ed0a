"""The CRF's monotone MLP as one fused pass, forward and backward (kernel
T1, Triton).

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
- on CUDA tensors the forward and backward launch the Triton kernels
  `_crf_fwd` and `_crf_bwd` + `_col_sum` (or they raise);
- on CPU tensors they run `monotone_crf_reference` (the plain chain of
  models/crf.py, the same operations in the same order) and
  `monotone_crf_backward_reference`, the closed-form backward the kernel
  implements.

Subgradients at the clamps are the reference's: `jnp.maximum(x, 0)` and
`jnp.clip` give each side half the gradient where the input equals the
bound (so d out / d x at x = 0 carries a factor 0.5, and an output
exactly at 0 or 1 passes half its gradient), where `torch.clamp`'s
autograd passes the whole gradient there.

Why Triton and not CUDA C++: a pointwise pass over [B, 3] with a loop of
H <= 64 units in registers and a reduction of the parameter gradients over
B; nothing needs shared-memory staging or tensor cores.

What bounds it on an H100.  The forward reads and writes 12 bytes a pixel
and evaluates 3 H sigmoids a pixel (one exp and one reciprocal each, on
the special-function units, a sixteenth of the fp32 lanes); the backward
reads 24 and writes 12 bytes a pixel and evaluates the same sigmoids
again.  Both are bound by arithmetic, not by bytes.  Design: a program
takes one channel of BLOCK_P pixels as a [BLOCK_P, H] tile; the channel's
parameters are [H] vectors in registers.  The backward's programs stride
over the pixels with per-thread accumulators and write one row of partial
sums each; `_col_sum` adds the rows in a fixed order.  No float atomics:
two launches on the same input give the same bits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from casualhdrsplat_torch.ops.cuda_build import register_counter

_EPS = 1e-8
# programs a channel of the backward strides over the pixels with: a fixed
# number (a few per SM of an H100), so that the partial sums, and so the
# bits of the parameter gradients, depend on the input alone
_BWD_PROGRAMS = 192
_MAX_HIDDEN = 64


class TritonKernel:
    """Launch count of one Triton kernel of this module; `launches` is a
    plain integer that a caller may reset."""

    def __init__(self, symbol: str):
        self.symbol = symbol
        self.launches = 0
        register_counter(self)


FWD_KERNEL = TritonKernel("crf_fused_fwd")
# the backward pass: `_crf_bwd` and its fixed-order `_col_sum`, counted once
BWD_KERNEL = TritonKernel("crf_fused_bwd")

_KERNELS = None


def _kernels():
    """Define the Triton kernels at first use (never at import: the CPU has
    no triton).  Triton resolves the names a kernel uses in its module's
    globals, so the kernels, their helper and `tl` are bound there."""
    global _KERNELS, triton, tl, _unit_sigmoids, _crf_fwd, _crf_bwd, _col_sum
    if _KERNELS is not None:
        return _KERNELS
    import triton
    import triton.language as tl

    @triton.jit
    def _unit_sigmoids(u, k, c):
        d = u[:, None] - c[None, :]
        s = 1.0 / (1.0 + tl.exp(-(k[None, :] * d)))
        return d, s

    @triton.jit
    def _crf_fwd(x_ptr, k_ptr, c_ptr, w_ptr, g_ptr, b_ptr, out_ptr, n_pix, log_min, span,
                 H: tl.constexpr, HP: tl.constexpr, BLOCK_P: tl.constexpr):
        # program 3 b + ch: channel ch of pixel block b (a 1-D grid: a frame's
        # blocks overflow the 65,535 of a grid's second axis)
        ch = tl.program_id(0) % 3
        pix = (tl.program_id(0) // 3) * BLOCK_P + tl.arange(0, BLOCK_P)
        pm = pix < n_pix
        j = tl.arange(0, HP)
        jm = j < H
        k = tl.load(k_ptr + ch * H + j, mask=jm, other=0.0)
        c = tl.load(c_ptr + ch * H + j, mask=jm, other=0.0)
        w = tl.load(w_ptr + ch * H + j, mask=jm, other=0.0)  # 0: padded units add nothing
        g = tl.load(g_ptr + ch)
        bias = tl.load(b_ptr + ch)
        x = tl.load(x_ptr + pix * 3 + ch, mask=pm, other=0.0)
        u = (tl.log(tl.maximum(x, 0.0) + 1e-8) - log_min) / span
        _, s = _unit_sigmoids(u, k, c)
        y = tl.sum(w[None, :] * s, axis=1) + g * u + bias
        out = (1.0 / (1.0 + tl.exp(-y))) * 1.004 - 0.002
        tl.store(out_ptr + pix * 3 + ch, tl.minimum(tl.maximum(out, 0.0), 1.0), mask=pm)

    @triton.jit
    def _crf_bwd(x_ptr, go_ptr, k_ptr, c_ptr, w_ptr, g_ptr, b_ptr, dx_ptr, part_ptr, n_pix,
                 log_min, span, H: tl.constexpr, HP: tl.constexpr, BLOCK_P: tl.constexpr):
        ch = tl.program_id(0) % 3
        pid = tl.program_id(0) // 3
        nprog = tl.num_programs(0) // 3
        j = tl.arange(0, HP)
        jm = j < H
        k = tl.load(k_ptr + ch * H + j, mask=jm, other=0.0)
        c = tl.load(c_ptr + ch * H + j, mask=jm, other=0.0)
        w = tl.load(w_ptr + ch * H + j, mask=jm, other=0.0)
        g = tl.load(g_ptr + ch)
        bias = tl.load(b_ptr + ch)
        acc_k = tl.zeros((BLOCK_P, HP), dtype=tl.float32)
        acc_c = tl.zeros((BLOCK_P, HP), dtype=tl.float32)
        acc_w = tl.zeros((BLOCK_P, HP), dtype=tl.float32)
        acc_g = tl.zeros((BLOCK_P,), dtype=tl.float32)
        acc_b = tl.zeros((BLOCK_P,), dtype=tl.float32)
        for start in range(pid * BLOCK_P, n_pix, nprog * BLOCK_P):
            pix = start + tl.arange(0, BLOCK_P)
            pm = pix < n_pix
            x = tl.load(x_ptr + pix * 3 + ch, mask=pm, other=1.0)
            go = tl.load(go_ptr + pix * 3 + ch, mask=pm, other=0.0)
            # max(x, 0): half the gradient at the tie, as jnp.maximum
            de = tl.where(x > 0.0, 1.0, tl.where(x == 0.0, 0.5, 0.0))
            ee = tl.maximum(x, 0.0) + 1e-8
            u = (tl.log(ee) - log_min) / span
            d, s = _unit_sigmoids(u, k, c)
            y = tl.sum(w[None, :] * s, axis=1) + g * u + bias
            sy = 1.0 / (1.0 + tl.exp(-y))
            o = sy * 1.004 - 0.002
            # clip(o, 0, 1): half the gradient at either bound, as jnp.clip
            dq = tl.where((o > 0.0) & (o < 1.0), 1.0,
                          tl.where((o == 0.0) | (o == 1.0), 0.5, 0.0))
            t = go * dq * 1.004 * (sy * (1.0 - sy))
            ws = w[None, :] * (s * (1.0 - s))
            tt = t[:, None]
            acc_w += tt * s
            acc_k += tt * ws * d
            acc_c -= tt * ws * k[None, :]
            acc_g += t * u
            acc_b += t
            dydu = tl.sum(ws * k[None, :], axis=1) + g
            tl.store(dx_ptr + pix * 3 + ch, t * dydu / (ee * span) * de, mask=pm)
        # this program's partial sums: row pid, channel ch, [dk | dc | dw | dg, db]
        row = part_ptr + (pid * 3 + ch) * (3 * HP + 2)
        tl.store(row + j, tl.sum(acc_k, axis=0), mask=jm)
        tl.store(row + HP + j, tl.sum(acc_c, axis=0), mask=jm)
        tl.store(row + 2 * HP + j, tl.sum(acc_w, axis=0), mask=jm)
        tl.store(row + 3 * HP, tl.sum(acc_g, axis=0))
        tl.store(row + 3 * HP + 1, tl.sum(acc_b, axis=0))

    @triton.jit
    def _col_sum(part_ptr, out_ptr, n_rows, n_cols, BLOCK_R: tl.constexpr,
                 BLOCK_C: tl.constexpr):
        """out[col] = sum over rows of part[row, col], rows in a fixed order."""
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cm = cols < n_cols
        acc = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
        for r0 in range(0, n_rows, BLOCK_R):
            rows = r0 + tl.arange(0, BLOCK_R)
            acc += tl.load(part_ptr + rows[:, None] * n_cols + cols[None, :],
                           mask=(rows < n_rows)[:, None] & cm[None, :], other=0.0)
        tl.store(out_ptr + cols, tl.sum(acc, axis=0), mask=cm)

    _KERNELS = (triton, _crf_fwd, _crf_bwd, _col_sum)
    return _KERNELS


def _padded_hidden(h: int) -> int:
    return max(1 << (h - 1).bit_length(), 2)


def _check(x, params):
    if x.shape[-1] != 3:
        raise ValueError(f"the CRF takes [..., 3] images, got {tuple(x.shape)}")
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


def _forward_cuda(x, k, c, w, g, bias, log_min: float, span: float) -> torch.Tensor:
    """Launch `_crf_fwd` on x [B, 3] (contiguous): the LDR image [B, 3]."""
    _, fwd, _, _ = _kernels()
    n, h = x.shape[0], k.shape[1]
    hp = _padded_hidden(h)
    block = max(2048 // hp, 16)
    out = torch.empty_like(x)
    if n:
        fwd[(3 * -(-n // block),)](x, k, c, w, g, bias, out, n, log_min, span,
                                   H=h, HP=hp, BLOCK_P=block, num_warps=4)
    FWD_KERNEL.launches += 1
    return out


def _backward_cuda(x, go, k, c, w, g, bias, log_min: float, span: float):
    """Launch `_crf_bwd` and `_col_sum`: (d x [B, 3], d k, d c, d w [3, H],
    d g, d bias [3])."""
    _, _, bwd, col_sum = _kernels()
    n, h = x.shape[0], k.shape[1]
    hp = _padded_hidden(h)
    block = max(1024 // hp, 16)
    progs = max(1, min(_BWD_PROGRAMS, -(-n // block)))
    width = 3 * hp + 2
    dx = torch.empty_like(x)
    part = torch.empty((progs, 3, width), dtype=torch.float32, device=x.device)
    total = torch.empty((3, width), dtype=torch.float32, device=x.device)
    bwd[(3 * progs,)](x, go, k, c, w, g, bias, dx, part, n, log_min, span,
                      H=h, HP=hp, BLOCK_P=block, num_warps=4)
    col_sum[(-(-3 * width // 128),)](part, total, progs, 3 * width, BLOCK_R=32,
                                     BLOCK_C=128, num_warps=4)
    BWD_KERNEL.launches += 1
    return (dx, total[:, :h], total[:, hp:hp + h], total[:, 2 * hp:2 * hp + h],
            total[:, 3 * hp], total[:, 3 * hp + 1])


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
