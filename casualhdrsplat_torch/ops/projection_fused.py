"""The projection layer as one kernel pair (kernel P1, CUDA C++ for
sm_90a: csrc/projection_fwd.cu, csrc/projection_bwd.cu and their shared
arithmetic csrc/projection.cuh).

Replaces, on the card, the eager chain that turns the Gaussians and the
view matrices into the compositor's payload rows:

    models/gaussians.py `activate`      scales = exp, opacity = sigmoid * alive
    `colors_for_view`                   ops/projection.py `view_directions`,
                                        ops/sh.py `eval_sh`
    ops/projection.py `project_gaussians`, the means2d offset,
    `cull_invisible`, ops/binning.py `build_payload`

~400 ATen kernels forward and ~1,100 in autograd's backward at a training
step's 8 views (each a pass over the [V, N] elements).  That chain stays
the plain version: on CPU tensors the functions here run it, operation for
operation; on CUDA tensors they launch P1 or raise.  The forward's outputs
equal the chain's on the card bit for bit (the payload, depths, radii and
valid flags; csrc/projection.cuh says how), so that every image rendered
from them equals the chain's; the backward recomputes the forward from the
inputs (nothing else is saved) and differs from autograd's only in the
order of its float32 sums.

Two forms of the inputs, one algorithm:
- `project_payload`: activated Gaussians and their colors (ops/rasterize.py
  `rasterize`'s inputs: the synthetic video's ground truth that
  data/synthetic.py renders on the card, for quality_run.py's fixture and
  the training videos step_compare.py and chip_smoke.py make there, and
  bench.py's step);
- `project_leaves`: the store's raw leaves (log-scales, opacity logits,
  alive, SH coefficients) with the SH degree and the camera centres, or
  colors that replace the SH term (models/gaussians.py `project` calls it
  for CUDA tensors).
What varies between callers (the view count, colors per view, shared or
given, `antialias`, an offset, which inputs want a gradient) the kernel
reads from its arguments: the backward writes only the gradients asked
for, and the pose gradient (a per-block partial sum, then a second pass
in a fixed order) only when the view matrices or the camera centres want
one.  No host read, no data-dependent shape: a CUDA graph captures both.

Launch counters: `FWD_KERNEL.launches`, `BWD_KERNEL.launches` (the
backward's kernel and its pose sum count as one launch).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from casualhdrsplat_torch.ops import binning
from casualhdrsplat_torch.ops.cuda_build import CudaKernel
from casualhdrsplat_torch.ops.projection import Projected, cull_invisible, project_gaussians

# the kernels' block (csrc/projection_bwd.cu kThreads): the backward's
# pose partials are one row a block
_THREADS = 128
_POSE_VALS = 12

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FWD_KERNEL = CudaKernel("projection_fwd.cu", "chs_projection_fwd",
                        [_P] * 20 + [_I] * 7 + [_F] * 3 + [_P])
BWD_KERNEL = CudaKernel("projection_bwd.cu", "chs_projection_bwd",
                        [_P] * 27 + [_I] * 7 + [_F] * 3 + [_P])
# The inputs of the Function and of both entry points, in this order:
#   means, quats, scales, opacity, sh_dc, sh_rest, colors, viewmats,
#   camtoworlds, offset (these can take a gradient), alive, fx, fy, cx, cy
_GRADS = 10


class _Statics(NamedTuple):
    degree: int  # SH degree 0-3, -1: colors given
    raw: bool  # the store's leaves, activated in the kernel
    antialias: bool
    near_plane: float
    width: int
    height: int


def _intrinsic(v, device) -> torch.Tensor:
    """A camera intrinsic as the one float32 on `device` the kernels read."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(1)
    return torch.tensor([float(v)], dtype=torch.float32, device=device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _tail(inputs, statics: _Statics):
    """The launchers' size and static arguments."""
    means, sh_rest, colors, viewmats, camtoworlds = (inputs[0], inputs[5], inputs[6],
                                                     inputs[7], inputs[8])
    n, views = means.shape[0], viewmats.shape[0]
    color_views = (colors if colors is not None else camtoworlds).shape[0]
    rest = sh_rest.shape[1] if sh_rest is not None else 0
    return (n, views, color_views, rest, statics.degree, int(statics.raw),
            int(statics.antialias), float(statics.near_plane), float(statics.width),
            float(statics.height))


def _forward_cuda(inputs, statics: _Statics):
    """Launch the forward: (payload [V, N + 1, 16], means2d [V, N, 2],
    depths, radii [V, N], valid [V, N] bool).  `inputs` in the order above
    (contiguous; None where absent)."""
    means, viewmats = inputs[0], inputs[7]
    n, v = means.shape[0], viewmats.shape[0]
    payload = torch.empty((v, n + 1, binning.PAYLOAD_DIM), dtype=torch.float32,
                          device=means.device)
    means2d = torch.empty((v, n, 2), dtype=torch.float32, device=means.device)
    depths = torch.empty((v, n), dtype=torch.float32, device=means.device)
    radii = torch.empty_like(depths)
    valid = torch.empty((v, n), dtype=torch.bool, device=means.device)
    outs = (payload, means2d, depths, radii, valid)
    FWD_KERNEL(*[_ptr(t) for t in inputs], *[t.data_ptr() for t in outs],
               *_tail(inputs, statics), _stream(means))
    return outs


def _backward_cuda(inputs, d_payload: torch.Tensor, needs, statics: _Statics):
    """Launch the backward: the gradients of the inputs that can take one,
    None where `needs` says no."""
    grads = [torch.empty_like(t) if t is not None and need else None
             for t, need in zip(inputs[:_GRADS], needs)]
    part = None
    if grads[7] is not None or grads[8] is not None:  # the pose: partial rows a block
        means, viewmats = inputs[0], inputs[7]
        color_views = (inputs[6] if inputs[6] is not None else inputs[8]).shape[0]
        blocks = -(-means.shape[0] // _THREADS)
        part = torch.empty((blocks, viewmats.shape[0] * _POSE_VALS + color_views * 3),
                           dtype=torch.float32, device=means.device)
    BWD_KERNEL(*[_ptr(t) for t in inputs], d_payload.data_ptr(), *[_ptr(g) for g in grads],
               _ptr(part), *_tail(inputs, statics), _stream(d_payload))
    return grads


class _Project(torch.autograd.Function):
    """P1 forward and backward as one differentiable function of the
    Gaussians' inputs, the view matrices, the camera centres and the
    offset.  Saves its inputs only.  CUDA tensors only: the callers run the
    plain chain on the CPU."""

    @staticmethod
    def forward(ctx, means, quats, scales, opacity, sh_dc, sh_rest, colors, viewmats,
                camtoworlds, offset, alive, fx, fy, cx, cy, statics):
        inputs = (means, quats, scales, opacity, sh_dc, sh_rest, colors, viewmats, camtoworlds,
                  offset, alive, fx, fy, cx, cy)
        ctx.statics = statics
        ctx.save_for_backward(*inputs)
        payload, means2d, depths, radii, valid = _forward_cuda(inputs, statics)
        ctx.mark_non_differentiable(means2d, depths, radii, valid)
        return payload, means2d, depths, radii, valid

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_payload, *_):
        grads = _backward_cuda(ctx.saved_tensors, d_payload.contiguous(),
                               ctx.needs_input_grad[:_GRADS], ctx.statics)
        return (*grads, *[None] * (len(ctx.saved_tensors) - _GRADS), None)


def _projected(payload, means2d, depths, radii, valid) -> Projected:
    """The projection's leaves (the conics a view of the payload); means2d,
    depths, radii and valid feed the binning and carry no gradient."""
    return Projected(means2d=means2d, depths=depths, conics=payload[:, :-1, 2:5], radii=radii,
                     valid=valid, compensation=None)


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if t is None:
        return None
    if t.dtype != torch.float32:
        raise TypeError(f"the projection takes float32 tensors, got {t.dtype}")
    return t.contiguous()


def _cuda_only(*tensors):
    for t in tensors:
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"kernel P1 takes CUDA tensors, got one on {t.device}")


def payload_chain(means3d, quats, scales, opacities, colors, viewmats, fx, fy, cx, cy,
                  width: int, height: int, near_plane: float = 0.05, antialias: bool = False,
                  means2d_offset: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Projected]:
    """The plain chain `project_payload` replaces, on any device (the CPU
    path, and the card tests' yardstick): `project_gaussians`, the offset,
    `cull_invisible`, `build_payload`."""
    projs = project_gaussians(means3d, quats, scales, viewmats, fx, fy, cx, cy, width, height,
                              near_plane=near_plane, antialias=antialias)
    if means2d_offset is not None:
        projs = projs._replace(means2d=projs.means2d + means2d_offset)
    projs = cull_invisible(projs, opacities)
    return binning.build_payload(projs, colors, opacities), projs


def project_payload(
    means3d: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    scales: torch.Tensor,  # [N, 3] activated
    opacities: torch.Tensor,  # [N] activated
    colors: torch.Tensor,  # [N, 3] or [V, N, 3] (or [1, N, 3])
    viewmats: torch.Tensor,  # [V, 4, 4] world to camera
    fx, fy, cx, cy,
    width: int,
    height: int,
    near_plane: float = 0.05,
    antialias: bool = False,
    means2d_offset: Optional[torch.Tensor] = None,  # [N, 2]
) -> Tuple[torch.Tensor, Projected]:
    """The payload [V, N + 1, 16] and the projection (means2d, depths,
    conics, radii, valid [V, N, ...]) of activated Gaussians: on CPU
    tensors the plain chain (`project_gaussians`, the offset,
    `cull_invisible`, `build_payload`), on CUDA tensors P1."""
    viewmats = viewmats.reshape(-1, 4, 4)
    if means3d.device.type == "cpu":
        return payload_chain(means3d, quats, scales, opacities, colors, viewmats, fx, fy, cx,
                             cy, width, height, near_plane, antialias, means2d_offset)
    n = means3d.shape[0]
    colors = colors.reshape(-1, n, 3)
    _cuda_only(means3d, quats, scales, opacities, colors, viewmats, means2d_offset)
    statics = _Statics(-1, False, bool(antialias), float(near_plane), int(width), int(height))
    cam = [_intrinsic(v, means3d.device) for v in (fx, fy, cx, cy)]
    out = _Project.apply(_f32(means3d), _f32(quats), _f32(scales), _f32(opacities), None, None,
                         _f32(colors), _f32(viewmats), None, _f32(means2d_offset), None, *cam,
                         statics)
    return out[0], _projected(*out)


def project_leaves(
    means: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    log_scales: torch.Tensor,  # [N, 3]
    opacity_logit: torch.Tensor,  # [N]
    alive: torch.Tensor,  # [N] bool
    sh_dc: torch.Tensor,  # [N, 1, 3]
    sh_rest: torch.Tensor,  # [N, K - 1, 3]
    sh_degree: int,
    camtoworlds: Optional[torch.Tensor],  # [1 or V, 4, 4]: their centres see the SH
    viewmats: torch.Tensor,  # [V, 4, 4]
    fx, fy, cx, cy,
    width: int,
    height: int,
    near_plane: float = 0.05,
    antialias: bool = False,
    colors: Optional[torch.Tensor] = None,  # [1 or V, N, 3], in place of the SH term
    means2d_offset: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Projected]:
    """P1 on the store's raw leaves (CUDA tensors): the payload and the
    projection of `models/gaussians.py`'s activation, SH radiance at
    `sh_degree` seen from the centre of each camera-to-world matrix (one
    matrix: a radiance every view shares), and projection."""
    n = means.shape[0]
    viewmats = viewmats.reshape(-1, 4, 4)
    _cuda_only(means, quats, log_scales, opacity_logit, alive, sh_dc, sh_rest, camtoworlds,
               viewmats, colors, means2d_offset)
    if colors is not None:
        colors, degree = _f32(colors.reshape(-1, n, 3)), -1
        sh_dc = sh_rest = camtoworlds = None
    else:
        if not 0 <= sh_degree <= 3 or (sh_degree + 1) ** 2 > 1 + sh_rest.shape[1]:
            raise ValueError(f"SH degree {sh_degree} with {1 + sh_rest.shape[1]} coefficients")
        degree = int(sh_degree)
        camtoworlds = _f32(camtoworlds.reshape(-1, 4, 4))
    statics = _Statics(degree, True, bool(antialias), float(near_plane), int(width), int(height))
    cam = [_intrinsic(v, means.device) for v in (fx, fy, cx, cy)]
    out = _Project.apply(_f32(means), _f32(quats), _f32(log_scales), _f32(opacity_logit),
                         _f32(sh_dc), _f32(sh_rest), colors, _f32(viewmats), camtoworlds,
                         _f32(means2d_offset), alive.to(torch.bool).contiguous(), *cam,
                         statics)
    return out[0], _projected(*out)
