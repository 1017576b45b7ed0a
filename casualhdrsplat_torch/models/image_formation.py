"""The CasualHDRSplat unified image-formation model.  Counterpart of
casualhdrsplat_tpu/models/image_formation.py:

    T(t)   = spline(knots; t)                       continuous camera motion
    H_k    = Rasterize(G_theta, T(t_k))             virtual sharp HDR images
    I_k    = F_theta(H_k * dt_i)                    shared CRF -> sharp LDRs
    B_i    = (1/n) sum_k I_k                        estimated blurred frame

All n virtual views render in one rasterizer call (views stack along the
compositor's rows).  Parameters are a dict: {"gaussians": store,
"knot_deltas": [M,6], "log_exposures": [F], "crf": {...}}.  The rendering
functions follow the parameters' device and are differentiable in every
floating parameter (the compositor brings its own backward); a server
that needs no gradient calls them under `torch.no_grad()` or
`torch.inference_mode()`.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from casualhdrsplat_torch.config import ModelConfig
from casualhdrsplat_torch.geometry import lie, spline
from casualhdrsplat_torch.models import crf as crf_mod
from casualhdrsplat_torch.models import gaussians as gauss_mod
from casualhdrsplat_torch.models import losses
from casualhdrsplat_torch.ops import binning
from casualhdrsplat_torch.ops import rasterize as rast_mod
from casualhdrsplat_torch.ops.projection import cull_invisible, project_gaussians
from casualhdrsplat_torch.parallel import sharding
from casualhdrsplat_torch.utils import cuda_graphs

Params = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Non-learnable scene context."""

    base_knots: torch.Tensor  # [M,4,4] from SfM poses
    knot_t0: torch.Tensor  # scalar
    knot_dt: torch.Tensor  # scalar
    timestamps: torch.Tensor  # [F] frame start times
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int


def build_scene(dataset, cfg: ModelConfig, device="cuda") -> SceneStatic:
    """SceneStatic from any object with the dataset's fields (`viewmats`
    [F,4,4] world->cam, `timestamps` [F], `fx`, `fy`, `cx`, `cy`, `width`,
    `height`): spline knots initialized from the per-frame poses."""

    def f32(v):
        return torch.as_tensor(np.array(v, np.float32), device=device)

    poses = f32(dataset.viewmats)
    knots, t0, dt = spline.knots_for_frames(poses, pad=2)
    if cfg.knots_per_frame > 1:
        knots, t0, dt = spline.resample_knots(
            knots, t0, dt, poses.shape[0], cfg.knots_per_frame, mode=cfg.spline_mode,
        )
    ts = f32(dataset.timestamps)
    # knots_for_frames assumes unit frame spacing from 0; rescale the knot
    # clock to the dataset's timestamps
    t_start = ts[0]
    n = ts.shape[0]
    t_step = (ts[-1] - ts[0]) / max(n - 1, 1) if n > 1 else torch.ones_like(t_start)
    return SceneStatic(
        base_knots=knots,
        knot_t0=t_start + t0 * t_step,
        knot_dt=t_step * dt,
        timestamps=ts,
        fx=f32(dataset.fx), fy=f32(dataset.fy), cx=f32(dataset.cx), cy=f32(dataset.cy),
        width=int(dataset.width), height=int(dataset.height),
    )


def init_params(
    scene: SceneStatic,
    points_xyz,
    points_rgb,
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
) -> Params:
    """The full learnable parameter dict on the scene's device."""
    dev = scene.timestamps.device
    num_frames = scene.timestamps.shape[0]
    num_knots = scene.base_knots.shape[0]
    if cfg.exposure_init_frac > 0.0 and num_frames > 1:
        # torch.median takes the lower middle element; the reference's
        # jnp.median averages the two, which quantile(0.5) does too
        med_dt = torch.quantile(torch.diff(scene.timestamps), 0.5)
        log_e0 = float(torch.log(cfg.exposure_init_frac * med_dt))
    else:
        log_e0 = 0.0
    return {
        "gaussians": gauss_mod.create(
            points_xyz, points_rgb, cfg.max_gaussians, cfg.sh_degree, device=dev
        ),
        "knot_deltas": torch.zeros((num_knots, 6), device=dev),
        "log_exposures": torch.full((num_frames,), log_e0, device=dev),
        "crf": crf_mod.create(cfg.crf, generator, device=dev),
    }


def effective_knots(params: Params, scene: SceneStatic) -> torch.Tensor:
    """knot_j = exp(delta_j) @ base_j.

    LEFT multiplication (camera-frame deltas) is load-bearing: base_j is
    world-to-camera, so a right-multiplied delta would rotate the camera
    about the world origin and entangle orientation with position."""
    return lie.mat_mul(lie.se3_exp(params["knot_deltas"]), scene.base_knots)


def poses_at(params: Params, scene: SceneStatic, times, cfg: ModelConfig):
    return spline.interpolate(
        effective_knots(params, scene), scene.knot_t0, scene.knot_dt, times,
        mode=cfg.spline_mode,
    )


def frame_entry(values: torch.Tensor, frame_id) -> torch.Tensor:
    """values[frame_id]: `frame_id` an int, or an int64 device tensor of one
    element (the trainer's frame buffer, the reference's traced frame_id),
    read on the device without a host read."""
    if isinstance(frame_id, torch.Tensor):
        return values.index_select(0, frame_id.reshape(1))[0]
    return values[frame_id]


def exposure_of(params: Params, frame_id) -> torch.Tensor:
    return torch.exp(frame_entry(params["log_exposures"], frame_id))


def _virtual_viewmats(params, scene, frame_id, cfg: ModelConfig, n: int):
    t_i = frame_entry(scene.timestamps, frame_id)
    dt = exposure_of(params, frame_id)
    if cfg.optimize_poses:
        return poses_at(params, scene, spline.sample_virtual_times(t_i, dt, n), cfg)
    # static rig: all virtual views share the frame's base pose
    return poses_at(params, scene, t_i[None], cfg).repeat(n, 1, 1)


def shared_binning_demand(params: Params, scene: SceneStatic, frame_id, cfg: ModelConfig):
    """Binning pressure of one frame, in intersection rows: (shared_demand,
    max_per_view_demand, stream_budget).  shared_demand bins exactly the
    footprint _rasterize_packed_shared bins."""
    r = cfg.rasterize
    t_i = frame_entry(scene.timestamps, frame_id)
    dt = exposure_of(params, frame_id)
    viewmats = poses_at(
        params, scene, spline.sample_virtual_times(t_i, dt, cfg.num_virtual_views), cfg
    )
    act = gauss_mod.activate(params["gaussians"])
    projs = cull_invisible(
        project_gaussians(
            act.means3d, act.quats, act.scales, viewmats, scene.fx, scene.fy,
            scene.cx, scene.cy, scene.width, scene.height,
            near_plane=r.near_plane, antialias=r.antialias,
        ),
        act.opacities,
    )
    validf = projs.valid.to(torch.float32)
    denom = torch.clamp(validf.sum(0), min=1.0)
    ref_m2d = (projs.means2d * validf[..., None]).sum(0) / denom[:, None]
    cheb = torch.abs(projs.means2d - ref_m2d[None]).amax(-1)
    r_shared = torch.where(projs.valid, cheb + projs.radii, 0.0).amax(0)
    args = (scene.width, scene.height, r.tile_h, r.tile_w, r.max_tiles_per_gaussian)
    shared = binning.tile_demand(ref_m2d, r_shared, projs.valid.any(0), *args)
    per_view = torch.stack([
        binning.tile_demand(projs.means2d[k], projs.radii[k], projs.valid[k], *args)
        for k in range(viewmats.shape[0])
    ])
    n = act.means3d.shape[0]
    budget = min(n * r.max_tiles_per_gaussian, r.stream_factor * n)
    return shared, per_view.max(), torch.tensor(budget, dtype=torch.int32,
                                                device=shared.device)


class FrameRender(NamedTuple):
    blurred_ldr: torch.Tensor  # [H,W,3] B_i
    sharp_ldr: torch.Tensor  # [n,H,W,3] I_k virtual sharp LDR images
    sharp_hdr: torch.Tensor  # [n,H,W,3] H_k virtual sharp HDR images
    alphas: torch.Tensor  # [n,H,W]
    aux: rast_mod.RasterizeAux


def _background(cfg: ModelConfig, like: torch.Tensor):
    return torch.ones(3, device=like.device) if cfg.white_background else None


def render_frame(
    params: Params,
    scene: SceneStatic,
    frame_id,
    cfg: ModelConfig,
    num_virtual: Optional[int] = None,
    sh_degree: Optional[int] = None,
    means2d_offset: Optional[torch.Tensor] = None,
) -> FrameRender:
    """The estimated blurred auto-exposed frame B_i plus all intermediate
    virtual images."""
    n = num_virtual or cfg.num_virtual_views
    deg = cfg.sh_degree if sh_degree is None else sh_degree
    dt = exposure_of(params, frame_id)
    viewmats = _virtual_viewmats(params, scene, frame_id, cfg, n)  # [n,4,4]

    act = gauss_mod.activate(params["gaussians"])
    camtoworlds = lie.se3_inverse(viewmats)
    if cfg.sh_shared_view:
        # one SH eval at the window's middle view, shared by every view
        mid = gauss_mod.colors_for_view(act, camtoworlds[n // 2], deg)
        colors = mid.expand((n,) + mid.shape)
    else:
        colors = gauss_mod.colors_for_view(act, camtoworlds, deg)  # [n,N,3]

    hdr, alphas, aux = rast_mod.rasterize(
        act.means3d, act.quats, act.scales, act.opacities, colors, viewmats,
        scene.fx, scene.fy, scene.cx, scene.cy, scene.width, scene.height,
        cfg.rasterize, background=_background(cfg, dt), means2d_offset=means2d_offset,
    )
    ldr = crf_mod.apply(params["crf"], hdr * dt, cfg.crf)  # [n,H,W,3]
    return FrameRender(blurred_ldr=ldr.mean(0), sharp_ldr=ldr, sharp_hdr=hdr,
                       alphas=alphas, aux=aux)


def render_pose(
    params: Params,
    scene: SceneStatic,
    viewmat: torch.Tensor,
    cfg: ModelConfig,
    exposure: Optional[torch.Tensor] = None,
    hdr_output: bool = False,
    depth_output: bool = False,
    sh_degree: Optional[int] = None,
):
    """Eval-time rendering from an arbitrary pose: novel-view LDR (CRF at
    `exposure`), novel-view HDR (`hdr_output`, CRF skipped) or the
    alpha-normalized expected depth (`depth_output`).  Returns (image,
    alpha, aux)."""
    deg = cfg.sh_degree if sh_degree is None else sh_degree
    act = gauss_mod.activate(params["gaussians"])
    if depth_output:
        # alpha-composited camera-space z as the "radiance"
        z = (act.means3d * viewmat[2, :3]).sum(-1) + viewmat[2, 3]
        colors = torch.clamp(z, min=0.0)[:, None].repeat(1, 3)
    else:
        colors = gauss_mod.colors_for_view(act, lie.se3_inverse(viewmat), deg)
    hdr, alphas, aux = rast_mod.rasterize(
        act.means3d, act.quats, act.scales, act.opacities, colors[None],
        viewmat[None], scene.fx, scene.fy, scene.cx, scene.cy,
        scene.width, scene.height, cfg.rasterize,
        background=None if depth_output else _background(cfg, viewmat),
    )
    if depth_output:
        return hdr[0, :, :, 0] / torch.clamp(alphas[0], min=1e-6), alphas[0], aux
    if hdr_output:
        return hdr[0], alphas[0], aux
    dt = exposure if exposure is not None else 1.0
    return crf_mod.apply(params["crf"], hdr[0] * dt, cfg.crf), alphas[0], aux


def _tensors(tree):
    """The tensors of a parameter tree or a scene, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, SceneStatic):
        return [getattr(tree, f.name) for f in dataclasses.fields(tree)
                if isinstance(getattr(tree, f.name), torch.Tensor)]
    return [tree] if isinstance(tree, torch.Tensor) else []


class GraphedRenders:
    """`render_pose`, and the blurred frame of `render_frame`, for a server;
    an evaluation's renders with their metric vectors (`frame_scores`,
    `deblurred_scores`): on a CUDA device each replays a CUDA graph under
    `torch.no_grad()` (utils/cuda_graphs.py), one per static key (for
    `render_pose`: hdr_output, depth_output, the SH degree and the config),
    captured on the key's second call after an eager warm-up; on another
    device the eager functions run.  The pose, exposure and frame are
    copied into static device buffers before a replay, and the outputs are
    copied out of the graph's before they return: the next replay
    overwrites them.  A graph is captured again when the parameters, the
    scene or the target stacks are other tensors than at its capture (a
    trainer's Adam writes them in place, its density control too).  A
    call holds the object's lock from filling the buffers to copying the
    outputs out, so that the calls of two threads (a server's request and
    a trainer's evaluation) neither see each other's buffers nor capture
    at once.  A caller that trains meanwhile holds the trainer's lock
    around a call, as around the eager render.  With a (data, gauss) mesh the renders are
    its collective ones (parallel/), graphed when every process group of
    it is NCCL (`cuda_graphs.graphable`), their collectives inside the
    graph."""

    def __init__(self):
        self._graphs = {}
        self._buffers = {}
        self._lock = threading.Lock()

    def _buffer(self, name, like: torch.Tensor, dtype=torch.float32):
        key = (name, like.device)
        if key not in self._buffers:
            shape = {"viewmat": (4, 4)}.get(name, ())
            with torch.inference_mode(False):  # written again outside a caller's mode
                self._buffers[key] = torch.zeros(shape, dtype=dtype, device=like.device)
        return self._buffers[key]

    def _replay(self, key, name, params, scene, make, extra=()):
        cache = self._graphs.setdefault(key[:-1], cuda_graphs.GraphCache())
        inputs = _tensors(params) + _tensors(scene) + list(extra)
        return cache.get(key, inputs, lambda: cuda_graphs.GraphedCall(
            make, name, capture_error_mode="thread_local"))()

    @torch.no_grad()
    def render_pose(self, params: Params, scene: SceneStatic, viewmat: torch.Tensor,
                    cfg: ModelConfig, exposure=None, hdr_output: bool = False,
                    depth_output: bool = False, sh_degree: Optional[int] = None):
        """`render_pose(...)`: (image, alpha, aux), copies."""
        if not cuda_graphs.graphable(viewmat.device):
            return render_pose(params, scene, viewmat, cfg, exposure=exposure,
                               hdr_output=hdr_output, depth_output=depth_output,
                               sh_degree=sh_degree)
        with self._lock:
            vm = self._buffer("viewmat", viewmat)
            dt = self._buffer("exposure", viewmat)
            vm.copy_(viewmat)
            if isinstance(exposure, torch.Tensor):
                dt.copy_(exposure)
            else:
                dt.fill_(1.0 if exposure is None else exposure)
            key = (hdr_output, depth_output, sh_degree, repr(cfg))
            img, alpha, aux = self._replay(
                key, f"render_pose (hdr {hdr_output}, depth {depth_output})", params, scene,
                lambda: render_pose(params, scene, vm, cfg, exposure=dt, hdr_output=hdr_output,
                                    depth_output=depth_output, sh_degree=sh_degree))
            return img.clone(), alpha.clone(), rast_mod.RasterizeAux(*(
                t.clone() if isinstance(t, torch.Tensor) else t for t in aux))

    @torch.no_grad()
    def render_frame_blurred(self, params: Params, scene: SceneStatic, frame_id,
                             cfg: ModelConfig, sh_degree: Optional[int] = None):
        """`render_frame(...).blurred_ldr`, a copy."""
        if not cuda_graphs.graphable(scene.timestamps.device):
            return render_frame(params, scene, frame_id, cfg, sh_degree=sh_degree).blurred_ldr
        with self._lock:
            fid = self._frame(frame_id, scene)
            key = ("frame", sh_degree, repr(cfg))
            return self._replay(
                key, "render_frame", params, scene,
                lambda: render_frame(params, scene, fid, cfg, sh_degree=sh_degree).blurred_ldr,
            ).clone()

    def _frame(self, frame_id, scene: SceneStatic) -> torch.Tensor:
        """The frame buffer, holding `frame_id`."""
        fid = self._buffer("frame", scene.timestamps, torch.int64)
        if isinstance(frame_id, torch.Tensor):
            fid.copy_(frame_id)
        else:
            fid.fill_(frame_id)
        return fid

    @torch.no_grad()
    def frame_scores(self, params: Params, scene: SceneStatic, frame_id, cfg: ModelConfig,
                     targets: torch.Tensor, sh_degree: Optional[int] = None, mesh=None):
        """`frame_scores(...)`: (image, metric vector), copies."""
        if not cuda_graphs.graphable(scene.timestamps.device, mesh):
            return frame_scores(params, scene, frame_id, cfg, targets, sh_degree, mesh)
        with self._lock:
            fid = self._frame(frame_id, scene)
            key = ("scores", sh_degree, id(mesh), repr(cfg))
            img, vec = self._replay(
                key, "the blurred frame and its metric vector", params, scene,
                lambda: frame_scores(params, scene, fid, cfg, targets, sh_degree, mesh),
                extra=(targets,))
            return img.clone(), vec.clone()

    @torch.no_grad()
    def deblurred_scores(self, params: Params, scene: SceneStatic, frame_id, cfg: ModelConfig,
                         hdr_output: bool = False, sh_degree: Optional[int] = None,
                         exposure=None, targets: Optional[torch.Tensor] = None,
                         inputs: Optional[torch.Tensor] = None, mesh=None):
        """`deblurred_scores(...)`: (image, metric vector or None), copies."""
        if not cuda_graphs.graphable(scene.timestamps.device, mesh):
            return deblurred_scores(params, scene, frame_id, cfg, hdr_output, sh_degree,
                                    exposure, targets, inputs, mesh)
        with self._lock:
            fid = self._frame(frame_id, scene)
            dt = None
            if exposure is not None:
                dt = self._buffer("exposure", scene.timestamps)
                if isinstance(exposure, torch.Tensor):
                    dt.copy_(exposure)
                else:
                    dt.fill_(exposure)
            key = ("deblurred", hdr_output, dt is not None, targets is not None,
                   inputs is not None, sh_degree, id(mesh), repr(cfg))
            img, vec = self._replay(
                key, f"render_deblurred (hdr {hdr_output}, exposure given {dt is not None}, "
                f"scored {targets is not None})", params, scene,
                lambda: deblurred_scores(params, scene, fid, cfg, hdr_output, sh_degree, dt,
                                         targets, inputs, mesh),
                extra=[t for t in (targets, inputs) if t is not None])
            return img.clone(), None if vec is None else vec.clone()


def render_deblurred(
    params: Params,
    scene: SceneStatic,
    frame_id,
    cfg: ModelConfig,
    hdr_output=False,
    sh_degree: Optional[int] = None,
    exposure: Optional[torch.Tensor] = None,
):
    """Deblur a training frame: one sharp render at the mid-exposure pose,
    tone-mapped once.  `exposure` overrides the frame's learned exposure."""
    dt = exposure_of(params, frame_id) if exposure is None else exposure
    t_mid = frame_entry(scene.timestamps, frame_id) + 0.5 * dt
    viewmat = poses_at(params, scene, t_mid.reshape(1), cfg)[0]
    return render_pose(params, scene, viewmat, cfg, exposure=dt,
                       hdr_output=hdr_output, sh_degree=sh_degree)


def frame_scores(params: Params, scene: SceneStatic, frame_id, cfg: ModelConfig,
                 targets: torch.Tensor, sh_degree: Optional[int] = None, mesh=None):
    """The blurred frame B_i of `render_frame` (on a (data, gauss) mesh, of
    parallel/render.py's `render_frame_sharded`) and its metric vector
    [psnr, ssim, ms_ssim] against `targets[frame_id]`, a [F, H, W, 3]
    stack read on the device (`frame_entry`): (image, vector).  The
    counterpart of the reference trainer's `_eval_render` followed by its
    `_metric_vector`."""
    if mesh is None:
        img = render_frame(params, scene, frame_id, cfg, sh_degree=sh_degree).blurred_ldr
    else:
        from casualhdrsplat_torch.parallel import render as prender  # it imports this module

        img = prender.render_frame_sharded(params, scene, frame_id, cfg, mesh,
                                           sh_degree=sh_degree).blurred_ldr
    return img, losses.metric_vector(img, frame_entry(targets, frame_id))


def deblurred_scores(params: Params, scene: SceneStatic, frame_id, cfg: ModelConfig,
                     hdr_output: bool = False, sh_degree: Optional[int] = None, exposure=None,
                     targets: Optional[torch.Tensor] = None,
                     inputs: Optional[torch.Tensor] = None, mesh=None):
    """The image of `render_deblurred` and, given a [F, H, W, 3] stack
    `targets`, its metric vector [psnr, ssim, ms_ssim] against
    `targets[frame_id]`, followed, given `inputs`, by the PSNR of
    `inputs[frame_id]` against the same target: (image, vector or None).
    `exposure` (a number or a device scalar) overrides the frame's own.
    On a (data, gauss) mesh the store is gathered first.  The counterpart
    of the reference trainer's `_eval_render_deblurred`,
    `_eval_render_novel` (`exposure` given) and
    `_eval_render_deblurred_hdr` (`hdr_output`), with `_metric_vector`."""
    if mesh is not None:
        params = sharding.gather_params(params, mesh)
    if exposure is not None and not isinstance(exposure, torch.Tensor):
        # a float32 scalar, as the graphed call's exposure buffer holds it
        exposure = torch.tensor(exposure, dtype=torch.float32, device=scene.timestamps.device)
    img, _, _ = render_deblurred(params, scene, frame_id, cfg, hdr_output=hdr_output,
                                 sh_degree=sh_degree, exposure=exposure)
    if targets is None:
        return img, None
    target = frame_entry(targets, frame_id)
    vec = losses.metric_vector(img, target)
    if inputs is not None:
        vec = torch.cat([vec, losses.psnr(frame_entry(inputs, frame_id), target)[None]])
    return img, vec


def interpolated_log_exposure(params: Params, timestamps, train_indices, frame_id: int) -> float:
    """Host-side: log-exposure estimate for a held-out frame by linear
    interpolation (in time) of the nearest surrounding train frames'
    learned log exposures (clamped at the ends).  `params["log_exposures"]`
    may be a host copy: an evaluation reads it once for all its frames."""
    ts = np.asarray(timestamps)
    le = params["log_exposures"]
    le = le.detach().cpu().numpy() if isinstance(le, torch.Tensor) else np.asarray(le)
    tr = np.asarray(sorted(train_indices))
    return float(np.interp(float(ts[frame_id]), ts[tr], le[tr]))
