"""Test-time pose alignment for deblurred-render evaluation.  Counterpart
of casualhdrsplat_tpu/train/pose_align.py.

The joint problem (trajectory, exposures, CRF and scene all free) can
converge with the camera trajectory a few degrees off the ground truth in
a deformation that is not a similarity (scene and spline co-warp); the
deblurred render is then misaligned with the sharp ground-truth frame and
raw PSNR measures the misalignment, not sharpness.  The standard protocol
of pose-free novel-view synthesis (BARF, BAD-NeRF's test-time pose
optimisation) optimises a small per-image camera correction against the
evaluation target before scoring, with the scene frozen: 6 DoF against
the frame's pixels cannot manufacture sharpness, only remove the offset.

The reference runs each descent as one jitted `lax.scan`: Adam at optax's
defaults (b1 0.9, b2 0.999, eps 1e-8) on the se(3) correction alone.  Here
on a CUDA device one descent step (the render, the loss, autograd, Adam
from a device step count) is captured as a CUDA graph and replayed
`steps` times (utils/cuda_graphs.AdamDescent), reading the call's tensors
from static buffers: the returned function keeps its graph, and a later
call on the same parameter and scene tensors only replays it (the
reference's "keep the returned function to reuse the executable").
Elsewhere, and through each returned function's `.eager`, the descent is
`_adam_descent`, a loop of autograd steps: the yardstick of the graphed
one.  Either way the loss values stay on the device and are read once,
after the descent.
"""

from __future__ import annotations

import functools

import torch

from casualhdrsplat_torch.geometry import lie
from casualhdrsplat_torch.models import image_formation as imf
from casualhdrsplat_torch.models import losses
from casualhdrsplat_torch.utils import cuda_graphs


def _frozen(tree):
    """The parameter tree with every tensor detached: the scene, CRF and
    exposures take no gradient."""
    if isinstance(tree, dict):
        return {k: _frozen(v) for k, v in tree.items()}
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def _adam_descent(loss_fn, x0: torch.Tensor, steps: int, lr: float):
    """`steps` Adam steps on x from x0 (optax.adam's update, its float32
    arithmetic included: `cuda_graphs.adam_update`); returns the final x
    and the loss before each step [steps]."""
    x = x0.detach().clone()
    mu, nu = torch.zeros_like(x), torch.zeros_like(x)
    curve = []
    for count in range(1, steps + 1):
        x.requires_grad_(True)
        val = loss_fn(x)
        grad, = torch.autograd.grad(val, x)
        with torch.no_grad():
            t = torch.full((), count, dtype=torch.int32, device=x.device)
            x, mu, nu = cuda_graphs.adam_update(x.detach(), mu, nu, grad, t, lr)
        curve.append(val.detach())
    return x, torch.stack(curve) if curve else x.new_zeros((0,))


def _descent(graphs: cuda_graphs.GraphCache, name: str, make_loss, params, scene, args,
             steps: int, lr: float, graphed: bool):
    """(d, loss curve): `steps` Adam steps on an se(3) correction d from 0,
    minimising `make_loss(frozen params, scene, *args)(d)`.  With `graphed`
    on a CUDA device through the AdamDescent that `graphs` keeps for these
    parameter and scene tensors, `args` copied into its static buffers
    (the loss it captured reads those); otherwise `_adam_descent`."""
    dev = scene.timestamps.device
    d0 = torch.zeros(6, device=dev)
    if not (graphed and cuda_graphs.graphable(dev)):
        return _adam_descent(make_loss(_frozen(params), scene, *args), d0, steps, lr)

    def make():
        with torch.inference_mode(False):
            buffers = [torch.empty_like(a) for a in args]
        descent = cuda_graphs.AdamDescent(make_loss(_frozen(params), scene, *buffers), d0,
                                          steps, lr, name)
        descent.buffers = buffers
        return descent

    key = tuple((a.shape, a.dtype) for a in args)
    descent = graphs.get(key, imf._tensors(params) + imf._tensors(scene), make)
    with torch.no_grad():
        for buf, a in zip(descent.buffers, args):
            buf.copy_(a)
    return descent(d0)


def make_window_realigner(cfg, steps: int = 48, lr: float = 2e-3, sh_degree=None,
                          knot_support: int = 7):
    """Per-window pose restart: block-coordinate refinement of one frame's
    trajectory window against its blurry captured frame (training data
    only).  One se(3) correction `d` is left-composed (camera frame) onto
    the `knot_support` knots whose cubic support overlaps the frame's
    exposure window, with scene, CRF and exposure frozen, and baked into
    the returned knot deltas (new_delta = log(exp(d) @ exp(delta)), the
    composition of image_formation.effective_knots), so ordinary joint
    training continues from the restarted window.

    Returns `realign(params, scene, frame_id, target) -> (knot_deltas, d,
    loss_curve)`; `realign.eager` is the same through `_adam_descent`, and
    `realign.graphs` the GraphCache of its descent."""

    def make_loss(params, scene, frame_id, target):
        def loss_fn(d):
            p = _with_window_delta(params, scene, frame_id, d, knot_support)
            out = imf.render_frame(p, scene, frame_id, cfg, sh_degree=sh_degree)
            return losses.l1(out.blurred_ldr, target)

        return loss_fn

    graphs = cuda_graphs.GraphCache()

    def run(params, scene, frame_id, target, graphed: bool):
        # the frame as a device tensor: the graphed step reads it from its buffer
        fid = torch.as_tensor(frame_id, dtype=torch.int64, device=scene.timestamps.device)
        d, curve = _descent(graphs, "the window realigner's step", make_loss, params, scene,
                            (fid, target), steps, lr, graphed)
        with torch.no_grad():
            p = _with_window_delta(_frozen(params), scene, fid, d, knot_support)
            return p["knot_deltas"], d, curve

    def realign(params, scene, frame_id, target):
        return run(params, scene, frame_id, target, graphed=True)

    realign.eager = functools.partial(run, graphed=False)
    realign.graphs = graphs
    return realign


def _with_window_delta(params, scene, frame_id, d, knot_support: int):
    """`params` with d left-composed onto the knots of frame `frame_id`'s
    window: the reference's `kd.at[idx].set(upd)`, idx the `knot_support`
    knots from floor((t_i - t0) / dt) - 1 on, clipped to the trajectory,
    computed on the device.

    At either end of the trajectory the clipped range names a knot more
    than once.  The reference's scatter then writes the knot once and
    gives `d` the gradient of that one write; a scatter of every copy
    would count it once per copy.  The range is contiguous and sorted, so
    a copy is a position whose knot equals its predecessor's: those
    positions write the same row with the same value, and their update is
    detached, so that each knot's gradient is counted once (static shapes:
    no `torch.unique`)."""
    kd = params["knot_deltas"]
    t_i = imf.frame_entry(scene.timestamps, frame_id)
    j0 = torch.floor((t_i - scene.knot_t0) / scene.knot_dt).to(torch.int64) - 1
    idx = torch.clamp(j0 + torch.arange(knot_support, device=kd.device), 0, kd.shape[0] - 1)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=kd.device), idx[1:] != idx[:-1]])
    upd = lie.se3_log(lie.mat_mul(lie.se3_exp(d), lie.se3_exp(kd[idx])))
    upd = torch.where(first[:, None], upd, upd.detach())
    return {**params, "knot_deltas": kd.index_put((idx,), upd)}


def make_aligner(cfg, steps: int = 48, lr: float = 2e-3, sh_degree=None):
    """Returns `align(params, scene, viewmat0, exposure, target) ->
    (aligned_ldr, delta, loss_curve)`: Adam on an se(3) delta applied to
    the eval viewmat (left-composed), minimising the mean squared error of
    the render at `exposure` against `target`.  `cfg` is the ModelConfig.
    Keep the returned function to reuse its graph across eval frames;
    `align.eager` is the same through `_adam_descent`, and `align.graphs`
    the GraphCache of its descent."""

    def renderer(params, scene, viewmat0, exposure):
        def render(delta):
            vm = lie.mat_mul(lie.se3_exp(delta), viewmat0)
            ldr, _, _ = imf.render_pose(params, scene, vm, cfg, exposure=exposure,
                                        sh_degree=sh_degree)
            return ldr

        return render

    def make_loss(params, scene, viewmat0, exposure, target):
        render = renderer(params, scene, viewmat0, exposure)
        return lambda delta: torch.mean(torch.square(render(delta) - target))

    graphs = cuda_graphs.GraphCache()

    def run(params, scene, viewmat0, exposure, target, graphed: bool):
        exposure = torch.as_tensor(exposure, dtype=torch.float32, device=viewmat0.device)
        delta, curve = _descent(graphs, "the pose aligner's step", make_loss, params, scene,
                                (viewmat0, exposure, target), steps, lr, graphed)
        with torch.no_grad():
            return renderer(_frozen(params), scene, viewmat0, exposure)(delta), delta, curve

    def align(params, scene, viewmat0, exposure, target):
        return run(params, scene, viewmat0, exposure, target, graphed=True)

    align.eager = functools.partial(run, graphed=False)
    align.graphs = graphs
    return align
