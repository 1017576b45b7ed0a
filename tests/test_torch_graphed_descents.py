"""The reference's compiled Adam descents as CUDA graphs
(utils/cuda_graphs.AdamDescent): the pose aligners' `lax.scan`s
(train/pose_align.py) and the CRF's gamma pre-fit `fori_loop`
(models/crf.py); and the mesh training step over NCCL.

On the CPU:
- the descent restructured for a graph (x, Adam's moments, a device step
  count and the loss curve in static tensors; the loss written into the
  curve at the count) equals the eager loop `pose_align._adam_descent` to
  the bit: on a steep quadratic, and the pre-fit on its own loss; the
  pre-fit, now with optax's float32 rounding, tracks the reference's
  within 1e-6 (curve) and 1.5e-5 (parameters);
- each aligner's graphed path, run here through a stand-in for
  GraphedCall that calls the captured function, equals its `.eager` path to
  the bit (the same arithmetic in the same order), and a second call on the
  same parameter and scene tensors reuses the descent (on the card: its
  graph) with the new call's frame, pose and target;
- the realigner's static-shape knot handling (`_with_window_delta`: each
  repeated knot of a clipped window written with a detached update) equals
  the `torch.unique` form it replaced, the knot deltas to the bit and the
  correction's gradient within rtol 1e-6 (a sum over seven rows with zeros
  where the unique form sums four or five), at the first, a middle and the
  last frame; a scatter of every copy counts an end knot's gradient once
  per copy and is told apart.
The captured functions' host reads are counted in
tests/test_torch_graph_safety.py.

On the card (marked `cuda`, skipped here): both aligners and the pre-fit
graphed against their eager twins on the same inputs (equal to the bit:
B1, B2, G1 and T1 are deterministic; otherwise within 1e-4 x the largest +
rtol 1e-3, the card's step tolerance), with the launches a replay counts;
and a world of one over NCCL, mesh (1, 1), whose captured step matches the
eager one from the same state, counts one launch of B1, B2, G1 and its
index a step and the same collectives' calls and bytes; on it also the
graphed density-control round, rebalance and evaluate against their eager
twins, equal to the bit.
"""

import dataclasses
import os
import tempfile

import numpy as np
import pytest
import torch

from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch.data import dataset as t_dataset
from casualhdrsplat_torch.geometry import lie
from casualhdrsplat_torch.models import crf as t_crf
from casualhdrsplat_torch.models import image_formation as imf
from casualhdrsplat_torch.train import pose_align
from casualhdrsplat_torch.train.trainer import Trainer
from casualhdrsplat_torch.utils import cuda_graphs
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

STEPS = 4
XI = [0.02, -0.015, 0.02, 0.01, -0.01, 0.015]


def aligner_cfg():
    """tests/test_torch_pose_align.py's packed config with the MLP CRF."""
    cfg = t_config.TrainConfig(name="graphed-descents")
    cfg.model.max_gaussians = 128
    cfg.model.sh_degree = 1
    cfg.model.num_virtual_views = 4
    cfg.model.crf = t_config.CRFConfig(kind="mlp", hidden=8)
    cfg.model.rasterize = t_config.RasterizeConfig(tile_h=8, tile_w=16,
                                                   max_tiles_per_gaussian=32, chunk=32)
    cfg.densify.enabled = False
    cfg.data.eval_every = 0
    return cfg


def make_trainer(device="cpu"):
    """The aligners' scene: tests/test_torch_pose_align.py's fixture (4
    frames of 32x32, visibly opaque splats)."""
    ds = t_dataset.make_synthetic_dataset(seed=7, n_gaussians=60, n_frames=4, n_virtual=4,
                                          size=32, angle_span=0.8, exposure_range=(0.3, 0.5),
                                          device=device)
    t = Trainer(aligner_cfg(), ds, device=device)
    with torch.no_grad():
        t.params["gaussians"]["opacity_logit"] += 2.0
    return t


@pytest.fixture(scope="module")
def trainer():
    return make_trainer()


def aligner_inputs(t, frame: int):
    """make_aligner's inputs for `frame`: its mid-exposure pose offset by
    XI / 2, the exposure, the clean render."""
    m = t.cfg.model
    with torch.no_grad():
        dt = imf.exposure_of(t.params, frame)
        vm = imf.poses_at(t.params, t.scene, (t.scene.timestamps[frame] + 0.5 * dt)[None], m)[0]
        target, _, _ = imf.render_pose(t.params, t.scene, vm, m, exposure=dt)
        vm_off = lie.mat_mul(lie.se3_exp(torch.tensor(XI, device=vm.device) * 0.5), vm)
    return vm_off, dt, target


def realigner_inputs(t, frame: int):
    """make_window_realigner's inputs for `frame`: the parameters with XI put
    into the frame's window, the frame, its clean blurred render."""
    m = t.cfg.model
    with torch.no_grad():
        target = imf.render_frame(t.params, t.scene, frame, m).blurred_ldr
        xi = torch.tensor(XI, device=target.device)
        broken = pose_align._with_window_delta(t.params, t.scene, frame, xi, 7)
    return broken, frame, target


class CallingStandIn:
    """GraphedCall's stand-in on the CPU: each call runs the function it
    would capture (under `mode` when one is given)."""

    made = []

    def __init__(self, fn, name, capture_error_mode="global", mode=None):
        self.fn, self.name, self.mode = fn, name, mode
        CallingStandIn.made.append(self)

    def __call__(self):
        if self.mode is None:
            return self.fn()
        with self.mode:
            return self.fn()


def use_stand_in(monkeypatch, mode=None):
    """Route AdamDescent's graphed path through CallingStandIn here."""
    CallingStandIn.made = []
    monkeypatch.setattr(cuda_graphs, "graphable", lambda device, mesh=None: True)
    monkeypatch.setattr(cuda_graphs, "GraphedCall",
                        lambda fn, name, capture_error_mode="global":
                        CallingStandIn(fn, name, capture_error_mode, mode))


def test_descent_equals_the_eager_loop_on_a_steep_quadratic():
    rng = np.random.default_rng(4)
    w = torch.as_tensor(rng.uniform(0.1, 50.0, 6).astype(np.float32))
    c = torch.as_tensor(rng.normal(size=6).astype(np.float32))

    def loss(x):
        return torch.sum(w * (x - c) ** 2)

    x0 = torch.as_tensor(rng.normal(size=6).astype(np.float32))
    want_x, want_curve = pose_align._adam_descent(loss, x0, 8, 5e-3)
    descent = cuda_graphs.AdamDescent(loss, x0, 8, 5e-3, "a quadratic")
    for _ in range(2):  # a second descent starts afresh
        x, curve = descent(x0)
        assert torch.equal(x, want_x) and torch.equal(curve, want_curve)
    assert int(descent.count) == 8


def test_prefit_equals_the_eager_loop_on_its_loss():
    cfg = t_config.CRFConfig(hidden=8)
    start = t_crf.create(dataclasses.replace(cfg, init_gamma=0.0), device="cpu")
    keys = list(start)
    got = t_crf._prefit_to_gamma(start, cfg, steps=20)
    e = torch.exp(torch.linspace(cfg.log_min, cfg.log_max, 256))
    target = torch.clamp(e, 0.0, 1.0) ** (1.0 / cfg.init_gamma)
    e3 = e[:, None].repeat(1, 3)
    sizes = [start[k].numel() for k in keys]

    def loss(x):
        p = {k: v.view(start[k].shape) for k, v in zip(keys, torch.split(x, sizes))}
        return torch.mean((t_crf.apply(p, e3, cfg) - target[:, None]) ** 2)

    x, curve = pose_align._adam_descent(loss, torch.cat([start[k].reshape(-1) for k in keys]),
                                        20, 1e-2)
    want = dict(zip(keys, (v.view(start[k].shape) for k, v in zip(keys, torch.split(x, sizes)))))
    assert list(got) == keys
    for k in keys:
        assert torch.equal(got[k], want[k]), k
    assert float(curve[-1]) < float(curve[0])


def test_prefit_tracks_optax():
    """The pre-fit (1,200 steps, 8 units) against the reference's optax
    fori_loop from the same start: with optax's float32 rounding the
    response curves agree within 1e-6 and the parameters within 1.5e-5
    (measured 5.1e-7 and 8.8e-6; tests/test_torch_crf.py holds the curve
    at 1e-4)."""
    import jax

    from casualhdrsplat_tpu import config as j_config
    from casualhdrsplat_tpu.models import crf as j_crf

    cj = j_config.CRFConfig(hidden=8)
    start = j_crf.create(dataclasses.replace(cj, init_gamma=0.0), jax.random.PRNGKey(0))
    fit_j = j_crf._prefit_to_gamma(start, cj)
    ct = t_config.CRFConfig(hidden=8)
    fit_t = t_crf._prefit_to_gamma({k: torch.from_numpy(np.array(v, np.float32))
                                    for k, v in start.items()}, ct)
    for k in fit_t:
        np.testing.assert_allclose(fit_t[k].numpy(), np.asarray(fit_j[k]), rtol=0, atol=1.5e-5,
                                   err_msg=k)
    _, curve_t = t_crf.response_curve(fit_t, ct, device="cpu")
    _, curve_j = j_crf.response_curve(fit_j, cj)
    np.testing.assert_allclose(curve_t.numpy(), np.asarray(curve_j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["aligner", "realigner-middle", "realigner-end"])
def test_graphed_path_equals_eager_on_the_cpu(trainer, monkeypatch, kind):
    t, m = trainer, trainer.cfg.model
    use_stand_in(monkeypatch)
    if kind == "aligner":
        fn = pose_align.make_aligner(m, steps=STEPS, lr=3e-3)
        calls = [(t.params, t.scene, *aligner_inputs(t, f)) for f in (1, 2)]
    else:
        fn = pose_align.make_window_realigner(m, steps=STEPS, lr=5e-3)
        frame = 1 if kind == "realigner-middle" else t.dataset.num_frames - 1
        broken, _, target = realigner_inputs(t, frame)
        other = realigner_inputs(t, frame - 1)
        # the same parameter tensors, another frame and target
        calls = [(broken, t.scene, frame, target), (broken, t.scene, frame - 1, other[2])]
    for args in calls:
        got, want = fn(*args), fn.eager(*args)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert float(got[2][-1]) < float(got[2][0])
    # one descent made, warmed up and captured once, for both calls
    assert len(CallingStandIn.made) == 1


def _unique_form(kd, idx, d):
    """The knot update as the port wrote it before: each knot once."""
    knots = torch.unique(idx)
    upd = lie.se3_log(lie.mat_mul(lie.se3_exp(d), lie.se3_exp(kd[knots])))
    return kd.index_put((knots,), upd)


@pytest.mark.parametrize("where", ["start", "middle", "end"])
def test_window_knots_match_the_unique_form(trainer, where):
    t = trainer
    scene, frame = t.scene, {"start": 0, "middle": 1, "end": t.dataset.num_frames - 1}[where]
    if where == "start":  # the trajectory starts 2.5 knots later: the window clips at 0
        scene = dataclasses.replace(scene, knot_t0=scene.knot_t0 + 2.5 * scene.knot_dt)
    kd = torch.as_tensor(np.random.default_rng(3).normal(0, 0.02, t.params["knot_deltas"].shape),
                         dtype=torch.float32)
    params = {**t.params, "knot_deltas": kd}
    t_i = float(scene.timestamps[frame])
    j0 = int(np.floor((t_i - float(scene.knot_t0)) / float(scene.knot_dt))) - 1
    idx = torch.clamp(torch.arange(j0, j0 + 7), 0, kd.shape[0] - 1)
    repeats = len(torch.unique(idx)) < 7
    assert repeats or where == "middle", idx
    w = torch.as_tensor(np.random.default_rng(5).normal(size=kd.shape), dtype=torch.float32)
    d0 = torch.tensor([0.01, -0.02, 0.015, 0.02, 0.01, -0.01])

    def value_and_grad(update):
        d = d0.clone().requires_grad_(True)
        new = update(d)
        grad, = torch.autograd.grad(torch.sum(w * new), d)
        return new.detach(), grad

    got, g_got = value_and_grad(
        lambda d: pose_align._with_window_delta(params, scene, torch.tensor(frame), d,
                                                7)["knot_deltas"])
    want, g_want = value_and_grad(lambda d: _unique_form(kd, idx, d))
    assert torch.equal(got, want)
    torch.testing.assert_close(g_got, g_want, rtol=1e-6, atol=1e-7 * float(g_want.abs().max()))
    moved = torch.nonzero((got != kd).any(1)).flatten()
    assert set(moved.tolist()) == set(idx.tolist())
    # a scatter of every copy (no detach) counts a repeated knot once per copy
    _, g_all = value_and_grad(lambda d: kd.index_put(
        (idx,), lie.se3_log(lie.mat_mul(lie.se3_exp(d), lie.se3_exp(kd[idx])))))
    assert torch.allclose(g_all, g_want, rtol=1e-4) != repeats


# -- on the card ---------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs run only on the card")
    return torch.device("cuda")


def assert_twins(got, want, what):
    """Equal to the bit, or within 1e-4 x the largest + rtol 1e-3 (the
    card's step tolerance)."""
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            scale = max(float(b.abs().max()), 1e-30)
            torch.testing.assert_close(a, b, atol=1e-4 * scale, rtol=1e-3, msg=what)


@pytest.mark.cuda
def test_graphed_descents_match_eager_on_the_card(cuda):
    from casualhdrsplat_torch.ops import crf_fused
    from casualhdrsplat_torch.ops import rasterize_packed as rp
    from casualhdrsplat_torch.ops import stream_gather as sg

    t = make_trainer(cuda)
    m = t.cfg.model
    kernels = (rp.FWD_KERNEL, rp.BWD_KERNEL, sg.KERNEL, sg.INDEX)
    align = pose_align.make_aligner(m, steps=STEPS, lr=3e-3)
    realign = pose_align.make_window_realigner(m, steps=STEPS, lr=5e-3)
    broken, frame, target = realigner_inputs(t, t.dataset.num_frames - 1)
    for fn, args, b1 in ((align, (t.params, t.scene, *aligner_inputs(t, 1)), STEPS + 1),
                         (realign, (broken, t.scene, frame, target), STEPS)):
        for _ in range(2):  # warm-up and capture, then replays only
            before = [k.launches for k in kernels]
            got = fn(*args)
            launched = [k.launches - b for k, b in zip(kernels, before)]
            assert launched == [b1, STEPS, STEPS, STEPS], launched
            assert_twins(got, fn.eager(*args), fn)
    # the pre-fit: graphed against eager from the same start
    cfg = t_config.CRFConfig(hidden=32)
    start = t_crf.create(dataclasses.replace(cfg, init_gamma=0.0), device=cuda)
    before = crf_fused.FWD_KERNEL.launches, crf_fused.BWD_KERNEL.launches
    got = t_crf._prefit_to_gamma(start, cfg)
    assert (crf_fused.FWD_KERNEL.launches - before[0],
            crf_fused.BWD_KERNEL.launches - before[1]) == (1200, 1200)
    want = t_crf._prefit_to_gamma(start, cfg, graphed=False)
    assert_twins([got[k] for k in start], [want[k] for k in start], "pre-fit")


@pytest.mark.cuda
def test_nccl_world_of_one_graphed_step_matches_eager(cuda):
    import torch.distributed as dist

    from casualhdrsplat_torch.ops import rasterize_packed as rp
    from casualhdrsplat_torch.ops import stream_gather as sg
    from casualhdrsplat_torch.parallel.mesh import Mesh
    from casualhdrsplat_torch.train import optim as t_optim

    ds = t_dataset.make_synthetic_dataset(seed=3, device=cuda, n_gaussians=96, n_frames=3,
                                          n_virtual=2, size=32)
    cfg = aligner_cfg()
    cfg.model.num_virtual_views = 2
    cfg.model.rasterize = dataclasses.replace(cfg.model.rasterize, shared_binning=False)
    cfg.loss.coarse_to_fine_steps = 20  # the blur's sigma from its buffer
    kernels = (rp.FWD_KERNEL, rp.BWD_KERNEL, sg.KERNEL, sg.INDEX)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rdv')}",
                                world_size=1, rank=0)
        try:
            graphed, eager = Trainer(cfg, ds, device=cuda, mesh=Mesh(1, 1)), Trainer(
                cfg, ds, device=cuda, mesh=Mesh(1, 1))
            assert cuda_graphs.graphable(cuda, graphed.mesh)
            for step in range(5):  # warm-up, capture, replays
                outs, counts, stats = [], [], []
                for t, run in ((graphed, graphed.run_step), (eager, eager.run_step_eager)):
                    before = [k.launches for k in kernels]
                    t.mesh.stats.clear()
                    outs.append(run())
                    counts.append([k.launches - b for k, b in zip(kernels, before)])
                    stats.append({k: v[:2] for k, v in t.mesh.stats.items()})
                for key in outs[0]:
                    np.testing.assert_allclose(outs[0][key], outs[1][key], rtol=1e-3, atol=1e-4,
                                               err_msg=key)
                assert counts == [[1] * 4] * 2, (step, counts)
                assert stats[0] == stats[1] and stats[0], (step, stats)
            call = graphed._step_graphs.call
            assert call.captures == 1 and call.replays == 4
            assert any(v[2] is None for v in graphed.mesh.stats.values())
            for (path, _, leaf), (_, _, other) in zip(t_optim.labelled_leaves(graphed.params),
                                                      t_optim.labelled_leaves(eager.params)):
                scale = max(float(other.float().abs().max()), 1e-30)
                torch.testing.assert_close(leaf.float(), other.float(), atol=1e-4 * scale,
                                           rtol=1e-3, msg=str(path))
        finally:
            dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_world_of_one_graphed_round_and_rebalance_match_eager(cuda):
    """On a mesh (1, 1) over NCCL: the sharded density-control round (its
    report's all-reduce inside the graph) and the rebalance (its
    all-gathers inside) graphed against eager from one state with the same
    draws, every tensor of the step equal to the bit, the collectives a
    replay counts the eager call's; and `evaluate` (the store gathered
    inside the deblurred renders' graphs) equal to its eager twin."""
    import torch.distributed as dist

    from casualhdrsplat_torch.parallel.mesh import Mesh
    from test_torch_graph_safety import rounds_graphed_and_eager

    ds = t_dataset.make_synthetic_dataset(seed=3, device=cuda, n_gaussians=96, n_frames=3,
                                          n_virtual=2, size=32)
    cfg = aligner_cfg()
    cfg.model.num_virtual_views = 2
    cfg.model.rasterize = dataclasses.replace(cfg.model.rasterize, shared_binning=False)
    cfg.densify.enabled = True
    cfg.densify.start_iter = 100
    cfg.densify.grad_threshold = 1e-7
    cfg.data.eval_every = 2
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rdv')}",
                                world_size=1, rank=0)
        try:
            t = Trainer(cfg, ds, device=cuda, mesh=Mesh(1, 1))
            assert cuda_graphs.graphable(cuda, t.mesh)
            for _ in range(2):
                t.run_step()
            stats = []
            for what in ("round", "rebalance"):
                t.mesh.stats.clear()
                rounds_graphed_and_eager(t, rebalance=what == "rebalance")
                stats.append({k: v[:2] for k, v in t.mesh.stats.items()})
            # the eager call, the warm-up and two replays (a capture runs none)
            assert stats[0]["densify_report"][0] == 4 and stats[1]["rebalance"][0] > 0
            assert t._round_graphs.call.replays == 2 and t._rebalance_graphs.call.replays == 2
            want = t.evaluate(graphed=False)
            for _ in range(3):
                assert t.evaluate() == want
        finally:
            dist.destroy_process_group()
