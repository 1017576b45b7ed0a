"""The functions the port captures as CUDA graphs (utils/cuda_graphs.py)
make no host read and no copy of Python numbers to the device, and the
trainer keeps a graph from reading stale tensors.

A CUDA graph cannot hold a device-to-host read (`.item()`, `bool()`,
`.tolist()`, `int()`, which reduce to `aten._local_scalar_dense`; a
data-dependent shape: `aten.nonzero`, `aten._unique2`) nor a tensor made
from Python data (`aten.lift_fresh`, on the card a copy from the host).
`HostReads`, a TorchDispatchMode, counts those ops while the captured
functions run on CPU tensors: the packed and dense `Trainer._train_step`
(also on a mesh (1, 1) over gloo: the collectives and the sharded
render), `render_pose` in its three modes, the blurred frame of `entry()`,
bench's step and its sharded step, the packed stream gather with its
backward and the inverse index that kernel G1 reads on the card, and one
step of each Adam descent the port captures (`cuda_graphs.AdamDescent`:
`make_aligner`'s, `make_window_realigner`'s at a middle and at the last
frame, whose window repeats a knot, and the CRF's gamma pre-fit), run
through their graphed path with a stand-in for GraphedCall that calls the
function it would capture.  Each must count zero.  A gloo mesh is not
graphable (its collectives run on the host): the trainer and bench step
it eagerly.
The plain versions of the compositor kernels (B1-B4) are left out of the
count: on the card the kernels run in their place.

Also on the CPU: the plain version of kernel B1 (and of B2) treats a row
whose bounds leave the stream as empty, so the launcher needs no host read
to check them; the device-count Adam (`Optimizer.apply`) follows optax
across the pose schedule's warm-up and rewarm boundaries; a density-
control round, the opacity reset and the rebalance write the trainer's
tensors in place, and a `load` (which rebinds them) makes the graph cache
capture again.

On the card (marked `cuda`, skipped here): the graphed training step
against the eager one from the same state on both rasterizer paths,
across a densify round and an opacity reset (every parameter group within
1e-4 x its largest + rtol 1e-3, the card-vs-CPU step tolerance: B4's
float atomics add in an order that changes from run to run, and the
step's library kernels, cuDNN's among them, need not be deterministic);
the graphed `render_pose` equal to the
eager one to the bit; the kernels' launch counts per replay; a failed
capture raising with the op named; and graphs made and dropped one after
another leaving no memory behind (their warm-ups and captures share one
side stream, so no cuBLAS workspace is left on a stream of their own).
"""

import dataclasses
import gc
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import test_torch_graphed_descents as descents
import torch_parallel_cases as cases
from casualhdrsplat_torch import bench as t_bench
from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch import entry as t_entry
from casualhdrsplat_torch.data import dataset as t_dataset
from casualhdrsplat_torch.models import crf as t_crf
from casualhdrsplat_torch.models import image_formation as imf
from casualhdrsplat_torch.ops import binning
from casualhdrsplat_torch.ops import composite
from casualhdrsplat_torch.ops import rasterize_packed as rp
from casualhdrsplat_torch.ops import stream_gather
from casualhdrsplat_torch.ops.composite import CompositeStatics
from casualhdrsplat_torch.train import optim as t_optim
from casualhdrsplat_torch.train import pose_align
from casualhdrsplat_torch.train.trainer import Trainer
from casualhdrsplat_torch.utils import cuda_graphs

HOST_OPS = ("aten._local_scalar_dense.default", "aten.nonzero.default",
            "aten._unique2.default", "aten.lift_fresh.default",
            # data-dependent shapes as well: a sync on the card
            "aten.masked_select.default", "aten.unique_consecutive.default",
            "aten.repeat_interleave.Tensor")
# indexing with a boolean mask finds its nonzeros inside the op
MASK_INDEX_OPS = ("aten.index.Tensor", "aten.index_put.default", "aten.index_put_.default",
                  "aten._index_put_impl_.default")
# the plain versions of the compositor kernels: the kernels on the card
KERNEL_STAND_INS = (
    (rp, "composite_stream_reference"), (rp, "composite_stream_backward_reference"),
    (composite, "composite_tile_lists_reference"),
    (composite, "composite_tile_lists_backward_reference"),
)


class HostReads(TorchDispatchMode):
    """Counts the ops a CUDA graph cannot hold, with where each came from,
    except while a kernel's stand-in runs."""

    def __init__(self):
        super().__init__()
        self.found = []
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name in MASK_INDEX_OPS and any(
                i is not None and i.dtype in (torch.bool, torch.uint8) for i in args[1]):
            name = f"{name} with a boolean mask"
        if not self.paused and (name in HOST_OPS or name.endswith("boolean mask")):
            where = [f"{f.filename.rsplit('/', 2)[-1]}:{f.lineno}"
                     for f in traceback.extract_stack()[:-1]]
            self.found.append((name, where[-4:]))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def host_reads(monkeypatch):
    mode = HostReads()
    for module, name in KERNEL_STAND_INS:
        original = getattr(module, name)

        def paused(*args, _original=original, **kw):
            mode.paused += 1
            try:
                return _original(*args, **kw)
            finally:
                mode.paused -= 1

        monkeypatch.setattr(module, name, paused)
    return mode


def _train_cfg(packed: bool, densify: bool = False):
    cfg = t_config.TrainConfig()
    cfg.model = t_config.ModelConfig(
        max_gaussians=128, sh_degree=1, num_virtual_views=2, crf=t_config.CRFConfig(hidden=8),
        rasterize=t_config.RasterizeConfig(tile_h=8, tile_w=16, chunk=32, packed=packed,
                                           tile_capacity=64, stream_factor=8))
    cfg.densify.enabled = densify
    cfg.densify.start_iter = cfg.densify.interval = 2
    cfg.densify.opacity_reset_interval = 3
    cfg.densify.sh_degree_interval = 1
    cfg.densify.grad_threshold = 1e-7  # every visible Gaussian asks
    cfg.loss.coarse_to_fine_steps = 20  # the blur's sigma comes from its buffer
    cfg.data.eval_every = 0
    return cfg


def _dataset(device="cpu"):
    return t_dataset.make_synthetic_dataset(seed=3, device=device, n_gaussians=96, n_frames=3,
                                            n_virtual=2, size=32)


@pytest.fixture(scope="module")
def dataset():
    return _dataset()


def test_host_reads_sees_what_it_counts(host_reads):
    x = torch.arange(4.0)
    with host_reads:
        float(x.sum())
        torch.nonzero(x)
        torch.unique(x)
        x[x > 1]
        x[x > 1] = 0.0
        torch.tensor([1.0, 2.0])
        x[1:2].fill_(2.0)  # no read
        x.index_select(0, torch.arange(2))  # no read
    assert [op for op, _ in host_reads.found] == [
        "aten._local_scalar_dense.default", "aten.nonzero.default", "aten._unique2.default",
        "aten.index.Tensor with a boolean mask",
        "aten.lift_fresh.default", "aten.index_put_.default with a boolean mask",  # x[m] = 0.0
        "aten.lift_fresh.default"]


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_train_step_makes_no_host_read(host_reads, dataset, packed):
    t = Trainer(_train_cfg(packed), dataset, device="cpu")
    t._frame_buf.fill_(1)
    t._sigma_buf.fill_(1.5)
    t.opt.count_buffer(t.device).fill_(0)
    before = [x.clone() for x in t._step_tensors()]
    with host_reads:
        scalars = t._train_step(t._frame_buf, t._sigma_buf, t.active_sh_degree())
    assert host_reads.found == []
    assert scalars.shape == (4,) and bool(torch.isfinite(scalars).all())
    # it did train: Adam moved the store, the statistics rose
    assert not torch.equal(before[0], t.params["gaussians"]["means"])
    assert int(t.adc.count.sum()) > 0


@pytest.mark.parametrize("mode", ["ldr", "hdr", "depth"])
def test_render_pose_makes_no_host_read(host_reads, dataset, mode):
    t = Trainer(_train_cfg(True), dataset, device="cpu")
    vm = torch.as_tensor(dataset.viewmats[1]).clone()
    dt = torch.tensor(0.4)
    with host_reads, torch.no_grad():
        img, alpha, _ = imf.render_pose(t.params, t.scene, vm, t.cfg.model, exposure=dt,
                                        hdr_output=mode == "hdr", depth_output=mode == "depth")
    assert host_reads.found == []
    assert img.shape[:2] == alpha.shape == (32, 32)


def test_entry_forward_makes_no_host_read(host_reads):
    _, cfg, scene, params = t_entry._tiny_setup(device="cpu")
    frame = torch.tensor(1)
    with host_reads, torch.no_grad():
        out = imf.render_frame(params, scene, frame, cfg).blurred_ldr
    assert host_reads.found == []
    with torch.no_grad():
        torch.testing.assert_close(out, imf.render_frame(params, scene, 1, cfg).blurred_ldr,
                                   rtol=0, atol=0)


def test_bench_step_makes_no_host_read(host_reads):
    step, args, _ = t_bench.build(n_gaussians=300, size=48, n_virtual=2, chunk=32,
                                  tile=(8, 16), device="cpu")
    with host_reads:
        loss, grads = step.eager(*args)
    assert host_reads.found == []
    assert np.isfinite(float(loss)) and grads[0].shape == args[0].shape


@pytest.fixture(scope="module")
def descent_trainer():
    return descents.make_trainer()


@pytest.mark.parametrize("kind", ["aligner", "realigner-middle", "realigner-end", "crf_prefit"])
def test_descent_step_makes_no_host_read(host_reads, monkeypatch, descent_trainer, kind):
    """One step of the descent, as the graphed path captures it."""
    t, m = descent_trainer, descent_trainer.cfg.model
    descents.use_stand_in(monkeypatch, mode=host_reads)
    if kind == "aligner":
        out = pose_align.make_aligner(m, steps=1)(t.params, t.scene,
                                                  *descents.aligner_inputs(t, 1))
    elif kind == "crf_prefit":
        out = t_crf._prefit_to_gamma(t.params["crf"], m.crf, steps=1)
    else:
        frame = 1 if kind == "realigner-middle" else t.dataset.num_frames - 1
        broken, _, target = descents.realigner_inputs(t, frame)
        out = pose_align.make_window_realigner(m, steps=1)(broken, t.scene, frame, target)
    assert len(descents.CallingStandIn.made) == 1
    assert host_reads.found == []
    if kind != "crf_prefit":
        assert out[2].shape == (1,) and bool(torch.isfinite(out[2]).all())


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo world of one in this process and its mesh (1, 1)."""
    import torch.distributed as dist

    from casualhdrsplat_torch.parallel.mesh import Mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0)
    try:
        yield Mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_mesh_train_step_makes_no_host_read(host_reads, dataset, world_of_one, packed):
    cfg = cases.trainer_cfg(1, 1)
    cfg.model.rasterize = dataclasses.replace(cfg.model.rasterize, packed=packed)
    cfg.loss.coarse_to_fine_steps = 20  # the blur's sigma comes from its buffer
    t = Trainer(cfg, dataset, device="cpu", mesh=world_of_one)
    # gloo runs its collectives on the host: this mesh steps eagerly, on any device
    assert world_of_one.backends() == {"gloo"}
    assert not cuda_graphs.graphable("cuda", world_of_one)
    t._frame_buf.fill_(1)
    t._sigma_buf.fill_(1.5)
    t.opt.count_buffer(t.device).fill_(0)
    before = t.params["gaussians"]["means"].clone()
    with host_reads:
        scalars = t._train_step(t._frame_buf, t._sigma_buf, t.active_sh_degree())
    assert host_reads.found == []
    assert scalars.shape == (4,) and bool(torch.isfinite(scalars).all())
    assert not torch.equal(before, t.params["gaussians"]["means"])
    assert world_of_one.stats and all(v[0] > 0 for v in world_of_one.stats.values())
    out = t.run_step()  # eager: no graph on gloo
    assert t._step_graphs.call is None and np.isfinite(out["loss"])


@pytest.mark.parametrize("kind", ["blurred", "deblurred", "novel", "hdr"])
def test_eval_render_and_metric_vector_make_no_host_read(host_reads, kind):
    """The functions `evaluate` and quality_run capture: a render and its
    metric vector against a target stack read through the frame buffer
    (the deblurred view also the input's own PSNR, the novel view at an
    exposure from its buffer)."""
    ds = _dataset()
    t = Trainer(_train_cfg(True), ds, device="cpu")
    sharp = torch.as_tensor(ds.sharp_images)
    frame, dt = torch.tensor(1), torch.tensor(0.4)
    m = t.cfg.model
    with host_reads, torch.no_grad():
        if kind == "blurred":
            img, vec = imf.frame_scores(t.params, t.scene, frame, m, t.images, 1)
        else:
            img, vec = imf.deblurred_scores(
                t.params, t.scene, frame, m, hdr_output=kind == "hdr", sh_degree=1,
                exposure=dt if kind == "novel" else None,
                targets=None if kind == "hdr" else sharp,
                inputs=t.images if kind == "deblurred" else None)
    assert host_reads.found == []
    assert img.shape == (32, 32, 3)
    assert (vec is None) == (kind == "hdr")
    if vec is not None:
        assert vec.shape == ((4,) if kind == "deblurred" else (3,))
        assert bool(torch.isfinite(vec).all())


@pytest.mark.parametrize("screen_prune,prune_only", [(False, False), (True, False), (True, True)],
                         ids=["densify", "screen_prune", "prune_only"])
def test_density_control_round_makes_no_host_read(host_reads, dataset, screen_prune,
                                                  prune_only):
    """The body of the captured round (`Trainer._round`), its split noise
    read from the static buffer `densify.SplitNoise` fills."""
    from casualhdrsplat_torch.train import densify as t_densify

    cfg = _train_cfg(True, densify=True)
    cfg.densify.start_iter = 100  # no round yet: statistics and free slots to act on
    t = Trainer(cfg, dataset, device="cpu")
    for _ in range(2):
        t.run_step()
    tensors = t._step_tensors()
    t._noise = t_densify.SplitNoise(t._capacity(), t.device)
    t._noise.draw(t._adc_generator)
    with host_reads:
        report = t._round(screen_prune, prune_only)
    assert host_reads.found == []
    assert report.shape == (4,) and int(report[3]) == int(t.params["gaussians"]["alive"].sum())
    assert (int(report[0] + report[1]) > 0) != prune_only  # it did clone or split
    assert all(a is b for a, b in zip(t._step_tensors(), tensors))
    assert int(t.adc.count.sum()) == 0


def test_mesh_round_rebalance_and_eval_make_no_host_read(host_reads, dataset, world_of_one):
    """On the CPU world of one (gloo): the sharded round, the rebalance and
    the mesh's eval renders (the store gathered inside the deblurred one)."""
    from casualhdrsplat_torch.train import densify as t_densify

    cfg = cases.trainer_cfg(1, 1)
    t = Trainer(cfg, dataset, device="cpu", mesh=world_of_one)
    t.run_step()
    t._noise = t_densify.SplitNoise(t._capacity(), t.device)
    t._noise.draw(t._adc_generator)
    sharp = torch.as_tensor(dataset.sharp_images)
    frame = torch.tensor(1)
    m = t.cfg.model
    with host_reads, torch.no_grad():
        report = t._round(True, False)
        t._rebalance_body()
        _, blurred = imf.frame_scores(t.params, t.scene, frame, m, t.images, 1, world_of_one)
        _, sharp_vec = imf.deblurred_scores(t.params, t.scene, frame, m, sh_degree=1,
                                            targets=sharp, inputs=t.images, mesh=world_of_one)
    assert host_reads.found == []
    assert report.shape == (4,) and blurred.shape == (3,) and sharp_vec.shape == (4,)
    assert {"densify_report", "rebalance", "gather_state"} <= set(world_of_one.stats)


def test_sharded_bench_step_makes_no_host_read(host_reads, world_of_one):
    step, (block,), _ = t_bench.build_sharded(**cases.BENCH_TINY, mesh=world_of_one,
                                              device="cpu")
    with host_reads:
        loss, grads = step.eager(block)
    assert host_reads.found == []
    assert np.isfinite(float(loss)) and grads["means"].shape == block["means"].shape


@pytest.mark.parametrize("per_view", [False, True], ids=["shared", "per_view"])
def test_stream_gather_makes_no_host_read(host_reads, per_view):
    """The gather, its backward (the plain version here), and the inverse
    index that the card's backward builds for kernel G1."""
    payload = torch.randn(3, 11, 16, requires_grad=True)
    ids = torch.randint(0, 11, (3, 40) if per_view else (40,), dtype=torch.int32)
    with host_reads:
        out = stream_gather.gather_stream(payload, ids)
        grad, = torch.autograd.grad(out, payload, torch.ones_like(out))
        offsets, slots = stream_gather.inverse_index(ids, 11)
    assert host_reads.found == []
    assert grad.shape == payload.shape and slots.shape == (ids.numel(),)
    assert offsets.shape == (11 * (3 if per_view else 1) + 1,)


def test_plain_b1_and_b2_treat_rows_outside_the_stream_as_empty():
    stream, (bad_lo, bad_hi), _, statics = _rows_outside_case()
    rng = np.random.default_rng(6)
    good_lo = torch.tensor([0, 5, 12, 20], dtype=torch.int32)
    good_hi = torch.tensor([5, 12, 20, 31], dtype=torch.int32)
    out = rp.composite_stream_reference(stream, bad_lo, bad_hi, statics)
    want = rp.composite_stream_reference(stream, good_lo, good_hi, statics)
    torch.testing.assert_close(out[0], want[0], rtol=0, atol=0)
    assert float(want[1:4].abs().max()) > 0.0 and float(out[1:].abs().max()) == 0.0
    g4 = torch.as_tensor(rng.normal(size=out.shape), dtype=torch.float32)
    d = rp.composite_stream_backward_reference(stream, bad_lo, bad_hi, out, g4, statics)
    d_want = rp.composite_stream_backward_reference(stream, good_lo[:1], good_hi[:1],
                                                    want[[0, 4]], g4[[0, 4]], statics)
    torch.testing.assert_close(d, d_want, rtol=0, atol=0)
    assert float(d[5:].abs().max()) == 0.0
    # the differentiable function takes them too, with no host read of the bounds
    torch.testing.assert_close(rp.composite_stream(stream, bad_lo, bad_hi, statics), out)


def _rows_outside_case(device="cpu"):
    """A small stream and row bounds, some of which leave it: (stream,
    bounds with rows outside, the same rows made empty, statics)."""
    statics = CompositeStatics(num_views=1, ntx=2, nty=2, tile_h=4, tile_w=4, chunk=8,
                               alpha_clip=0.99, alpha_threshold=1 / 255,
                               transmittance_eps=1e-4, backend="pallas")
    rng = np.random.default_rng(5)
    stream = torch.zeros(32, binning.PAYLOAD_DIM)
    stream[:, 0:2] = torch.as_tensor(rng.uniform(0, 8, (32, 2)), dtype=torch.float32)
    stream[:, 2] = stream[:, 4] = 0.3
    stream[:, 5] = 0.6
    stream[:, 6:10] = 1.0
    i32 = dict(dtype=torch.int32, device=device)
    # row 1 starts before the stream, row 2 ends past it, row 3 ends before it starts
    bad = (torch.tensor([0, -3, 12, 25], **i32), torch.tensor([5, 12, 40, 20], **i32))
    empty = (torch.tensor([0, 0, 0, 0], **i32), torch.tensor([5, 0, 0, 0], **i32))
    return stream.to(device), bad, empty, statics


def test_device_count_adam_follows_optax_across_the_pose_boundaries():
    """The pose group's learning rate evaluated from the device count
    (`_Group.step_scale`, float32 as optax) at every count through the
    warm-up (3 updates at 0), the decay and the rewarm at 8: rtol 2e-7
    (one float32 rounding: torch's and XLA's pow may round the last bit
    differently); then 12 updates of a parameter tree by both optimizers
    from the same gradients, the pose leaf after each within atol 1e-7 x
    its largest + rtol 1e-6 (measured: ~1e-7 of the largest)."""
    import jax
    import jax.numpy as jnp

    from casualhdrsplat_tpu import config as j_config
    from casualhdrsplat_tpu.train import optim as j_optim

    kw = dict(max_steps=40, pose_warmup_steps=3, pose_lr_rewarm_step=8)
    sched_j = j_optim.pose_schedule(j_config.OptimConfig(**kw))
    opt_t = t_optim.make_optimizer(t_config.OptimConfig(**kw))
    pose = opt_t.groups["pose"]
    for count in range(14):
        got = -float(pose.step_scale(torch.tensor(count, dtype=torch.int32)))
        want = float(sched_j(jnp.asarray(count, jnp.int32)))
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=0, err_msg=str(count))
        assert (got == 0.0) == (count < 3)

    rng = np.random.default_rng(11)
    knots = rng.normal(0, 0.01, (5, 6)).astype(np.float32)
    params = {"gaussians": {"means": rng.normal(size=(4, 3)).astype(np.float32),
                            "alive": np.ones(4, bool)},
              "knot_deltas": knots, "log_exposures": np.zeros(3, np.float32), "crf": {}}
    opt_j = j_optim.make_optimizer(j_config.OptimConfig(**kw))
    p_j = jax.tree.map(jnp.asarray, params)
    s_j = opt_j.init(p_j)
    update_j = jax.jit(lambda g, s, p: opt_j.update(g, s, p))
    p_t = {"gaussians": {k: torch.as_tensor(v).clone() for k, v in params["gaussians"].items()},
           "knot_deltas": torch.as_tensor(knots).clone(),
           "log_exposures": torch.zeros(3), "crf": {}}
    s_t = opt_t.init(p_t)
    for step in range(12):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 1e-3,
                             params)
        grads["gaussians"]["alive"] = np.zeros(4, bool)
        updates, s_j = update_j(jax.tree.map(jnp.asarray, grads), s_j, p_j)
        p_j = jax.tree.map(lambda a, u: a + u if a.dtype != jnp.bool_ else a, p_j, updates)
        g_t = {"gaussians": {k: torch.as_tensor(v) for k, v in grads["gaussians"].items()},
               "knot_deltas": torch.as_tensor(grads["knot_deltas"]),
               "log_exposures": torch.as_tensor(grads["log_exposures"]), "crf": {}}
        s_t = opt_t.update(g_t, s_t, p_t)
        want = np.asarray(p_j["knot_deltas"])
        np.testing.assert_allclose(p_t["knot_deltas"].numpy(), want,
                                   atol=1e-7 * float(np.abs(want).max()), rtol=1e-6,
                                   err_msg=f"after update {step + 1}")
    assert s_t["count"] == 12


def test_density_control_writes_the_step_tensors_in_place(dataset, tmp_path):
    t = Trainer(_train_cfg(True, densify=True), dataset, device="cpu")
    cache, made = cuda_graphs.GraphCache(), []

    def get():
        return cache.get("key", t._step_tensors(), lambda: made.append(object()) or made[-1])

    first = get()
    tensors = t._step_tensors()
    rounds = 0
    for _ in range(4):  # a densify round at step 2, the opacity reset at step 3
        out = t.run_step()
        rounds += "alive" in out
        assert all(a is b for a, b in zip(t._step_tensors(), tensors))
        assert get() is first
    assert rounds >= 1
    assert float(torch.sigmoid(t.params["gaussians"]["opacity_logit"]).max()) < 0.5
    # a load rebinds the tensors: the cache makes (captures) a new graph
    path = t.save(str(tmp_path))
    t.load(path)
    assert get() is not first and len(made) == 2


def test_rebalance_writes_in_place(dataset):
    """`_write_state` with a rebalanced store (new tensors for every leaf):
    the trainer's tensors stay, their values are the new ones."""
    t = Trainer(_train_cfg(True), dataset, device="cpu")
    tensors = t._step_tensors()
    gauss = {k: v.flip(0).clone() for k, v in t.params["gaussians"].items()}
    opt = {m: {"gaussians": {k: v.flip(0).clone() for k, v in
                             t.opt_state[m]["gaussians"].items()}} for m in ("mu", "nu")}
    adc = type(t.adc)(*(x.flip(0).clone() + 1 for x in t.adc))
    t._write_state(gauss, opt, adc)
    assert all(a is b for a, b in zip(t._step_tensors(), tensors))
    for k, v in gauss.items():
        assert torch.equal(t.params["gaussians"][k], v)
    assert torch.equal(t.adc.count, adc.count)


def test_graph_cache_keys():
    cache = cuda_graphs.GraphCache()
    a, b = torch.zeros(2), torch.zeros(2)
    one = cache.get(1, (a, b), object)
    assert cache.get(1, (a, b), object) is one
    assert cache.get(1, (a, b.clone()), object) is not one  # another tensor
    two = cache.get(2, (a, b), object)
    assert cache.get(2, (a, b), object) is two and cache.get(1, (a, b), object) is not two


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA graphs run only on the card")
    return torch.device("cuda")


def _twins(packed, device):
    """Two trainers from the same state on the card."""
    ds = _dataset(device)
    cfg = _train_cfg(packed, densify=True)
    return Trainer(cfg, ds, device=device), Trainer(dataclasses.replace(cfg), ds, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_graphed_step_matches_eager_across_a_densify_round(cuda, packed):
    from casualhdrsplat_torch.ops import crf_fused
    from casualhdrsplat_torch.ops import rasterize_dense as rd

    graphed, eager = _twins(packed, cuda)
    kernels = (rp.FWD_KERNEL, rp.BWD_KERNEL) if packed else (rd.FWD_KERNEL, rd.BWD_KERNEL)
    kernels += (crf_fused.FWD_KERNEL, crf_fused.BWD_KERNEL)
    if packed:  # G1 and the counting pass that builds its index
        kernels += (stream_gather.KERNEL, stream_gather.INDEX)
    for step in range(6):  # warm-up, capture, replays; a round at 2 and 4, a reset at 3
        before = [k.launches for k in kernels]
        a = graphed.run_step()
        mid = [k.launches for k in kernels]
        b = eager.run_step_eager()
        after = [k.launches for k in kernels]
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_allclose(a[key], b[key], rtol=1e-3, atol=1e-4, err_msg=key)
        # a replay counts the launches the eager step makes (B1/B2 or B3/B4
        # once, T1 once for the frame and once for each CRF prior's curve,
        # G1 and its index once)
        graphed_n = [m - n for m, n in zip(mid, before)]
        assert graphed_n == [x - m for x, m in zip(after, mid)] and graphed_n[0] == 1, step
    call = graphed._step_graphs.call
    assert call.captures == 1 and call.replays >= 3
    for (path, label, leaf), (_, _, other) in zip(t_optim.labelled_leaves(graphed.params),
                                                  t_optim.labelled_leaves(eager.params)):
        scale = max(float(other.float().abs().max()), 1e-30)
        torch.testing.assert_close(leaf.float(), other.float(), atol=1e-4 * scale, rtol=1e-3,
                                   msg=str(path))


@pytest.mark.cuda
def test_graphed_render_pose_equals_eager(cuda):
    t, _ = _twins(True, cuda)
    vm = torch.as_tensor(t.dataset.viewmats[1], device=cuda)
    for mode in ("ldr", "hdr", "depth", "ldr"):
        for exposure in (0.3, 0.7, 0.5):  # warm-up, capture, replay
            kw = dict(exposure=torch.tensor(exposure, device=cuda), hdr_output=mode == "hdr",
                      depth_output=mode == "depth")
            got = t.renders.render_pose(t.params, t.scene, vm, t.cfg.model, **kw)
            with torch.no_grad():
                want = imf.render_pose(t.params, t.scene, vm, t.cfg.model, **kw)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), mode


def snapshot(t):
    """Every tensor of the step and the split-noise generator's state."""
    return [x.clone() for x in t._step_tensors()], t._adc_generator.get_state()


def restore(t, state):
    """Put a `snapshot` back, in place (the graphs keep reading them)."""
    tensors, generator = state
    with torch.no_grad():
        for dst, src in zip(t._step_tensors(), tensors):
            dst.copy_(src)
    t._adc_generator.set_state(generator)


def rounds_graphed_and_eager(t, calls=3, rebalance=False):
    """From one state, the round (or the rebalance) `calls` times through
    its graph (warm-up, capture, replays) and once eagerly, each from that
    state with the same draws: every tensor of the step and the report
    equal to the bit."""
    start = snapshot(t)
    run = (lambda graphed: t._rebalance(graphed)) if rebalance else (
        lambda graphed: t._densify(True, graphed=graphed))
    out = run(False)
    want = (snapshot(t)[0], None if out is None else torch.stack(list(out)).cpu())
    for _ in range(calls):
        restore(t, start)
        out = run(True)
        got = (snapshot(t)[0], None if out is None else torch.stack(list(out)).cpu())
        assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
        assert (got[1] is None and want[1] is None) or torch.equal(got[1], want[1])
    return want[1]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_graphed_round_equals_eager(cuda, packed):
    cfg = _train_cfg(packed, densify=True)
    cfg.densify.start_iter = 100  # the round below is the first
    t = Trainer(cfg, _dataset(cuda), device=cuda)
    for _ in range(2):
        t.run_step()
    report = rounds_graphed_and_eager(t)
    assert int(report[0] + report[1]) > 0
    call = t._round_graphs.call
    assert call.captures == 1 and call.replays == 2


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_graphed_evaluate_equals_eager(cuda, packed):
    """Frames 0 and 2 held out: the blurred, deblurred and novel views and
    their metric vectors, graphed (warm-up, capture, replay) against eager,
    equal to the bit, with the same launches of the forward kernels."""
    from casualhdrsplat_torch.ops import crf_fused
    from casualhdrsplat_torch.ops import rasterize_dense as rd

    cfg = _train_cfg(packed)
    cfg.data.eval_every = 2
    t = Trainer(cfg, _dataset(cuda), device=cuda)
    kernels = (rp.FWD_KERNEL if packed else rd.FWD_KERNEL, crf_fused.FWD_KERNEL)
    want = t.evaluate(graphed=False)
    assert "eval_novel_psnr" in want
    for _ in range(3):
        before = [k.launches for k in kernels]
        got = t.evaluate()
        assert got == want
        # two frames, three renders each, one launch of each kernel a render
        assert [k.launches - b for k, b in zip(kernels, before)] == [6, 6]
    # six calls of each graph: the warm-up, the capture and four replays
    assert all(c.call.captures == 1 and c.call.replays == 5
               for c in t.renders._graphs.values())


@pytest.mark.cuda
def test_kernels_treat_rows_outside_the_stream_as_empty(cuda):
    """B1 and B2 on the card: rows whose bounds leave the stream composite
    nothing and own no slot, as the same rows made empty, to the bit."""
    stream, bad, empty, statics = _rows_outside_case(cuda)
    order = rp.row_order(*bad)
    out = rp._forward_cuda(stream, *bad, order, statics)
    want = rp._forward_cuda(stream, *empty, rp.row_order(*empty), statics)
    assert torch.equal(out, want) and float(out[1:].abs().max()) == 0.0
    g4 = torch.ones_like(out)
    d = rp._backward_cuda(stream, *bad, order, out, g4, statics)
    d_want = rp._backward_cuda(stream, *empty, rp.row_order(*empty), want, g4, statics)
    assert torch.equal(d, d_want) and float(d[5:].abs().max()) == 0.0
    plain = rp.composite_stream_reference(stream.cpu(), *(b.cpu() for b in bad), statics)
    torch.testing.assert_close(out.cpu(), plain, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_dropped_graphs_leave_no_memory_behind(cuda):
    x = torch.randn(64, 64, device=cuda)
    want = x @ x  # the current stream's cuBLAS workspace, kept for the process
    first = cuda_graphs.GraphedCall(lambda: x @ x, "a matmul")
    first(), first()  # the side stream's
    del first
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for _ in range(4):
        call = cuda_graphs.GraphedCall(lambda: x @ x, "a matmul")
        for _ in range(3):  # warm-up, capture, replay
            assert torch.equal(call(), want)
        del call
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


@pytest.mark.cuda
def test_failed_capture_raises_naming_the_op(cuda):
    x = torch.ones(4, device=cuda)
    call = cuda_graphs.GraphedCall(lambda: x * float(x.sum()), "a step with a host read")
    call()  # the eager warm-up may read the host
    with pytest.raises(RuntimeError, match="a step with a host read.*_local_scalar_dense"):
        call()
