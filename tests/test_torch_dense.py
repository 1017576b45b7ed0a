"""Port parity: the dense-table rasterizer (`RasterizeConfig(packed=False)`:
ops/binning.assign_tiles_arrays and gather_payload, ops/composite.
composite_tiles, the dense branch of ops/rasterize.py) against the JAX
reference, whose dense path runs its Pallas kernels B3 and B4 in interpret
mode (backend="pallas") or its XLA compositor (backend="xla").  On the CPU
the port runs the plain PyTorch versions of its kernels.  Plus the device
k-NN against its NumPy yardstick.

Tolerances.
- Integer outputs of binning: equal.
- Compositor values: atol 1e-5 + rtol 1e-5 (float32; the same log-space
  prefix math, summed in another order); where an opaque near field ends
  tiles early, atol 5e-4 + rtol 1e-3 between a version with the early stop
  and one without (the stop changes a pixel by less than eps = 1e-4 times
  its remaining colour), as tests/test_rasterize_pallas.py.
- Gradients: atol 1e-4 * scale + rtol 1e-3, scale = the largest gradient
  magnitude of the tensor (sums over pixels and slots run in another order
  in each package).
- k-NN: rtol 1e-5 found; the torch and NumPy matrix products round the
  cancelling |a|^2 + |b|^2 - 2ab differently, by ~1e-7 of the squared
  coordinates.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch import convert
from casualhdrsplat_torch.data import dataset as t_dataset
from casualhdrsplat_torch.models import image_formation as t_imf
from casualhdrsplat_torch.ops import binning as t_bin
from casualhdrsplat_torch.ops import composite as t_comp
from casualhdrsplat_torch.ops import knn as t_knn
from casualhdrsplat_torch.ops import oracle as t_oracle
from casualhdrsplat_torch.ops import projection as t_proj
from casualhdrsplat_torch.ops import rasterize as t_rast
from casualhdrsplat_torch.ops import rasterize_dense as t_dense
from casualhdrsplat_torch.train import optim as t_optim
from casualhdrsplat_torch.train.trainer import Trainer as TorchTrainer
from casualhdrsplat_tpu import config as j_config
from casualhdrsplat_tpu.data import dataset as j_dataset
from casualhdrsplat_tpu.data import synthetic
from casualhdrsplat_tpu.models import image_formation as j_imf
from casualhdrsplat_tpu.ops import binning as j_bin
from casualhdrsplat_tpu.ops import composite as j_comp
from casualhdrsplat_tpu.ops import projection as j_proj
from casualhdrsplat_tpu.ops import rasterize as j_rast
from casualhdrsplat_tpu.train.trainer import Trainer as JaxTrainer

BASE = dict(tile_h=8, tile_w=16, tile_capacity=64, max_tiles_per_gaussian=32, chunk=32,
            packed=False)


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype))


def _grad_close(a, b, name=""):
    b = np.asarray(b)
    scale = float(np.abs(b).max())
    assert scale > 0.0, name
    np.testing.assert_allclose(np.asarray(a), b, atol=1e-4 * scale, rtol=1e-3, err_msg=name)


# -- binning -------------------------------------------------------------------


@pytest.mark.parametrize("tile_h,tile_w,capacity", [(8, 16, 128), (16, 16, 128), (8, 16, 8)])
def test_assign_tiles_arrays_equals_jax(rng, tile_h, tile_w, capacity):
    """The [T, capacity] id table, the counts and both overflow counters,
    integer for integer; capacity 8 overflows, and mtpg 2 clips."""
    cloud = synthetic.random_cloud(rng, 120)
    cam = synthetic.orbit_camera(0.1, width=32, img_height=24)
    proj = j_proj.cull_invisible(j_proj.project_gaussians(
        cloud.means3d, cloud.quats, cloud.scales, cam.viewmat, cam.fx, cam.fy, cam.cx,
        cam.cy, 32, 24), cloud.opacities)
    mtpg = 2 if capacity == 8 else 32
    args = (32, 24, tile_h, tile_w, capacity, mtpg)
    tl_j = jax.jit(lambda p: j_bin.assign_tiles(p, *args))(proj)
    proj_t = t_proj.Projected(*[_t(f, np.asarray(f).dtype) for f in proj])
    tl_t = t_bin.assign_tiles(proj_t, *args)
    assert tl_t.indices.dtype == torch.int32 and tl_t.counts.dtype == torch.int32
    np.testing.assert_array_equal(tl_t.indices, tl_j.indices)
    np.testing.assert_array_equal(tl_t.counts, tl_j.counts)
    assert int(tl_t.num_dropped) == int(tl_j.num_dropped)
    assert int(tl_t.num_clipped) == int(tl_j.num_clipped)
    assert (int(tl_t.num_dropped) > 0) == (capacity == 8)
    assert (int(tl_t.num_clipped) > 0) == (capacity == 8)
    np.testing.assert_array_equal(t_bin.tile_origins(32, 24, tile_h, tile_w, device="cpu"),
                                  j_bin.tile_origins(32, 24, tile_h, tile_w))


def test_gather_payload_and_its_transpose(rng):
    """[V, N+1, 16] rows by [V, T, cap] ids in one gather; the backward is
    the scatter-add of autograd's own, but for the pad row, whose gradient
    is dropped."""
    v, n, t, cap = 2, 30, 5, 8
    payload = _t(rng.normal(size=(v, n + 1, 16))).requires_grad_(True)
    table = _t(rng.integers(0, n + 1, size=(v, t, cap)), np.int32)
    table[:, :, 5:] = n  # pad slots
    tiles = t_bin.TileLists(table, None, None, None)
    out = t_bin.gather_payload(payload, tiles)
    ref = torch.stack([payload[k][table[k].long()] for k in range(v)])
    assert out.shape == (v, t, cap, 16)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    g = _t(rng.normal(size=out.shape))
    (d,) = torch.autograd.grad(out, payload, g)
    (d_ref,) = torch.autograd.grad(ref, payload, g)
    torch.testing.assert_close(d[:, :n], d_ref[:, :n], rtol=1e-6, atol=1e-6)
    assert float(d[:, n].abs().max()) == 0.0 and float(d_ref[:, n].abs().max()) > 0.0
    # one view without a leading dimension, as the reference takes it
    single = t_bin.gather_payload(payload[0], t_bin.TileLists(table[0], None, None, None))
    torch.testing.assert_close(single, ref[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="leading dimensions"):
        t_bin.gather_payload(payload, t_bin.TileLists(table[0], None, None, None))


# -- the compositor ------------------------------------------------------------


def _table_case(rng, n, size, tile_h, tile_w, capacity, chunk, opacity=None, views=1,
                **cloud_kw):
    """A gathered table from a random cloud through the port's binning:
    (gathered [tt, cap, 16], counts [tt], torch statics, kwargs of the JAX
    statics)."""
    cloud = synthetic.random_cloud(rng, n, **cloud_kw)
    if opacity is not None:
        cloud = cloud._replace(opacities=jnp.full((n,), opacity))
    cams = [synthetic.orbit_camera(0.05 * k, width=size[0], img_height=size[1])
            for k in range(views)]
    cam = cams[0]
    vm = _t(np.stack([np.asarray(c.viewmat) for c in cams]))
    opac = _t(cloud.opacities)
    projs = t_proj.cull_invisible(t_proj.project_gaussians(
        _t(cloud.means3d), _t(cloud.quats), _t(cloud.scales), vm, _t(cam.fx), _t(cam.fy),
        _t(cam.cx), _t(cam.cy), *size), opac)
    payload = t_bin.build_payload(projs, _t(cloud.colors), opac)
    lists = [t_bin.assign_tiles_arrays(projs.means2d[k], projs.radii[k], projs.depths[k],
                                       projs.valid[k], *size, tile_h, tile_w, capacity, 32)
             for k in range(views)]
    tiles = t_bin.TileLists(torch.stack([t.indices for t in lists]),
                            torch.stack([t.counts for t in lists]), None, None)
    gathered = t_bin.gather_payload(payload, tiles).reshape(-1, capacity, 16)
    ntx, nty = t_bin.tile_grid(*size, tile_h, tile_w)
    kw = dict(num_views=views, ntx=ntx, nty=nty, tile_h=tile_h, tile_w=tile_w, chunk=chunk,
              alpha_clip=0.99, alpha_threshold=1 / 255)
    return gathered, tiles.counts.reshape(-1), t_comp.CompositeStatics(**kw), kw


def _jax_composite(gathered, counts, kw, backend, g4=None, tile_indices=None,
                   tiles_per_view=0):
    statics = j_comp.CompositeStatics(backend=backend, tiles_per_view=tiles_per_view, **kw)
    ti = None if tile_indices is None else jnp.asarray(tile_indices.numpy())

    def fn(g):
        return j_comp.composite_tiles(g, statics, ti, jnp.asarray(counts.numpy()))

    gathered = jnp.asarray(gathered.numpy())
    if g4 is None:
        return jax.jit(fn)(gathered), None
    out, vjp = jax.vjp(fn, gathered)
    return out, jax.jit(vjp)(jnp.asarray(g4.numpy()))[0]


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("tile_h,tile_w,capacity", [(8, 16, 64), (16, 16, 128)])
def test_composite_tiles_matches_jax(rng, backend, tile_h, tile_w, capacity):
    """Plain forward and hand-written plain backward against both of the
    reference's compositors, two views stacked along the tile axis."""
    gathered, counts, statics, kw = _table_case(rng, 100, (32, 32), tile_h, tile_w,
                                                capacity, 32, views=2)
    statics = statics._replace(backend=backend)
    leaf = gathered.clone().requires_grad_(True)
    out = t_comp.composite_tiles(leaf, statics, counts=counts)
    g4 = _t(rng.normal(size=tuple(out.shape)))
    (d,) = torch.autograd.grad(out, leaf, g4)
    out_j, d_j = _jax_composite(gathered, counts, kw, backend, g4)
    assert out.shape == (gathered.shape[0], 4, tile_h * tile_w)
    assert float(out.detach().abs().max()) > 0.1 and int(counts.max()) > 32  # several chunks
    np.testing.assert_allclose(out.detach(), out_j, atol=1e-5, rtol=1e-5)
    _grad_close(d, d_j)
    assert float(d[..., 9:].abs().max()) == 0.0


def test_composite_tiles_early_exit_and_schedule(rng):
    """Opaque splats that cover the whole tile end it within its first chunk.  The
    kernels' schedule (plain version) agrees with the reference's Pallas
    kernel, which stops at the same chunks, and both stay within the
    early-exit tolerance of the versions without a stop; the chunks the
    stop skipped get zero gradient, and the work report counts only the
    slots that were composited."""
    gathered, counts, statics, kw = _table_case(rng, 120, (16, 16), 16, 16, 128, 32,
                                                opacity=0.98, extent=0.3,
                                                scale_range=(1.5, 2.5))
    ti = torch.arange(gathered.shape[0], dtype=torch.int32)
    out, work = t_comp.composite_tiles_reference(gathered, ti, counts, statics,
                                                 return_work=True)
    full, work_full = t_comp.composite_tiles_reference(
        gathered, ti, counts, statics, kernel_schedule=False, return_work=True)
    g4 = _t(rng.normal(size=tuple(out.shape)))
    d = t_comp.composite_tiles_backward_reference(gathered, ti, counts, out, g4, statics)
    out_p, d_p = _jax_composite(gathered, counts, kw, "pallas", g4)
    out_x, _ = _jax_composite(gathered, counts, kw, "xla")
    np.testing.assert_allclose(out, out_p, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(full, out_x, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out, out_x, atol=5e-4, rtol=1e-3)
    _grad_close(d, d_p)
    # one tile: it stopped after work.slots of its counts[0] occupied slots
    assert work.slots % 32 == 0 and work.slots < int(counts[0])
    assert work_full.slots == gathered.shape[0] * 128
    assert float(d[0, work.slots:].abs().max()) == 0.0 < float(d[0, :work.slots].abs().max())
    assert float(np.abs(d_p[0, work.slots:]).max()) == 0.0
    assert 0 < work.touched <= work.slots * 256 and work.tie_pixels.shape == (1, 256)


def test_plain_backward_matches_autograd_of_plain_forward(rng):
    """The hand-written formula against autograd through the plain forward
    (the gradient columns 0..8; the rest carry none), with and without the
    kernels' schedule."""
    gathered, counts, statics, _ = _table_case(rng, 80, (32, 16), 8, 16, 64, 32)
    ti = torch.arange(gathered.shape[0], dtype=torch.int32)
    for schedule in (True, False):
        leaf = gathered.clone().requires_grad_(True)
        out = t_comp.composite_tiles_reference(leaf, ti, counts, statics,
                                               kernel_schedule=schedule)
        g4 = _t(rng.normal(size=tuple(out.shape)))
        (auto,) = torch.autograd.grad(out, leaf, g4)
        hand = t_comp.composite_tiles_backward_reference(
            gathered, ti, counts, out.detach(), g4, statics, kernel_schedule=schedule)
        _grad_close(hand[..., :9], auto[..., :9])
        assert float(hand[..., 9:].abs().max()) == 0.0


def test_plain_backward_adds_up_over_pixels(rng):
    """Every pixel adds its own term to a slot's gradient, linear in that
    pixel's upstream gradient: the gradients for g4 on a set of pixels and
    on the rest sum to the gradient for all of g4, and a tile whose g4 is
    zero gets none.  A comparison that zeroes g4 at the threshold-tie
    pixels therefore leaves out those pixels' terms and nothing else."""
    gathered, counts, statics, _ = _table_case(rng, 100, (32, 32), 16, 16, 128, 32)
    ti = torch.arange(gathered.shape[0], dtype=torch.int32)
    out = t_comp.composite_tiles_reference(gathered, ti, counts, statics)
    g4 = _t(rng.normal(size=tuple(out.shape)))
    some = _t(rng.random(size=(out.shape[0], 1, out.shape[2])) < 0.1, bool)
    some[1] = False

    def bwd(g):
        return t_comp.composite_tiles_backward_reference(gathered, ti, counts, out, g, statics)

    whole, on, off = bwd(g4), bwd(g4 * some), bwd(g4 * ~some)
    assert float(on.abs().max()) > 0.0 and float(on[1].abs().max()) == 0.0
    _grad_close(on + off, whole)
    torch.testing.assert_close(off[1], whole[1], rtol=0, atol=0)


def test_explicit_tile_indices_and_padded_stride(rng):
    """A caller that composites a slice of the tiles passes offset indices
    and a padded per-view stride: origins come from index % tiles_per_view."""
    gathered, counts, statics, kw = _table_case(rng, 80, (32, 16), 8, 16, 64, 32)
    tt = gathered.shape[0]  # 2 x 2 tiles
    assert tt == 4
    stride = 6  # padded from 4
    ti = torch.tensor([stride + 3, 0, 2 * stride + 1, 2], dtype=torch.int32)
    order = (ti % stride).long()
    padded = statics._replace(tiles_per_view=stride)
    out = t_comp.composite_tiles(gathered[order], padded, tile_indices=ti,
                                 counts=counts[order])
    plain = t_comp.composite_tiles(gathered, statics, counts=counts)
    torch.testing.assert_close(out, plain[order], rtol=0, atol=0)
    out_j, _ = _jax_composite(gathered[order], counts[order], kw, "pallas",
                              tile_indices=ti, tiles_per_view=stride)
    np.testing.assert_allclose(out, out_j, atol=1e-5, rtol=1e-5)


def test_composite_tiles_checks_and_defaults():
    statics = t_comp.CompositeStatics(num_views=1, ntx=2, nty=1, tile_h=4, tile_w=4,
                                      chunk=8, alpha_clip=0.99, alpha_threshold=1 / 255)
    table = torch.zeros(2, 16, 16)
    table[..., 5] = 0.5
    table[..., 6:10] = 1.0
    out = t_comp.composite_tiles(table, statics)  # counts default to the capacity
    assert out.shape == (2, 4, 16) and float(out[:, 3].min()) > 0.99
    zero = t_comp.composite_tiles(table, statics, counts=torch.zeros(2, dtype=torch.int32))
    assert float(zero.abs().max()) == 0.0  # an empty list composites nothing
    with pytest.raises(ValueError, match="multiple of chunk"):
        t_comp.composite_tiles(table[:, :12], statics)
    with pytest.raises(TypeError, match="int32"):
        t_comp.composite_tiles(table, statics, counts=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(TypeError, match="float32"):
        t_comp.composite_tiles(table.double(), statics)
    assert t_dense.MAX_TILE_PIXELS == 4096
    assert (t_dense.FWD_KERNEL.symbol, t_dense.BWD_KERNEL.symbol) == (
        "chs_rasterize_dense_fwd", "chs_rasterize_dense_bwd")


# -- rasterize(packed=False) end to end ----------------------------------------


def _render_both(cloud, cams, backend="pallas", background=None, with_grads=False, **cfg_kw):
    kw = dict(BASE, **cfg_kw)
    cfg_j = j_config.RasterizeConfig(backend=backend, **kw)
    cfg_t = t_config.RasterizeConfig(backend=backend, **kw)
    cam = cams[0]
    vm = np.stack([np.asarray(c.viewmat) for c in cams])
    n = cloud.means3d.shape[0]
    args = (cloud.means3d, cloud.quats, cloud.scales, cloud.opacities, cloud.colors)
    bg_j = None if background is None else jnp.asarray(background)
    bg_t = None if background is None else _t(background)
    weights = np.random.default_rng(1).normal(size=(len(cams), cam.height, cam.width, 3))

    def fwd_j(offset, *a):
        return j_rast.rasterize(*a, jnp.asarray(vm), cam.fx, cam.fy, cam.cx, cam.cy,
                                cam.width, cam.height, cfg_j, background=bg_j,
                                means2d_offset=offset)

    def fwd_t(offset, *a):
        return t_rast.rasterize(*a, _t(vm), _t(cam.fx), _t(cam.fy), _t(cam.cx), _t(cam.cy),
                                cam.width, cam.height, cfg_t, background=bg_t,
                                means2d_offset=offset)

    out_j = jax.jit(fwd_j)(jnp.zeros((n, 2)), *args)
    leaves = [torch.zeros(n, 2, requires_grad=True)] + [
        _t(a).requires_grad_(True) for a in args]
    out_t = fwd_t(*leaves)
    if not with_grads:
        return out_t, out_j, None, None

    def loss_j(offset, *a):
        im, al, _ = fwd_j(offset, *a)
        return jnp.sum(im * jnp.asarray(weights, jnp.float32)) + 0.05 * jnp.sum(al)

    g_j = jax.jit(jax.grad(loss_j, argnums=tuple(range(6))))(jnp.zeros((n, 2)), *args)
    loss_t = (out_t[0] * _t(weights)).sum() + 0.05 * out_t[1].sum()
    g_t = torch.autograd.grad(loss_t, leaves)
    return out_t, out_j, g_t, g_j


def _check_render(out_t, out_j, atol=1e-5):
    (img_t, al_t, aux_t), (img_j, al_j, aux_j) = out_t, out_j
    np.testing.assert_allclose(img_t.detach(), img_j, atol=atol, rtol=1e-5)
    np.testing.assert_allclose(al_t.detach(), al_j, atol=atol)
    np.testing.assert_array_equal(aux_t.radii.detach(), aux_j.radii)
    assert int(aux_t.num_dropped) == int(aux_j.num_dropped)
    assert int(aux_t.num_clipped) == int(aux_j.num_clipped)
    assert float(img_t.detach().abs().max()) > 0.1


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("angles", [(0.1,), (0.0, 0.04, 0.08)])
def test_rasterize_dense_matches_jax(rng, backend, angles):
    """1 and 3 views on a 30x20 image that 8x16 tiles do not divide, values
    and the gradients of every input and of the means2d tap."""
    cloud = synthetic.random_cloud(rng, 90)
    cams = [synthetic.orbit_camera(a, width=30, img_height=20) for a in angles]
    out_t, out_j, g_t, g_j = _render_both(cloud, cams, backend=backend, with_grads=True)
    assert out_t[0].shape == (len(angles), 20, 30, 3)
    _check_render(out_t, out_j)
    for name, a, b in zip(("means2d_offset", "means3d", "quats", "scales", "opacities",
                           "colors"), g_t, g_j):
        _grad_close(a, b, name)


@pytest.mark.parametrize("case", ["background", "antialias", "tiles_16x16", "packed_xla"])
def test_rasterize_dense_options_match_jax(rng, case):
    cloud = synthetic.random_cloud(rng, 90)
    cams = [synthetic.orbit_camera(a, width=32, img_height=32) for a in (0.0, 0.06)]
    kw = {
        "background": dict(background=np.array([0.2, 0.5, 0.9], np.float32)),
        "antialias": dict(antialias=True),
        "tiles_16x16": dict(tile_h=16, tile_w=16, tile_capacity=128),
        # backend "xla" takes the dense plain path whatever `packed` says
        "packed_xla": dict(packed=True, backend="xla"),
    }[case]
    out_t, out_j, _, _ = _render_both(cloud, cams, **kw)
    _check_render(out_t, out_j)


def test_capacity_overflow_keeps_nearest(rng):
    """An overfull tile keeps the nearest `capacity` of its depth order:
    the same image as the reference's, equal to the oracle's over those
    Gaussians only, and the farther ones get no gradient."""
    n, cap = 40, 8
    cloud = synthetic.random_cloud(rng, n, extent=0.3)
    cam = synthetic.orbit_camera(0.0, width=16, img_height=16)
    out_t, out_j, _, _ = _render_both(cloud, [cam], tile_h=16, tile_w=16, tile_capacity=cap,
                                      chunk=8)
    _check_render(out_t, out_j)
    assert int(out_t[2].num_dropped) > 0
    depths = out_t[2].depths[0].detach().numpy()
    visible = out_t[2].radii[0].detach().numpy() > 0
    nearest = np.argsort(np.where(visible, depths, np.inf), kind="stable")[:cap]
    keep = np.zeros(n, bool)
    keep[nearest] = True
    cam_t = convert_camera(cam)
    ref = t_oracle.render(_t(cloud.means3d), _t(cloud.quats), _t(cloud.scales),
                          _t(cloud.opacities) * _t(keep), _t(cloud.colors), cam_t)
    np.testing.assert_allclose(out_t[0][0].detach(), ref.image, atol=2e-4, rtol=1e-3)


def convert_camera(cam):
    from casualhdrsplat_torch.geometry.camera import Camera

    return Camera.make(np.asarray(cam.viewmat), float(cam.fx), float(cam.fy), float(cam.cx),
                       float(cam.cy), cam.width, cam.height, device="cpu")


# -- k-NN ----------------------------------------------------------------------


@pytest.mark.parametrize("m,k,chunk", [(500, 3, 2048), (300, 5, 64), (2, 3, 2048), (1, 3, 8)])
def test_knn_mean_dist_matches_numpy(rng, m, k, chunk):
    xyz = rng.uniform(-1, 1, size=(m, 3)).astype(np.float32)
    got = t_knn.knn_mean_dist(xyz, k, chunk, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (m,)
    np.testing.assert_allclose(got.numpy(), t_knn.knn_mean_dist_numpy(xyz, k, chunk),
                               rtol=1e-5)


# -- the slice as a whole ------------------------------------------------------


def _train_cfg(mod):
    cfg = mod.TrainConfig(name="dense-parity")
    cfg.model.max_gaussians = 128
    cfg.model.sh_degree = 1
    cfg.model.num_virtual_views = 2
    cfg.model.crf = mod.CRFConfig(kind="mlp", hidden=8)
    cfg.model.rasterize = mod.RasterizeConfig(backend="pallas", **BASE)
    cfg.densify.enabled = False
    cfg.optim.max_steps = 25
    cfg.log_every = 10**9
    cfg.eval_every = 0
    cfg.checkpoint_every = 0
    cfg.data.eval_every = 0
    return cfg


def _port_dataset(ds_j) -> t_dataset.Dataset:
    """The reference's dataset, field by field through numpy."""
    fields = {}
    for f in dataclasses.fields(t_dataset.Dataset):
        v = getattr(ds_j, f.name)
        fields[f.name] = np.array(v) if isinstance(v, (np.ndarray, jax.Array)) else v
    return t_dataset.Dataset(**fields)


def test_render_frame_and_run_step_dense_match_jax():
    """render_frame and one Trainer.run_step on packed=False: the reference
    runs Pallas B3/B4 in interpret mode, the port their plain versions.
    Loss atol 1e-6, PSNR 1e-4 dB, parameters within 5e-3 lr of the
    reference's after the step (Adam's first update moves every element by
    about lr, so the gradients' 1e-3 relative agreement shows as 1e-3 lr)."""
    ds_j = j_dataset.make_synthetic_dataset(seed=4, n_gaussians=96, n_frames=4,
                                            n_virtual=2, size=32)
    tj = JaxTrainer(_train_cfg(j_config), ds_j)
    rng = np.random.default_rng(12)
    np_params = jax.tree_util.tree_map(lambda a: np.array(a), tj.params)
    g = np_params["gaussians"]
    g["opacity_logit"] = g["opacity_logit"] + 2.0
    g["log_scales"] = g["log_scales"] + (rng.normal(size=g["log_scales"].shape)
                                         * 0.3).astype(np.float32)
    g["quats"] = g["quats"] + (rng.normal(size=g["quats"].shape) * 0.3).astype(np.float32)
    g["sh_rest"] = (rng.normal(size=g["sh_rest"].shape) * 0.1).astype(np.float32)
    tj.params = jax.tree_util.tree_map(jnp.asarray, np_params)
    tt = TorchTrainer(_train_cfg(t_config), _port_dataset(ds_j), device="cpu")
    tt.params = convert.params_from_jax(np_params, device="cpu")

    fr_j = jax.jit(lambda p: j_imf.render_frame(p, tj.scene, 1, tj.cfg.model))(tj.params)
    with torch.no_grad():
        fr_t = t_imf.render_frame(tt.params, tt.scene, 1, tt.cfg.model)
    np.testing.assert_allclose(fr_t.blurred_ldr, fr_j.blurred_ldr, atol=1e-5)
    np.testing.assert_allclose(fr_t.sharp_hdr, fr_j.sharp_hdr, atol=1e-5)
    assert int(fr_t.aux.num_dropped) == int(fr_j.aux.num_dropped)

    out_j, out_t = tj.run_step(), tt.run_step()
    assert abs(out_t["loss"] - out_j["loss"]) <= 1e-6
    assert abs(out_t["psnr"] - out_j["psnr"]) <= 1e-4
    assert out_t["dropped"] == out_j["dropped"] and out_t["clipped"] == out_j["clipped"]
    np.testing.assert_array_equal(tt.adc.count.numpy(), np.asarray(tj.adc.count))
    lrs = tt.opt.learning_rates(0)
    for path, label, leaf in t_optim.labelled_leaves(tt.params):
        ref = np.asarray(t_optim.tree_get(tj.params, path))
        if label == "frozen":
            np.testing.assert_array_equal(leaf.numpy(), ref)
            continue
        atol = 5e-3 * lrs[label] + 2.4e-7 * float(np.abs(ref).max())
        np.testing.assert_allclose(leaf.numpy(), ref, atol=atol, rtol=0, err_msg=str(path))
        assert np.abs(ref - np.asarray(t_optim.tree_get(np_params, path))).max() > 0.0, path
