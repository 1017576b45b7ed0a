"""Port parity: the streaming compositor (ops/composite.py chunk math,
ops/rasterize_packed.py, the packed branches of ops/rasterize.py) against
the JAX reference with RasterizeConfig(backend="pallas", packed=True), so
that JAX takes the packed path and runs its Pallas kernel B1 in interpret
mode.  On the CPU the port's wrapper runs its plain PyTorch version.

Tolerance: forward atol 1e-5 (float32; the same log-space prefix math,
summed in another order).  Binning counters are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch.ops import composite as t_comp
from casualhdrsplat_torch.ops import rasterize as t_rast
from casualhdrsplat_torch.ops import rasterize_packed as t_packed
from casualhdrsplat_tpu import config as j_config
from casualhdrsplat_tpu.data import synthetic
from casualhdrsplat_tpu.ops import composite as j_comp
from casualhdrsplat_tpu.ops import rasterize as j_rast

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _render_both(cloud, cams, **cfg_kw):
    base = dict(tile_h=8, tile_w=16, max_tiles_per_gaussian=32, chunk=32,
                backend="pallas", packed=True)
    base.update(cfg_kw)
    cfg_j, cfg_t = j_config.RasterizeConfig(**base), t_config.RasterizeConfig(**base)
    cam = cams[0]
    vm = np.stack([np.asarray(c.viewmat) for c in cams])
    args = (cloud.means3d, cloud.quats, cloud.scales, cloud.opacities, cloud.colors)

    @jax.jit
    def fwd_j(*a):
        return j_rast.rasterize(*a, jnp.asarray(vm), cam.fx, cam.fy, cam.cx, cam.cy,
                                cam.width, cam.height, cfg_j)

    img_j, al_j, aux_j = fwd_j(*args)
    img_t, al_t, aux_t = t_rast.rasterize(
        *[_t(a) for a in args], _t(vm), _t(cam.fx), _t(cam.fy), _t(cam.cx), _t(cam.cy),
        cam.width, cam.height, cfg_t,
    )
    return (img_t, al_t, aux_t), (img_j, al_j, aux_j)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("angles", [(0.1,), (0.0, 0.04, 0.08)])
def test_rasterize_packed_matches_jax(rng, shared, angles):
    cloud = synthetic.random_cloud(rng, 90)
    cams = [synthetic.orbit_camera(a, width=32, img_height=24) for a in angles]
    (img_t, al_t, aux_t), (img_j, al_j, aux_j) = _render_both(
        cloud, cams, shared_binning=shared
    )
    assert img_t.shape == (len(angles), 24, 32, 3)
    np.testing.assert_allclose(img_t, img_j, atol=ATOL)
    np.testing.assert_allclose(al_t, al_j, atol=ATOL)
    np.testing.assert_array_equal(aux_t.radii, aux_j.radii)
    assert int(aux_t.num_dropped) == int(aux_j.num_dropped)
    assert int(aux_t.num_clipped) == int(aux_j.num_clipped)
    assert float(img_t.abs().max()) > 0.1


def test_multi_window_segments_and_overflow(rng):
    """400 Gaussians on one 16x16 tile: segments span many windows (the
    cross-window transmittance carry and the early-stop vote).  On 8x8
    tiles, where footprints straddle tiles, a stream_factor of 1 overflows
    the budget (waterfilled far tails)."""
    cloud = synthetic.random_cloud(rng, 400)
    cloud = cloud._replace(opacities=jnp.full((400,), 0.6))
    cams = [synthetic.orbit_camera(0.0, width=16, img_height=16)]
    for tile, factor in ((16, 6), (8, 1)):
        (img_t, al_t, aux_t), (img_j, al_j, aux_j) = _render_both(
            cloud, cams, tile_h=tile, tile_w=tile, stream_factor=factor
        )
        np.testing.assert_allclose(img_t, img_j, atol=ATOL)
        np.testing.assert_allclose(al_t, al_j, atol=ATOL)
        assert int(aux_t.num_dropped) == int(aux_j.num_dropped)
    assert int(aux_t.num_dropped) > 0


def test_transmittance_eps_reaches_compositor(rng):
    """eps > 1 fails the skip vote even at T = 1, so every window is
    skipped and the output is exactly zero, as in the reference."""
    cloud = synthetic.random_cloud(rng, 60)
    cams = [synthetic.orbit_camera(0.0, width=16, img_height=16)]
    (img_t, _, _), (img_j, _, _) = _render_both(cloud, cams, transmittance_eps=2.0)
    assert float(img_t.abs().max()) == 0.0 == float(jnp.abs(img_j).max())


def test_chunk_math(rng):
    g, th, tw = 16, 4, 8
    chunk = rng.normal(size=(g, 16)).astype(np.float32)
    chunk[:, :2] = rng.uniform(0, 8, size=(g, 2))
    chunk[:, 2:5] = [0.3, 0.05, 0.4]
    chunk[:, 5] = rng.uniform(0, 1, size=g)
    px_t, py_t = t_comp.pixel_coords(torch.tensor(8), torch.tensor(4), th, tw)
    px_j, py_j = j_comp.pixel_coords(8, 4, th, tw)
    np.testing.assert_array_equal(px_t, px_j)
    np.testing.assert_array_equal(py_t, py_j)
    for a, b in zip(t_comp._alpha_terms(_t(chunk), px_t, py_t, 0.99, 1 / 255),
                    j_comp._alpha_terms(jnp.asarray(chunk), px_j, py_j, 0.99, 1 / 255)):
        if isinstance(a, tuple):
            continue
        np.testing.assert_allclose(a, b, atol=1e-6)
    t_in = rng.uniform(0.2, 1, size=(1, th * tw)).astype(np.float32)
    out_t = t_comp._chunk_fwd(_t(chunk), px_t, py_t, _t(t_in), 0.99, 1 / 255)
    out_j = j_comp._chunk_fwd(jnp.asarray(chunk), px_j, py_j, jnp.asarray(t_in), 0.99, 1 / 255)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_wrapper_on_cpu_and_unported_paths(rng):
    statics = t_comp.CompositeStatics(
        num_views=1, ntx=2, nty=1, tile_h=4, tile_w=4, chunk=8,
        alpha_clip=0.99, alpha_threshold=1 / 255,
    )
    stream = torch.zeros(32, 16)
    stream[:, 5] = 0.5
    stream[:, 6:10] = 1.0
    lo = torch.tensor([0, 5], dtype=torch.int32)
    hi = torch.tensor([5, 23], dtype=torch.int32)
    out = t_packed.composite_stream(stream, lo, hi, statics)
    ref, work = t_packed.composite_stream_reference(stream, lo, hi, statics,
                                                    return_work=True)
    assert out.shape == (3, 4, 16)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert work.slots == 23 and float(out[2].abs().max()) == 0.0
    # every in-segment slot has alpha 0.5 at every pixel, far from the threshold
    assert work.touched == 23 * 16 and not bool(work.tie_pixels.any())
    with pytest.raises(ValueError):
        t_packed.composite_stream(stream[:30], lo, hi, statics)
    cfg = t_config.RasterizeConfig(backend="mosaic")
    with pytest.raises(ValueError, match="unknown rasterizer backend"):
        t_rast.rasterize(*[torch.zeros(2, d) for d in (3, 4, 3)], torch.ones(2),
                         torch.ones(2, 3), torch.eye(4), 1.0, 1.0, 1.0, 1.0, 4, 4, cfg)


def test_reference_reports_touched_pairs_and_threshold_ties():
    """`return_work` counts the (slot, pixel) pairs that blend and flags the
    pixels where a slot's alpha sits at alpha_threshold; a slot outside
    every segment, or in a window the early stop skipped, counts nowhere."""
    statics = t_comp.CompositeStatics(
        num_views=1, ntx=2, nty=1, tile_h=4, tile_w=4, chunk=8,
        alpha_clip=0.99, alpha_threshold=1 / 255,
    )
    stream = torch.zeros(24, 16)
    stream[:, 5] = 0.5
    stream[:, 6:10] = 1.0
    stream[3, 5] = 1 / 255  # at the threshold at every pixel of row 0
    stream[4, 5] = 1e-4  # under it: evaluated, never blends
    stream[13, 5] = 1 / 255  # a tie no row owns
    lo = torch.tensor([0, 8], dtype=torch.int32)
    hi = torch.tensor([8, 12], dtype=torch.int32)
    _, work = t_packed.composite_stream_reference(stream, lo, hi, statics, return_work=True)
    assert work.slots == 12
    assert work.touched == (12 - 1) * 16
    assert work.tie_pixels.shape == (3, 16)
    assert bool(work.tie_pixels[0].all()) and not bool(work.tie_pixels[1:].any())
    # 16 opaque slots end row 0's first window below eps: the second is skipped
    stream[:, 5] = 0.99
    hi = torch.tensor([16, 16], dtype=torch.int32)
    lo = torch.tensor([0, 16], dtype=torch.int32)
    _, work = t_packed.composite_stream_reference(stream, lo, hi, statics, return_work=True)
    assert work.slots == 8 and work.touched == 8 * 16


def test_per_view_stream_gather_transposes_by_index_add(rng):
    """The per-view branch gathers its stream rows with index_select, whose
    transpose is index_add_.  The transpose of advanced indexing (index_put_
    with accumulate) sorts the ids and adds each run of equal ids serially
    on a GPU, and the unused tail of a stream budget is one long run of the
    pad id: a training step at 800x800 over a 131,072-slot store at
    stream_factor 12 took 2.8 s on the card that way, 0.14 s with
    index_select (PERF.md, the quality run)."""
    cloud = synthetic.random_cloud(rng, 90)
    cam = synthetic.orbit_camera(0.1, width=32, img_height=24)
    cfg = t_config.RasterizeConfig(tile_h=8, tile_w=16, chunk=32, shared_binning=False)
    colors = _t(cloud.colors).requires_grad_(True)
    img, _, _ = t_rast.rasterize(
        _t(cloud.means3d), _t(cloud.quats), _t(cloud.scales), _t(cloud.opacities), colors,
        _t(np.asarray(cam.viewmat))[None], _t(cam.fx), _t(cam.fy), _t(cam.cx), _t(cam.cy),
        cam.width, cam.height, cfg)
    names, seen, stack = set(), set(), [img.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        stack += [f for f, _ in node.next_functions]
    assert "IndexSelectBackward0" in names and "IndexBackward0" not in names, names
    grad, = torch.autograd.grad(img.sum(), colors)
    assert float(grad.abs().max()) > 0
