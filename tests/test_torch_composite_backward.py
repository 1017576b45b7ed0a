"""Port parity: the streaming compositor's backward.  `composite._chunk_bwd`
against the JAX `_chunk_bwd`; `composite_stream_backward_reference` (the
plain PyTorch version of kernel B2, which `composite_stream`'s autograd
Function runs on CPU tensors) against torch autograd through the plain
forward and against `jax.grad` through the reference's `rasterize` with
RasterizeConfig(backend="pallas", packed=True), which runs the Pallas
kernels B1 and B2 in interpret mode on the CPU.

Tolerance: atol 1e-4 * scale + rtol 1e-3, scale = the largest magnitude of
the compared gradient (the reference's own packed-vs-dense backward test
uses the same).  The per-slot sums over a tile's pixels and the
scatter-add over a Gaussian's slots run in another order in each
implementation, and term2 = out4.g4 - r cancels toward the end of a
segment; float32 rounding of those sums is what the tolerance covers."""

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
from tests.test_torch_kernels_cuda import _stream_case

GROUPS = ("means3d", "quats", "scales", "opacities", "colors", "means2d_offset")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _assert_grad_close(got, ref, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, atol=1e-4 * max(scale, 1e-12), rtol=1e-3,
                               err_msg=name)
    return scale


def test_chunk_bwd_matches_jax(rng):
    g, th, tw = 16, 4, 8
    p = th * tw
    chunk = rng.normal(size=(g, 16)).astype(np.float32)
    chunk[:, :2] = rng.uniform(0, 8, size=(g, 2))
    chunk[:, 2:5] = [0.3, 0.05, 0.4]
    chunk[:, 5] = rng.uniform(0, 1.2, size=g)  # some slots at the clip
    chunk[3, 5] = 1e-4  # one under the threshold everywhere
    chunk[:, 9] = 1.0
    t_in = rng.uniform(0.2, 1, size=(1, p)).astype(np.float32)
    r_in = rng.normal(size=(1, p)).astype(np.float32)
    tot = rng.normal(size=(1, p)).astype(np.float32)
    g4 = rng.normal(size=(4, p)).astype(np.float32)
    px_t, py_t = t_comp.pixel_coords(torch.tensor(8), torch.tensor(4), th, tw)
    px_j, py_j = j_comp.pixel_coords(8, 4, th, tw)
    out_j = jax.jit(lambda *a: j_comp._chunk_bwd(*a, 0.99, 1 / 255))(
        jnp.asarray(chunk), px_j, py_j, jnp.asarray(t_in), jnp.asarray(r_in),
        jnp.asarray(tot), jnp.asarray(g4))
    out_t = t_comp._chunk_bwd(_t(chunk), px_t, py_t, _t(t_in), _t(r_in), _t(tot),
                              _t(g4), 0.99, 1 / 255)
    assert out_t[0].shape == (g, 16)
    assert float(out_t[0][3].abs().max()) == 0.0  # under the threshold
    assert float(out_t[0][:, 9:].abs().max()) == 0.0
    for a, b in zip(out_t, out_j):
        _assert_grad_close(a, b)
    # leading batch dimensions: two rows at once equal two single calls
    both = t_comp._chunk_bwd(
        _t(chunk)[None].repeat(2, 1, 1), px_t[None], py_t[None], _t(t_in)[None],
        _t(r_in)[None], _t(tot)[None], _t(g4)[None], 0.99, 1 / 255)
    for a, b in zip(both, out_t):
        torch.testing.assert_close(a[1], b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("tile_h,tile_w,chunk,per_tile,eps", [
    (8, 16, 32, 40, 1e-4),  # segments of several windows
    (4, 8, 8, 30, 1e-2),  # many short windows, the early stop fires
    (8, 16, 256, 40, 1e-4),  # one window holds several rows' segments
])
def test_backward_reference_matches_autograd(rng, tile_h, tile_w, chunk, per_tile, eps):
    stream, lo, hi, statics = _stream_case(0, tile_h, tile_w, 3, 2, 2, chunk, per_tile,
                                           "cpu", opacity=(0.3, 1.3))
    statics = statics._replace(transmittance_eps=eps)
    leaf = stream.clone().requires_grad_(True)
    out = t_packed.composite_stream_reference(leaf, lo, hi, statics)
    g4 = torch.from_numpy(rng.normal(size=tuple(out.shape)).astype(np.float32))
    (auto,) = torch.autograd.grad(out, leaf, g4)
    hand = t_packed.composite_stream_backward_reference(stream, lo, hi, out.detach(), g4,
                                                        statics)
    # the constant-one column carries no gradient in the hand-written
    # backward (as in the reference); autograd gives it one
    _assert_grad_close(hand[:, :9], auto[:, :9])
    assert float(hand[:, 9:].abs().max()) == 0.0
    owned = torch.zeros(stream.shape[0], dtype=torch.bool)
    for a, b in zip(lo.tolist(), hi.tolist()):
        owned[a:b] = True
    assert float(hand[~owned].abs().max()) == 0.0
    if eps > 1e-3:  # the early stop left owned slots untouched, in both
        skipped = owned & (hand[:, :9].abs().amax(1) == 0)
        assert int(skipped.sum()) > 0
        assert float(auto[skipped][:, :9].abs().max()) == 0.0
    # the autograd Function on CPU tensors runs the hand-written backward
    leaf2 = stream.clone().requires_grad_(True)
    (via_fn,) = torch.autograd.grad(t_packed.composite_stream(leaf2, lo, hi, statics),
                                    leaf2, g4)
    torch.testing.assert_close(via_fn, hand, rtol=0, atol=0)


def test_clip_and_threshold_gates():
    """One pixel, one slot: at the clip only the colour gets a gradient;
    under the threshold nothing does."""
    statics = t_comp.CompositeStatics(
        num_views=1, ntx=1, nty=1, tile_h=1, tile_w=1, chunk=8,
        alpha_clip=0.99, alpha_threshold=1 / 255,
    )
    lo, hi = torch.tensor([0], dtype=torch.int32), torch.tensor([1], dtype=torch.int32)
    g4 = torch.ones(2, 4, 1)
    for opa, colour_grad in ((5.0, 0.99), (1e-3, 0.0), (0.5, None)):
        stream = torch.zeros(8, 16)
        stream[0] = torch.tensor([0.7, 0.4, 0.5, 0.1, 0.6, opa, 1.0, 2.0, 3.0, 1.0]
                                 + [0.0] * 6)
        out = t_packed.composite_stream_reference(stream, lo, hi, statics)
        d = t_packed.composite_stream_backward_reference(stream, lo, hi, out, g4, statics)
        if colour_grad is None:  # an ordinary slot: every gradient is live
            assert float(d[0, :9].abs().min()) > 0.0
            continue
        assert float(d[0, :6].abs().max()) == 0.0
        torch.testing.assert_close(d[0, 6:9], torch.full((3,), colour_grad))


def _grads_both(cloud, cams, seed=0, **cfg_kw):
    """Gradients of one scalar of the rendered images and alphas with
    respect to every rasterizer input, (port, reference, aux pair)."""
    base = dict(tile_h=8, tile_w=16, max_tiles_per_gaussian=32, chunk=32,
                backend="pallas", packed=True)
    base.update(cfg_kw)
    cfg_j, cfg_t = j_config.RasterizeConfig(**base), t_config.RasterizeConfig(**base)
    cam = cams[0]
    vm = np.stack([np.asarray(c.viewmat) for c in cams])
    n = cloud.means3d.shape[0]
    args = [np.asarray(a) for a in (cloud.means3d, cloud.quats, cloud.scales,
                                    cloud.opacities, cloud.colors)]
    args.append(np.zeros((n, 2), np.float32))
    rng = np.random.default_rng(seed)
    w_img = rng.normal(size=(len(cams), cam.height, cam.width, 3)).astype(np.float32)
    w_al = rng.normal(size=(len(cams), cam.height, cam.width)).astype(np.float32)

    def loss_j(m, q, s, o, c, off):
        img, al, aux = j_rast.rasterize(m, q, s, o, c, jnp.asarray(vm), cam.fx, cam.fy,
                                        cam.cx, cam.cy, cam.width, cam.height, cfg_j,
                                        means2d_offset=off)
        return jnp.sum(img * w_img) + jnp.sum(al * w_al), aux.num_dropped

    (_, dropped_j), grads_j = jax.jit(
        jax.value_and_grad(loss_j, argnums=tuple(range(6)), has_aux=True)
    )(*[jnp.asarray(a) for a in args])

    leaves = [_t(a).requires_grad_(True) for a in args]
    img, al, aux = t_rast.rasterize(
        *leaves[:5], _t(vm), _t(cam.fx), _t(cam.fy), _t(cam.cx), _t(cam.cy),
        cam.width, cam.height, cfg_t, means2d_offset=leaves[5],
    )
    loss_t = (img * _t(w_img)).sum() + (al * _t(w_al)).sum()
    grads_t = torch.autograd.grad(loss_t, leaves)
    return grads_t, grads_j, (int(aux.num_dropped), int(dropped_j))


@pytest.mark.parametrize("shared,angles", [
    (False, (0.1,)),  # one view
    (False, (0.0, 0.04, 0.08)),  # three views, each binned on its own
    (True, (0.0, 0.04, 0.08)),  # three views on one shared sort
])
def test_rasterize_gradients_match_jax(rng, shared, angles):
    cloud = synthetic.random_cloud(rng, 90)
    cams = [synthetic.orbit_camera(a, width=32, img_height=24) for a in angles]
    grads_t, grads_j, _ = _grads_both(cloud, cams, shared_binning=shared)
    for name, a, b in zip(GROUPS, grads_t, grads_j):
        assert _assert_grad_close(a, b, name) > 0.0, name


def test_multi_window_early_stop_and_overflow_gradients(rng):
    """400 Gaussians on one 16x16 tile: segments span many windows, the T
    and r carries cross them and the early stop fires (opacity 0.6).  On
    8x8 tiles a stream_factor of 1 overflows the budget: the waterfilled
    far tails get no gradient in either package."""
    cloud = synthetic.random_cloud(rng, 400)
    cloud = cloud._replace(opacities=jnp.full((400,), 0.6))
    cams = [synthetic.orbit_camera(0.0, width=16, img_height=16)]
    for tile, factor in ((16, 6), (8, 1)):
        grads_t, grads_j, (drop_t, drop_j) = _grads_both(
            cloud, cams, tile_h=tile, tile_w=tile, stream_factor=factor
        )
        assert drop_t == drop_j
        for name, a, b in zip(GROUPS, grads_t, grads_j):
            _assert_grad_close(a, b, name)
    assert drop_t > 0
    # Gaussians whose every intersection was skipped or dropped: exact zeros
    untouched = np.asarray(grads_j[4]).max(axis=1) == 0
    assert untouched.sum() > 0
    assert float(grads_t[4][torch.from_numpy(untouched)].abs().max()) == 0.0
