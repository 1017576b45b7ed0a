"""The CUDA compositor kernels (csrc/rasterize_packed_fwd.cu and
csrc/rasterize_packed_bwd.cu for the depth-sorted stream,
csrc/rasterize_dense_fwd.cu and csrc/rasterize_dense_bwd.cu for the dense
[tiles, capacity] lists, read through an id table, a gathered table passed
as lists on unique ids) held against their
plain PyTorch versions on the card; and, around them, a checkpoint moving
between the card and the CPU and one pose-aligner gradient on both.  Marked `cuda`: without a card the
fixture skips every test here (the decision is made inside the fixture,
so every pytest-xdist worker collects the same tests).

Run on the card with `python -m pytest tests/test_torch_kernels_cuda.py -m cuda`.

Tolerance: atol 1e-4 + rtol 1e-4.  The kernel carries T as a running
product and the plain version as exp of a log-space prefix sum, so they
differ by float32 rounding (~1e-6); where a tile's max T sits within that
rounding of eps at a window boundary, the skip vote may differ by one
window, which moves a pixel by at most eps times its remaining colour.

Backward: atol 1e-4 * scale + rtol 1e-3, scale = the largest gradient
magnitude of the case.  The kernel sums a slot's nine gradients over the
tile's pixels per thread, per warp, then over warps, the plain version in
one torch sum, and term2 = out4.g4 - r cancels toward the end of a
segment, so the two differ by float32 rounding of sums of up to 2048
terms; the skip vote's one-window slack moves a slot's gradient by at
most eps times its weight."""

import re

import numpy as np
import pytest
import torch

from casualhdrsplat_torch.ops import binning
from casualhdrsplat_torch.ops import composite
from casualhdrsplat_torch.ops import rasterize_dense as rd
from casualhdrsplat_torch.ops import rasterize_packed as rp
from casualhdrsplat_torch.ops.composite import CompositeStatics

import test_torch_slot_boxes as box_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _stream_case(seed, tile_h, tile_w, ntx, nty, views, chunk, per_tile, device,
                 opacity=(0.05, 0.99), heavy_last=False):
    """A random depth-sorted stream with per-row segments of 0..2*per_tile
    entries, laid out as the rasterizer lays them out (rows of one view
    are contiguous and start mid-window); every fifth row is empty.  With
    `heavy_last` the segments grow with the row index, so the longest rows
    are last in blockIdx order."""
    rng = np.random.default_rng(seed)
    rows = views * ntx * nty
    seg = rng.integers(0, 2 * per_tile, size=rows)
    seg[::5] = 0  # empty tiles
    if heavy_last:
        seg = np.sort(seg)
    lo = np.concatenate([[3], 3 + np.cumsum(seg)[:-1]])
    m = -(-(int(lo[-1] + seg[-1]) + 1) // chunk) * chunk
    stream = np.zeros((m, binning.PAYLOAD_DIM), np.float32)
    row_of = np.repeat(np.arange(rows), seg)
    t = row_of % (ntx * nty)
    ox, oy = (t % ntx) * tile_w, (t // ntx) * tile_h
    k = len(row_of)
    s = slice(3, 3 + k)
    stream[s, 0] = ox + rng.uniform(-4, tile_w + 4, k)
    stream[s, 1] = oy + rng.uniform(-4, tile_h + 4, k)
    sig = rng.uniform(0.7, 4.0, size=k)
    stream[s, 2] = 1 / sig**2
    stream[s, 3] = rng.uniform(-0.2, 0.2, k) / sig**2
    stream[s, 4] = 1 / sig**2
    stream[s, 5] = rng.uniform(*opacity, k)
    stream[s, 6:9] = rng.uniform(0, 2, size=(k, 3))
    stream[s, 9] = 1.0
    statics = CompositeStatics(
        num_views=views, ntx=ntx, nty=nty, tile_h=tile_h, tile_w=tile_w, chunk=chunk,
        alpha_clip=0.99, alpha_threshold=1 / 255,
    )

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return (dev(stream, torch.float32), dev(lo, torch.int32),
            dev(lo + seg, torch.int32), statics)


@pytest.mark.parametrize("tile_h,tile_w,chunk", [
    (16, 128, 128),  # the default config: 2048 pixels, 8 per thread
    (16, 16, 128),  # bench.py's tiles: 256 pixels, 1 per thread
    (8, 20, 32),  # 160 pixels: a partial warp-multiple block
    (16, 16, 1024),  # a 64 KB window: opt-in dynamic shared memory
])
def test_kernel_matches_plain_version(cuda, tile_h, tile_w, chunk):
    stream, lo, hi, statics = _stream_case(
        0, tile_h, tile_w, 3, 2, 2, chunk, 300, cuda
    )
    before = rp.FWD_KERNEL.launches
    out = rp.composite_stream(stream, lo, hi, statics)
    torch.cuda.synchronize()
    assert rp.FWD_KERNEL.launches == before + 1
    ref = rp.composite_stream_reference(stream, lo, hi, statics)
    assert out.shape == ref.shape
    assert torch.isfinite(out).all()
    assert float(out[-1].abs().max()) == 0.0
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


def _bwd_inputs(case, seed):
    stream, lo, hi, statics = case
    out4 = rp.composite_stream(stream, lo, hi, statics)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    g4 = torch.randn(out4.shape, generator=gen).to(stream.device)
    return out4, g4


def _backward(stream, lo, hi, out4, g4, statics):
    """Kernel B2, its CTAs taking the rows in the order composite_stream's
    forward gives them."""
    return rp._backward_cuda(stream, lo, hi, rp.row_order(lo, hi), out4, g4, statics)


def _assert_grad_close(got, ref):
    scale = float(ref.abs().max())
    assert scale > 0.0
    torch.testing.assert_close(got, ref, atol=1e-4 * scale, rtol=1e-3)


@pytest.mark.parametrize("tile_h,tile_w,chunk", [
    (16, 128, 128),  # the default config: 2048 pixels, 8 per thread
    (16, 16, 128),  # bench.py's tiles: 256 pixels, 1 per thread
    (8, 20, 32),  # 160 pixels: a partial warp-multiple block
    (16, 16, 1024),  # windows longer than the 128-slot staging piece
])
def test_backward_kernel_matches_plain_version(cuda, tile_h, tile_w, chunk):
    case = _stream_case(0, tile_h, tile_w, 3, 2, 2, chunk, 300, cuda)
    stream, lo, hi, statics = case
    out4, g4 = _bwd_inputs(case, 1)
    before = rp.BWD_KERNEL.launches
    d = _backward(stream, lo, hi, out4, g4, statics)
    torch.cuda.synchronize()
    assert rp.BWD_KERNEL.launches == before + 1
    ref = rp.composite_stream_backward_reference(stream, lo, hi, out4, g4, statics)
    assert d.shape == stream.shape and torch.isfinite(d).all()
    _assert_grad_close(d, ref)
    # slots no row owns, and the columns that carry no gradient, stay zero
    owned = torch.zeros(stream.shape[0], dtype=torch.bool, device=cuda)
    for a, b in zip(lo.tolist(), hi.tolist()):
        owned[a:b] = True
    assert float(d[~owned].abs().max()) == 0.0
    assert float(d[:, 9:].abs().max()) == 0.0


def test_backward_kernel_large_tile(cuda):
    """32x128 = 4096 pixels: the 512-thread variant of the backward."""
    case = _stream_case(2, 32, 128, 2, 1, 1, 128, 200, cuda)
    stream, lo, hi, statics = case
    out4, g4 = _bwd_inputs(case, 3)
    d = _backward(stream, lo, hi, out4, g4, statics)
    ref = rp.composite_stream_backward_reference(stream, lo, hi, out4, g4, statics)
    _assert_grad_close(d, ref)


def test_backward_kernel_is_deterministic(cuda):
    """Plain stores in a fixed order: two launches give the same bits."""
    case = _stream_case(4, 16, 128, 3, 2, 2, 128, 300, cuda)
    stream, lo, hi, statics = case
    out4, g4 = _bwd_inputs(case, 5)
    a = _backward(stream, lo, hi, out4, g4, statics)
    b = _backward(stream, lo, hi, out4, g4, statics)
    assert torch.equal(a, b)


def test_backward_early_stop_leaves_skipped_windows_zero(cuda):
    """Opaque splats saturate every tile within its first windows; the
    rest of each segment is skipped by forward and backward alike."""
    stream, lo, hi, statics = _stream_case(6, 16, 16, 2, 2, 1, 32, 400, cuda)
    stream[:, 5] = torch.where(stream[:, 9] > 0, 0.99, 0.0)
    stream[:, 2] = stream[:, 4] = 1e-4  # every splat covers its whole tile
    stream[:, 3] = 0.0
    case = (stream, lo, hi, statics)
    out4, g4 = _bwd_inputs(case, 7)
    d = _backward(stream, lo, hi, out4, g4, statics)
    ref = rp.composite_stream_backward_reference(stream, lo, hi, out4, g4, statics)
    _assert_grad_close(d, ref)
    untouched = (d[:, :9].abs().amax(1) == 0) & (stream[:, 9] > 0)
    assert int(untouched.sum()) > 0  # skipped windows hold owned slots
    assert torch.equal(d[:, :9].abs().amax(1) == 0, ref[:, :9].abs().amax(1) == 0)


def test_function_gradient_on_card(cuda):
    """composite_stream as an autograd Function on CUDA tensors: its
    gradient is kernel B2's, equal to the plain backward's and, in the
    columns that carry one, to a central finite difference of the float32
    forward kernel (a gradcheck at float32 resolution: h = 1e-2, atol 2%
    of the largest gradient)."""
    stream, lo, hi, statics = _stream_case(8, 8, 16, 2, 1, 1, 32, 20, cuda)
    stream.requires_grad_(True)
    before = rp.BWD_KERNEL.launches
    out = rp.composite_stream(stream, lo, hi, statics)
    g4 = torch.randn(out.shape, generator=torch.Generator().manual_seed(9)).to(cuda)
    (d,) = torch.autograd.grad(out, stream, g4)
    assert rp.BWD_KERNEL.launches == before + 1
    ref = rp.composite_stream_backward_reference(stream.detach(), lo, hi, out.detach(),
                                                 g4, statics)
    _assert_grad_close(d, ref)
    base = stream.detach()
    scale = float(d.abs().max())
    h = 1e-2
    rows = torch.arange(int(lo[0]), int(hi[-1]), device=cuda)[::7]
    for row in rows.tolist():
        for col in (0, 1, 5, 6):  # mx, my, opacity, red
            plus, minus = base.clone(), base.clone()
            plus[row, col] += h
            minus[row, col] -= h
            fd = ((rp.composite_stream(plus, lo, hi, statics)
                   - rp.composite_stream(minus, lo, hi, statics)) * g4).sum() / (2 * h)
            assert abs(float(fd) - float(d[row, col])) <= 2e-2 * scale, (row, col)


def _adversarial(case):
    """The case's stream with slots the box must get right: every 7th
    conic not positive definite (cxx < 0, det < 0, or zero), every 11th
    near singular, every 5th opacity under the threshold, every 13th at
    it, every 17th at the clip, every 19th centre far off its tile."""
    stream, lo, hi, statics = case
    s = stream.clone()
    n = torch.arange(s.shape[0], device=s.device)
    owned = s[:, 9] > 0

    def sel(k):
        return owned & (n % k == 0)

    s[sel(11), 3] = torch.sqrt(s[sel(11), 2] * s[sel(11), 4]) * (1 - 1e-4)
    s[sel(7), 2] = -s[sel(7), 2]
    s[sel(14), 3] = 2.0 * s[sel(14), 4]
    s[sel(21), 2:5] = 0.0
    s[sel(5), 5] = 0.5 * statics.alpha_threshold
    s[sel(13), 5] = statics.alpha_threshold
    s[sel(17), 5] = statics.alpha_clip
    s[sel(19), 0] += 300.0
    return s, lo, hi, statics


TILE_SHAPES = [
    (16, 128, 128),  # the default config
    (16, 16, 128),  # bench.py's tiles
    (8, 20, 32),  # tile_w not a multiple of 16
    (16, 16, 1024),  # long windows
    (32, 128, 128),  # 4096 pixels: 16 a thread forward, B2's 512-thread variant
]


@pytest.mark.parametrize("tile_h,tile_w,chunk", TILE_SHAPES)
def test_kernels_on_adversarial_slots(cuda, tile_h, tile_w, chunk):
    """Non-positive-definite, near-singular, sub-threshold, at-threshold,
    at-clip and far-off slots: B1 and B2 against their plain versions."""
    case = _adversarial(_stream_case(12, tile_h, tile_w, 3, 2, 2, chunk, 200, cuda))
    stream, lo, hi, statics = case
    out4 = rp.composite_stream(*case)
    torch.testing.assert_close(out4, rp.composite_stream_reference(*case),
                               atol=1e-4, rtol=1e-4)
    g4 = torch.randn(out4.shape, generator=torch.Generator().manual_seed(13)).to(cuda)
    d = _backward(stream, lo, hi, out4, g4, statics)
    _assert_grad_close(d, rp.composite_stream_backward_reference(stream, lo, hi, out4, g4,
                                                                 statics))


@pytest.mark.parametrize("tile_h,tile_w,chunk", [(16, 128, 128), (16, 16, 128)])
def test_heavy_rows_last_in_block_order(cuda, tile_h, tile_w, chunk):
    """Rows laid out shortest first, so the longest are last in blockIdx
    order: the kernels' row order takes them first, and nothing about the
    result depends on it; B2 gives equal bits over two launches."""
    case = _stream_case(14, tile_h, tile_w, 3, 2, 2, chunk, 300, cuda, heavy_last=True)
    stream, lo, hi, statics = case
    seg = hi - lo
    assert int(seg.argmax()) > lo.shape[0] // 2 and seg[rp.row_order(lo, hi)[0]] == seg.max()
    out4 = rp.composite_stream(*case)
    torch.testing.assert_close(out4, rp.composite_stream_reference(*case),
                               atol=1e-4, rtol=1e-4)
    g4 = torch.randn(out4.shape, generator=torch.Generator().manual_seed(15)).to(cuda)
    d = _backward(stream, lo, hi, out4, g4, statics)
    _assert_grad_close(d, rp.composite_stream_backward_reference(stream, lo, hi, out4, g4,
                                                                 statics))
    assert torch.equal(d, _backward(stream, lo, hi, out4, g4, statics))


@pytest.mark.parametrize("name", box_cases.CASES)
def test_kernel_slot_box_is_slot_boxes(cuda, name):
    """The box the kernels stage (tile_boxes.cuh) equals
    rasterize_packed.slot_boxes, computed on the CPU, on every case the CPU
    tests hold slot_boxes to."""
    stream, _, _, statics, origin = box_cases._stream(name, 3)
    ox, oy = origin[:, 0].int(), origin[:, 1].int()
    got = rp._slot_boxes_cuda(stream.to(cuda), ox.to(cuda), oy.to(cuda), statics)
    assert torch.equal(got.cpu(), rp.slot_boxes(stream, ox, oy, statics))


def test_kernel_slot_box_of_non_finite_colours(cuda):
    stream, _, _, statics, origin, idx, _ = box_cases._non_finite_colours(5)
    ox, oy = origin[:, 0].int(), origin[:, 1].int()
    got = rp._slot_boxes_cuda(stream.to(cuda), ox.to(cuda), oy.to(cuda), statics).cpu()
    assert torch.equal(got, rp.slot_boxes(stream, ox, oy, statics))
    assert bool((got[idx] == torch.tensor([0, statics.tile_w - 1, 0, statics.tile_h - 1])).all())


@pytest.mark.parametrize("name", box_cases.CASES)
def test_kernels_on_the_box_cases(cuda, name):
    """B1 and B2 against their plain versions on the CPU tests' box cases
    (pixels on the threshold ellipse, opacity a float32 step around the
    threshold, conics near singular, a clip under the threshold, ...).  A
    pixel where the plain version finds an alpha within rounding of the
    threshold (CompositeWork.tie_pixels) may differ by the one slot of
    alpha = threshold, at most 2 x threshold x the largest colour, as in
    chip_smoke.py; the backward is compared with g4 zeroed there."""
    stream, lo, hi, statics, _ = box_cases._stream(name, 4)
    stream, lo, hi = stream.to(cuda), lo.to(cuda), hi.to(cuda)
    out4 = rp.composite_stream(stream, lo, hi, statics)
    ref, work = rp.composite_stream_reference(stream, lo, hi, statics, return_work=True)
    diff = (out4 - ref).abs()
    off = diff > 1e-4 + 1e-4 * ref.abs()
    assert not bool((off & ~work.tie_pixels[:, None, :]).any())
    assert float(diff.max()) <= 2.0 * statics.alpha_threshold * max(
        1.0, float(stream[:, binning.COL_R:binning.COL_ONE + 1].max()))
    g4 = torch.randn(out4.shape, generator=torch.Generator().manual_seed(17)).to(cuda)
    g4 = g4 * ~work.tie_pixels[:, None, :]
    d = _backward(stream, lo, hi, out4, g4, statics)
    ref_d = rp.composite_stream_backward_reference(stream, lo, hi, out4, g4, statics)
    if name == "clip_below_threshold":  # no slot reaches any pixel
        assert float(d.abs().max()) == 0.0 and float(ref_d.abs().max()) == 0.0
    else:
        _assert_grad_close(d, ref_d)


def test_forward_with_non_finite_colours(cuda):
    """A slot with a colour that is not finite turns every pixel of its
    tile non-finite in the plain forward (c * 0 is NaN); B1 gives it the
    whole tile and agrees, NaN for NaN.  (The backward of such a stream is
    not finite in either version, at elements that need not match.)"""
    stream, lo, hi, statics, *_ = box_cases._non_finite_colours(5)
    stream, lo, hi = stream.to(cuda), lo.to(cuda), hi.to(cuda)
    out4 = rp.composite_stream(stream, lo, hi, statics)
    ref = rp.composite_stream_reference(stream, lo, hi, statics)
    assert not bool(ref.isfinite().all())
    torch.testing.assert_close(out4, ref, atol=1e-4, rtol=1e-4, equal_nan=True)


def test_wrapper_runs_under_inference_mode(cuda):
    """Rendering needs no gradient mode of its own any more."""
    stream, lo, hi, statics = _stream_case(1, 16, 16, 2, 2, 1, 128, 50, cuda)
    with torch.inference_mode():
        out = rp.composite_stream(stream, lo, hi, statics)
    ref = rp.composite_stream_reference(stream, lo, hi, statics)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


# -- the dense [tiles, capacity] compositor ------------------------------------


def _table_case(seed, tile_h, tile_w, ntx, nty, views, chunk, cap, device,
                opacity=(0.05, 0.99), tiles_per_view=0):
    """A random gathered table: tile i holds counts[i] in 0..cap occupied
    rows, then zero pad rows; every fifth tile is empty, every seventh full."""
    rng = np.random.default_rng(seed)
    tt = views * ntx * nty
    counts = rng.integers(0, cap + 1, size=tt)
    counts[::5] = 0
    counts[3::7] = cap
    table = np.zeros((tt, cap, binning.PAYLOAD_DIM), np.float32)
    t = np.arange(tt) % (ntx * nty)
    ox, oy = ((t % ntx) * tile_w)[:, None], ((t // ntx) * tile_h)[:, None]
    sig = rng.uniform(0.7, 4.0, size=(tt, cap))
    table[..., 0] = ox + rng.uniform(-4, tile_w + 4, (tt, cap))
    table[..., 1] = oy + rng.uniform(-4, tile_h + 4, (tt, cap))
    table[..., 2] = table[..., 4] = 1 / sig**2
    table[..., 3] = rng.uniform(-0.2, 0.2, (tt, cap)) / sig**2
    table[..., 5] = rng.uniform(*opacity, (tt, cap))
    table[..., 6:9] = rng.uniform(0, 2, size=(tt, cap, 3))
    table[..., 9] = 1.0
    table[np.arange(cap)[None, :] >= counts[:, None]] = 0.0  # pad rows
    statics = CompositeStatics(
        num_views=views, ntx=ntx, nty=nty, tile_h=tile_h, tile_w=tile_w, chunk=chunk,
        alpha_clip=0.99, alpha_threshold=1 / 255, tiles_per_view=tiles_per_view,
    )
    return (torch.as_tensor(table, device=device),
            torch.arange(tt, dtype=torch.int32, device=device),
            torch.as_tensor(counts, dtype=torch.int32, device=device), statics)


def _table_fwd(gathered, ti, counts, statics):
    """Kernel B3 on a gathered table, passed as the list form on unique ids
    (composite.table_as_lists): the kernels read lists through ids only."""
    rows, ids, ti1, one_view = composite.table_as_lists(gathered, ti, statics)
    return rd.forward(rows, ti1, counts, one_view, ids)


def _table_bwd(gathered, ti, counts, out4, g4, statics):
    """Kernel B4 on a gathered table as lists: the gradient laid out as the
    table."""
    rows, ids, ti1, one_view = composite.table_as_lists(gathered, ti, statics)
    return rd.backward(rows, ti1, counts, out4, g4, one_view, ids).reshape(gathered.shape)


DENSE_CASES = [
    (16, 16, 128, 1024),  # the dense path's shape: 256 pixels, 1 per thread
    (16, 128, 128, 256),  # the default tile: 2048 pixels, 8 per thread
    (8, 20, 32, 96),  # 160 pixels: a partial warp-multiple block
]


def _dense_bwd_inputs(case, seed):
    out4 = _table_fwd(*case)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return out4, torch.randn(out4.shape, generator=gen).to(out4.device)


@pytest.mark.parametrize("tile_h,tile_w,chunk,cap", DENSE_CASES)
def test_dense_kernels_match_plain_versions(cuda, tile_h, tile_w, chunk, cap):
    case = _table_case(0, tile_h, tile_w, 3, 2, 2, chunk, cap, cuda)
    gathered, ti, counts, statics = case
    before = rd.FWD_KERNEL.launches, rd.BWD_KERNEL.launches
    out = _table_fwd(*case)
    g4 = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(cuda)
    d = _table_bwd(gathered, ti, counts, out, g4, statics)
    torch.cuda.synchronize()
    assert (rd.FWD_KERNEL.launches, rd.BWD_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    ref = composite.composite_tiles_reference(*case)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    assert float(out[counts == 0].abs().max()) == 0.0  # an empty list composites nothing
    d_ref = composite.composite_tiles_backward_reference(gathered, ti, counts, out, g4, statics)
    assert d.shape == gathered.shape and torch.isfinite(d).all()
    _assert_grad_close(d, d_ref)
    # pad rows, and the columns that carry no gradient, are written as zeros
    pad = torch.arange(cap, device=cuda)[None, :] >= counts[:, None]
    assert float(d[pad].abs().max()) == 0.0
    assert float(d[..., 9:].abs().max()) == 0.0


def test_dense_backward_large_tile(cuda):
    """32x128 = 4096 pixels: the 512-thread variant of the backward, 16
    pixels a thread in the forward."""
    case = _table_case(2, 32, 128, 2, 1, 1, 128, 256, cuda)
    gathered, ti, counts, statics = case
    out4, g4 = _dense_bwd_inputs(case, 3)
    torch.testing.assert_close(out4, composite.composite_tiles_reference(*case),
                               atol=1e-4, rtol=1e-4)
    d = _table_bwd(gathered, ti, counts, out4, g4, statics)
    _assert_grad_close(d, composite.composite_tiles_backward_reference(
        gathered, ti, counts, out4, g4, statics))
    with pytest.raises(ValueError, match="exceeds the kernel"):
        _table_fwd(gathered, ti, counts, statics._replace(tile_h=64))


def test_dense_tile_indices_with_padded_stride(cuda):
    """Origins come from tile_indices % tiles_per_view, not from the
    position in the table: a shuffled slice with a padded per-view stride."""
    gathered, ti, counts, statics = _table_case(4, 16, 16, 3, 2, 1, 32, 128, cuda)
    stride = 8  # padded from 6
    order = torch.tensor([4, 0, 5, 2], device=cuda)
    ti_off = (order + 2 * stride).to(torch.int32)
    padded = statics._replace(tiles_per_view=stride)
    out = _table_fwd(gathered[order].contiguous(), ti_off, counts[order].contiguous(), padded)
    whole = _table_fwd(gathered, ti, counts, statics)
    assert torch.equal(out, whole[order])
    g4 = torch.randn(whole.shape, generator=torch.Generator().manual_seed(5)).to(cuda)
    d = _table_bwd(gathered[order].contiguous(), ti_off, counts[order].contiguous(), out,
                   g4[order].contiguous(), padded)
    assert torch.equal(d, _table_bwd(gathered, ti, counts, whole, g4, statics)[order])


def test_dense_backward_is_deterministic_and_overwrites(cuda):
    """Lists on unique ids (a table passed as lists) add once to each
    element of a destination the launcher zeroes: two launches give the
    same bits, whatever the memory held before."""
    case = _table_case(6, 16, 16, 3, 2, 2, 128, 512, cuda)
    gathered, ti, counts, statics = case
    out4, g4 = _dense_bwd_inputs(case, 7)
    a = _table_bwd(gathered, ti, counts, out4, g4, statics)
    junk = torch.full_like(gathered, float("nan"))  # recycled by the allocator
    del junk
    b = _table_bwd(gathered, ti, counts, out4, g4, statics)
    assert torch.equal(a, b) and torch.isfinite(b).all()


def test_dense_early_stop_leaves_later_chunks_zero(cuda):
    """Opaque splats that cover their whole tile saturate it within its
    first chunks; forward and backward skip the rest of the list alike."""
    gathered, ti, counts, statics = _table_case(8, 16, 16, 2, 2, 1, 32, 256, cuda)
    occupied = gathered[..., 9] > 0
    gathered[..., 5] = torch.where(occupied, 0.99, 0.0)
    gathered[..., 2] = gathered[..., 4] = torch.where(occupied, 1e-4, 0.0)
    gathered[..., 3] = 0.0
    case = (gathered, ti, counts, statics)
    out4, g4 = _dense_bwd_inputs(case, 9)
    ref, work = composite.composite_tiles_reference(*case, return_work=True)
    torch.testing.assert_close(out4, ref, atol=1e-4, rtol=1e-4)
    assert work.slots < int(counts.sum())  # the stop skipped occupied chunks
    d = _table_bwd(gathered, ti, counts, out4, g4, statics)
    d_ref = composite.composite_tiles_backward_reference(gathered, ti, counts, out4, g4,
                                                         statics)
    _assert_grad_close(d, d_ref)
    untouched = (d[..., :9].abs().amax(-1) == 0) & occupied
    assert int(untouched.sum()) > 0
    assert torch.equal(d[..., :9].abs().amax(-1) == 0, d_ref[..., :9].abs().amax(-1) == 0)


def test_composite_tiles_function_on_card(cuda):
    """composite_tiles as an autograd Function on CUDA tensors: kernels B3
    and B4, equal to the plain versions and, in the columns that carry a
    gradient, to a central finite difference of the float32 forward kernel
    (h = 1e-2, atol 2% of the largest gradient); backend "xla" runs the
    plain version on the card and launches nothing."""
    gathered, ti, counts, statics = _table_case(10, 8, 16, 2, 1, 1, 32, 32, cuda)
    gathered.requires_grad_(True)
    before = rd.FWD_KERNEL.launches, rd.BWD_KERNEL.launches
    out = composite.composite_tiles(gathered, statics, counts=counts)
    g4 = torch.randn(out.shape, generator=torch.Generator().manual_seed(11)).to(cuda)
    (d,) = torch.autograd.grad(out, gathered, g4)
    assert (rd.FWD_KERNEL.launches, rd.BWD_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    base = gathered.detach()
    _assert_grad_close(d, composite.composite_tiles_backward_reference(
        base, ti, counts, out.detach(), g4, statics))
    plain = composite.composite_tiles(base, statics._replace(backend="xla"), counts=counts)
    assert (rd.FWD_KERNEL.launches, rd.BWD_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out.detach(), plain, atol=1e-4, rtol=1e-4)
    scale, h = float(d.abs().max()), 1e-2
    for tile in range(base.shape[0]):
        for slot in range(0, int(counts[tile]), 5):
            for col in (0, 1, 5, 6):  # mx, my, opacity, red
                plus, minus = base.clone(), base.clone()
                plus[tile, slot, col] += h
                minus[tile, slot, col] -= h
                fd = ((_table_fwd(plus, ti, counts, statics)
                       - _table_fwd(minus, ti, counts, statics)) * g4).sum() / (2 * h)
                assert abs(float(fd) - float(d[tile, slot, col])) <= 2e-2 * scale, (
                    tile, slot, col)
    with torch.inference_mode():
        again = composite.composite_tiles(base, statics, counts=counts)
    assert torch.equal(again, out.detach())
    # counts past the capacity are clamped in the kernel: the pad rows they
    # add have zero opacity and change nothing
    assert torch.equal(_table_fwd(base, ti, counts + 40, statics), out.detach())


# -- the dense list form: payload rows through the id table -----------------


def _list_case(seed, tile_h, tile_w, ntx, nty, views, chunk, cap, device, n=96):
    """Random payload rows [V (N + 1), 16] (row N of each view zero) over a
    views x ntx x nty grid and an id table [tiles, cap] drawn with
    repeats, so that many tiles, and slots of one tile, add into one row
    and the backward's atomics collide; every fifth tile empty, every
    seventh full: (rows, ids, tile_indices, counts, statics)."""
    rng = np.random.default_rng(seed)
    tt = views * ntx * nty
    payload = np.zeros((views, n + 1, binning.PAYLOAD_DIM), np.float32)
    sig = rng.uniform(0.7, 4.0, size=(views, n))
    payload[:, :n, 0] = rng.uniform(-4, ntx * tile_w + 4, (views, n))
    payload[:, :n, 1] = rng.uniform(-4, nty * tile_h + 4, (views, n))
    payload[:, :n, 2] = payload[:, :n, 4] = 1 / sig**2
    payload[:, :n, 3] = rng.uniform(-0.2, 0.2, (views, n)) / sig**2
    payload[:, :n, 5] = rng.uniform(0.05, 0.99, (views, n))
    payload[:, :n, 6:9] = rng.uniform(0, 2, size=(views, n, 3))
    payload[:, :n, 9] = 1.0
    counts = rng.integers(0, cap + 1, size=tt)
    counts[::5] = 0
    counts[3::7] = cap
    ids = rng.integers(0, n, size=(tt, cap))
    ids[np.arange(cap)[None, :] >= counts[:, None]] = n  # pad slots
    statics = CompositeStatics(
        num_views=views, ntx=ntx, nty=nty, tile_h=tile_h, tile_w=tile_w, chunk=chunk,
        alpha_clip=0.99, alpha_threshold=1 / 255,
    )

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return (dev(payload.reshape(-1, binning.PAYLOAD_DIM), torch.float32),
            dev(ids, torch.int32), torch.arange(tt, dtype=torch.int32, device=device),
            dev(counts, torch.int32), statics)


@pytest.mark.parametrize("tile_h,tile_w,chunk,cap", DENSE_CASES)
def test_dense_list_kernels_match_plain_versions(cuda, tile_h, tile_w, chunk, cap):
    """composite_tile_lists on the card: one launch of B3 and of B4, each
    against its plain version; empty tiles composite nothing, the pad rows
    and the columns that carry no gradient stay exactly zero."""
    rows, ids, ti, counts, statics = _list_case(0, tile_h, tile_w, 3, 2, 2, chunk, cap, cuda)
    leaf = rows.clone().requires_grad_(True)
    before = rd.FWD_KERNEL.launches, rd.BWD_KERNEL.launches
    out = composite.composite_tile_lists(leaf, ids, statics, counts=counts)
    g4 = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(cuda)
    (d,) = torch.autograd.grad(out, leaf, g4)
    torch.cuda.synchronize()
    assert (rd.FWD_KERNEL.launches, rd.BWD_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    ref = composite.composite_tile_lists_reference(rows, ids, ti, counts, statics)
    out = out.detach()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    assert float(out[counts == 0].abs().max()) == 0.0
    d_ref = composite.composite_tile_lists_backward_reference(rows, ids, ti, counts, out, g4,
                                                              statics)
    assert d.shape == rows.shape and torch.isfinite(d).all()
    _assert_grad_close(d, d_ref)
    view_rows = rows.shape[0] // statics.num_views
    assert float(d[view_rows - 1::view_rows].abs().max()) == 0.0  # each view's pad row
    assert float(d[:, 9:].abs().max()) == 0.0


def test_dense_list_form_equals_table_form(cuda):
    """The kernels on the same lists read through the id table and gathered
    into a table (passed on unique ids): equal bits forward; backward, the
    table's gradient scattered into the rows agrees with the shared rows'
    atomics, and the table's gives equal bits twice."""
    rows, ids, ti, counts, statics = _list_case(2, 16, 16, 3, 2, 2, 128, 1024, cuda)
    table, index, in_list = composite.gather_lists(rows, ids, ti, counts, statics)
    out = rd.forward(rows, ti, counts, statics, ids)
    assert torch.equal(out, _table_fwd(table, ti, counts, statics))
    g4 = torch.randn(out.shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    d_table = _table_bwd(table, ti, counts, out, g4, statics)
    assert torch.equal(d_table, _table_bwd(table, ti, counts, out, g4, statics))
    scattered = torch.zeros_like(rows).index_add_(0, index[in_list], d_table[in_list])
    _assert_grad_close(rd.backward(rows, ti, counts, out, g4, statics, ids), scattered)


def test_dense_list_out_of_range_reads_nothing(cuda):
    """Ids outside [0, N + 1) (the int32 extremes among them) and tile
    indices whose view lies outside [0, V) read and write nothing: the
    kernels give what the same lists give with those slots naming the zero
    pad row and those tiles empty, and agree with their plain versions."""
    rows, ids, ti, counts, statics = _list_case(5, 16, 16, 3, 2, 2, 128, 1024, cuda)
    tt, view_rows = ids.shape[0], rows.shape[0] // statics.num_views
    bad_ids, bad_ti = ids.clone(), ti.clone()
    bad_ids[3, :4] = torch.tensor([view_rows, -1, 2**31 - 1, -2**31], dtype=torch.int32)
    bad_ids[8, 1] = 3 * view_rows
    bad_ti[4], bad_ti[6] = tt + 3, -1
    assert int(counts[3]) == 1024 and int(counts[8]) > 1 and int(counts[4] * counts[6]) > 0
    same_ids = torch.where((bad_ids >= 0) & (bad_ids < view_rows), bad_ids, view_rows - 1)
    same_counts = counts.clone()
    same_counts[4] = same_counts[6] = 0
    out = rd.forward(rows, bad_ti, counts, statics, bad_ids)
    g4 = torch.randn(out.shape, generator=torch.Generator().manual_seed(5)).to(cuda)
    d = rd.backward(rows, bad_ti, counts, out, g4, statics, bad_ids)
    torch.cuda.synchronize()
    assert torch.equal(out, rd.forward(rows, ti, same_counts, statics, same_ids))
    assert float(out[4].abs().max()) == 0.0 == float(out[6].abs().max())
    _assert_grad_close(d, rd.backward(rows, ti, same_counts, out, g4, statics, same_ids))
    ref = composite.composite_tile_lists_reference(rows, bad_ids, bad_ti, counts, statics)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    _assert_grad_close(d, composite.composite_tile_lists_backward_reference(
        rows, bad_ids, bad_ti, counts, out, g4, statics))
    assert float(d[view_rows - 1::view_rows].abs().max()) == 0.0

def _box_lists(name, seed, device):
    """A box case's stream as the list form: tile i reads its row's segment
    of the stream through ids; slots past its count read the stream's last
    row, a zero row."""
    stream, lo, hi, statics, _ = box_cases._stream(name, seed)
    seg = hi - lo
    cap = -(-int(seg.max()) // statics.chunk) * statics.chunk
    k = torch.arange(cap)[None, :]
    ids = torch.where(k < seg[:, None], lo[:, None] + k, stream.shape[0] - 1).to(torch.int32)
    tt = lo.shape[0]
    return (stream.to(device), ids.to(device), torch.arange(tt, dtype=torch.int32, device=device),
            seg.to(device), statics)


@pytest.mark.parametrize("name", box_cases.CASES)
def test_dense_kernels_on_the_box_cases(cuda, name):
    """B3 and B4 (list form) against their plain versions on the CPU tests'
    box cases, with the threshold-tie exemption of
    test_kernels_on_the_box_cases."""
    rows, ids, ti, counts, statics = _box_lists(name, 4, cuda)
    out4 = rd.forward(rows, ti, counts, statics, ids)
    ref, work = composite.composite_tile_lists_reference(rows, ids, ti, counts, statics,
                                                         return_work=True)
    diff = (out4 - ref).abs()
    off = diff > 1e-4 + 1e-4 * ref.abs()
    assert not bool((off & ~work.tie_pixels[:, None, :]).any())
    assert float(diff.max()) <= 2.0 * statics.alpha_threshold * max(
        1.0, float(rows[:, binning.COL_R:binning.COL_ONE + 1].max()))
    g4 = torch.randn(out4.shape, generator=torch.Generator().manual_seed(17)).to(cuda)
    g4 = g4 * ~work.tie_pixels[:, None, :]
    d = rd.backward(rows, ti, counts, out4, g4, statics, ids)
    d_ref = composite.composite_tile_lists_backward_reference(rows, ids, ti, counts, out4, g4,
                                                              statics)
    if name == "clip_below_threshold":  # no slot reaches any pixel
        assert float(d.abs().max()) == 0.0 and float(d_ref.abs().max()) == 0.0
    else:
        _assert_grad_close(d, d_ref)


def _ptxas_report(log):
    """{kernel's mangled name: [ptxas's stack and spill line, its register
    line]} from the build log of nvcc -Xptxas -v."""
    report, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Function properties for (\S+)", line)
        if found:
            name = found.group(1)
            report[name] = []
        elif name and ("spill" in line or "registers" in line):
            report[name].append(line.strip())
    return report


def test_dense_kernels_build_without_spills(cuda):
    """ptxas's registers and spills of every variant of B3 and B4, printed
    for the record; the one-pixel-a-thread variants, which the dense path's
    16x16 tiles run, spill nothing."""
    for kernel in (rd.FWD_KERNEL, rd.BWD_KERNEL):
        report = _ptxas_report(kernel.build_log())
        assert report
        for name, lines in report.items():
            print(kernel.source_name, name, *lines, sep="\n  ")
            if "ILi1E" in name:  # template argument PPT = 1
                assert any(" 0 bytes spill stores" in line for line in lines), lines


# -- checkpoints across devices, the aligner's gradient -------------------------


def _small_trainer(device, packed=True):
    from casualhdrsplat_torch import config
    from casualhdrsplat_torch.data import dataset as dataset_mod
    from casualhdrsplat_torch.train.trainer import Trainer

    cfg = config.TrainConfig()
    cfg.model = config.ModelConfig(
        max_gaussians=384, sh_degree=2, num_virtual_views=3, crf=config.CRFConfig(hidden=8),
        rasterize=config.RasterizeConfig(tile_h=8, tile_w=16, chunk=32, stream_factor=10,
                                         packed=packed, tile_capacity=384))
    cfg.densify.enabled = False
    cfg.data.eval_every = 0
    ds = dataset_mod.make_synthetic_dataset(seed=2, device="cpu", n_gaussians=300, n_frames=3,
                                            n_virtual=3, size=64, angle_span=0.2,
                                            raster_cfg=cfg.model.rasterize)
    return Trainer(cfg, ds, device=device)


@pytest.mark.parametrize("writer,reader", [("cuda", "cpu"), ("cpu", "cuda")])
def test_checkpoint_moves_between_card_and_cpu(cuda, tmp_path, writer, reader):
    """A checkpoint written on one device loads into a trainer on the other
    with every tensor's bits, and the loaded trainer steps on."""
    from casualhdrsplat_torch.train import optim

    src = _small_trainer(writer)
    for _ in range(2):
        src.run_step()
    path = src.save(str(tmp_path / "run"))
    dst = _small_trainer(reader)
    dst.load(path)
    assert dst.step == 2 and dst.opt_state["count"] == 2
    for tree in ("params", "mu", "nu"):
        a = src.params if tree == "params" else src.opt_state[tree]
        b = dst.params if tree == "params" else dst.opt_state[tree]
        for (path_a, _, x), (path_b, _, y) in zip(optim.labelled_leaves(a),
                                                  optim.labelled_leaves(b)):
            assert path_a == path_b and y.device.type == reader
            assert torch.equal(x.cpu(), y.cpu()), (tree, path_a)
    for x, y in zip(src.adc, dst.adc):
        assert y.device.type == reader and torch.equal(x.cpu(), y.cpu())
    assert np.isfinite(dst.run_step()["loss"]) and dst.step == 3


def test_aligner_gradient_card_vs_cpu(cuda):
    """One make_aligner step's gradient (render_pose's backward on the
    per-view packed branch: B2 on the card, its plain version on the CPU)
    agrees, and so does the aligner's first loss."""
    from casualhdrsplat_torch.geometry import lie
    from casualhdrsplat_torch.models import image_formation as imf
    from casualhdrsplat_torch.train import pose_align

    grads, curves = [], []
    xi = torch.tensor([0.012, -0.009, 0.015, 0.01, -0.008, 0.012])
    for dev in (cuda, "cpu"):
        t = _small_trainer(dev)
        t.params["gaussians"]["opacity_logit"] += 2.0
        m = t.cfg.model
        with torch.no_grad():
            dt = imf.exposure_of(t.params, 1)
            vm = imf.poses_at(t.params, t.scene, (t.scene.timestamps[1] + 0.5 * dt)[None], m)[0]
            target, _, _ = imf.render_pose(t.params, t.scene, vm, m, exposure=dt)
            vm_off = lie.mat_mul(lie.se3_exp(xi.to(vm.device)), vm)
        delta = torch.zeros(6, device=vm.device, requires_grad=True)
        img, _, _ = imf.render_pose(t.params, t.scene, lie.mat_mul(lie.se3_exp(delta), vm_off), m,
                                    exposure=dt)
        grads.append(torch.autograd.grad(torch.mean(torch.square(img - target)), delta)[0].cpu())
        curves.append(pose_align.make_aligner(m, steps=2)(t.params, t.scene, vm_off, dt,
                                                          target)[2].cpu())
    scale = float(grads[1].abs().max())
    assert scale > 0
    torch.testing.assert_close(grads[0], grads[1], atol=1e-4 * scale, rtol=1e-3)
    torch.testing.assert_close(curves[0], curves[1], atol=1e-6, rtol=1e-4)
