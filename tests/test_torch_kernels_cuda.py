"""The CUDA compositor kernels (csrc/rasterize_packed_fwd.cu and
csrc/rasterize_packed_bwd.cu) held against their plain PyTorch versions on
the card.  Marked `cuda`: without a card the
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

import numpy as np
import pytest
import torch

from casualhdrsplat_torch.ops import binning
from casualhdrsplat_torch.ops import rasterize_packed as rp
from casualhdrsplat_torch.ops.composite import CompositeStatics

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _stream_case(seed, tile_h, tile_w, ntx, nty, views, chunk, per_tile, device,
                 opacity=(0.05, 0.99)):
    """A random depth-sorted stream with per-row segments of 0..2*per_tile
    entries, laid out as the rasterizer lays them out (rows of one view
    are contiguous and start mid-window); every fifth row is empty."""
    rng = np.random.default_rng(seed)
    rows = views * ntx * nty
    seg = rng.integers(0, 2 * per_tile, size=rows)
    seg[::5] = 0  # empty tiles
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
    d = rp._backward_cuda(stream, lo, hi, out4, g4, statics)
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
    d = rp._backward_cuda(stream, lo, hi, out4, g4, statics)
    ref = rp.composite_stream_backward_reference(stream, lo, hi, out4, g4, statics)
    _assert_grad_close(d, ref)


def test_backward_kernel_is_deterministic(cuda):
    """Plain stores in a fixed order: two launches give the same bits."""
    case = _stream_case(4, 16, 128, 3, 2, 2, 128, 300, cuda)
    stream, lo, hi, statics = case
    out4, g4 = _bwd_inputs(case, 5)
    a = rp._backward_cuda(stream, lo, hi, out4, g4, statics)
    b = rp._backward_cuda(stream, lo, hi, out4, g4, statics)
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
    d = rp._backward_cuda(stream, lo, hi, out4, g4, statics)
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


def test_wrapper_runs_under_inference_mode(cuda):
    """Rendering needs no gradient mode of its own any more."""
    stream, lo, hi, statics = _stream_case(1, 16, 16, 2, 2, 1, 128, 50, cuda)
    with torch.inference_mode():
        out = rp.composite_stream(stream, lo, hi, statics)
    ref = rp.composite_stream_reference(stream, lo, hi, statics)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
