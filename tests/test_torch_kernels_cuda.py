"""The CUDA compositor kernel (csrc/rasterize_packed_fwd.cu) held against
its plain PyTorch version on the card.  Marked `cuda`: without a card the
fixture skips every test here (the decision is made inside the fixture,
so every pytest-xdist worker collects the same tests).

Run on the card with `python -m pytest tests/test_torch_kernels_cuda.py -m cuda`.

Tolerance: atol 1e-4 + rtol 1e-4.  The kernel carries T as a running
product and the plain version as exp of a log-space prefix sum, so they
differ by float32 rounding (~1e-6); where a tile's max T sits within that
rounding of eps at a window boundary, the skip vote may differ by one
window, which moves a pixel by at most eps times its remaining colour."""

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


def _stream_case(seed, tile_h, tile_w, ntx, nty, views, chunk, per_tile, device):
    """A random depth-sorted stream with per-row segments of 0..2*per_tile
    entries, laid out as the rasterizer lays them out (rows of one view
    are contiguous and start mid-window)."""
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
    stream[s, 5] = rng.uniform(0.05, 0.99, k)
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


def test_kernel_refuses_gradients(cuda):
    stream, lo, hi, statics = _stream_case(1, 16, 16, 2, 2, 1, 128, 50, cuda)
    with pytest.raises(NotImplementedError, match="B2"):
        rp.composite_stream(stream.requires_grad_(True), lo, hi, statics)
