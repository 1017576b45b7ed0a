"""The start-up k-NN (casualhdrsplat_torch/ops/knn.py): the host grid search
of native/chs_native.cc, built at first use (data/_native.py), against the
NumPy brute force; the fallback where no library can be built; its record
and span.  Small clouds only: the grid's arithmetic does not depend on the
size.  On the card (marked `cuda`): the grid at a 3,145,728-point cloud
against the brute force on a subset, and the stream gather's offsets at
that store's size."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from casualhdrsplat_torch.data import _native
from casualhdrsplat_torch.ops import cuda_build
from casualhdrsplat_torch.ops import knn
from casualhdrsplat_torch.utils import profiling


def _compiler():
    try:
        cuda_build.find_host_compiler()
    except RuntimeError:
        pytest.skip("no host compiler: the grid k-NN's library cannot be built here")


def cloud(kind: str, m: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        pts = rng.uniform(-1.0, 1.0, (m, 3))
    elif kind == "normal":
        pts = rng.normal(size=(m, 3)) * 3.0 + 5.0
    elif kind == "duplicates":  # every point four times
        pts = np.repeat(rng.uniform(-1.0, 1.0, (-(-m // 4), 3)), 4, 0)[:m]
    elif kind == "planar":
        pts = np.c_[rng.uniform(-1.0, 1.0, (m, 2)), np.zeros(m)]
    elif kind == "collinear":  # equal gaps: ties everywhere
        pts = np.arange(m)[:, None] * np.array([0.5, 0.25, 0.125])
    elif kind == "axis":  # a line along x: a grid of zero volume
        pts = np.c_[np.arange(m) * 0.5, np.zeros(m), np.zeros(m)]
    else:  # a tilted line with irregular gaps
        t = np.sort(rng.uniform(0.0, 1.0, m))
        pts = t[:, None] * np.array([1.0, 2.0, -0.5])
    return np.ascontiguousarray(pts, np.float32)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("kind,m", [("uniform", 2000), ("uniform", 7), ("uniform", 2),
                                    ("normal", 1500), ("duplicates", 600), ("planar", 900),
                                    ("collinear", 40), ("line", 300)])
def test_grid_route_matches_numpy(kind, m, k):
    _compiler()
    pts = cloud(kind, m)
    got = knn.knn_mean_dist(pts, k, device="cpu")
    assert knn.LAST.route == "grid" and knn.LAST.points == m
    assert got.dtype == torch.float32 and got.shape == (m,)
    np.testing.assert_allclose(got.numpy(), knn.knn_mean_dist_numpy(pts, k), rtol=1e-5, atol=0)


def test_grid_route_on_a_line_along_an_axis():
    """No extent in y and z: the grid's cells shrink to the 1e-12 volume
    floor, and its rings widen one cell at a time (seconds at more points
    or a larger k)."""
    _compiler()
    pts = cloud("axis", 6)
    np.testing.assert_allclose(knn.knn_mean_dist(pts, 1, device="cpu").numpy(),
                               knn.knn_mean_dist_numpy(pts, 1), rtol=1e-5, atol=0)


@pytest.mark.parametrize("m", [0, 1])
def test_grid_route_on_empty_and_single_clouds(m):
    _compiler()
    got = knn.knn_mean_dist(cloud("uniform", m), 3, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.full((m,), 0.01, np.float32))


def test_the_library_is_built_at_first_use_into_the_build_dir(tmp_path, monkeypatch):
    """A fresh build directory: the first load compiles native/chs_native.cc
    (the span chs.kernel.build), the library is named by the source's and
    the command's hash, and a second build finds it."""
    _compiler()
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    _native._open.cache_clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            lib = _native.library()
        built = sorted((tmp_path / "build").glob("chs_native-*.so"))
        assert len(built) == 1 and built[0].with_suffix(".so.log").exists()
        assert cuda_build.build_host(_native.SOURCE) == built[0]
        assert any(e.name == "chs.kernel.build" for e in prof.events())
        pts = cloud("normal", 200)
        np.testing.assert_allclose(_native.knn_mean_dist(lib, pts, 3),
                                   knn.knn_mean_dist_numpy(pts, 3), rtol=1e-5, atol=0)
    finally:
        _native._open.cache_clear()


def test_without_a_library_the_cpu_takes_the_brute_force(tmp_path, monkeypatch):
    def no_compiler():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "find_host_compiler", no_compiler)
    _native._open.cache_clear()
    try:
        assert _native.load() is None
        pts = cloud("uniform", 500)
        got = knn.knn_mean_dist(pts, 3, chunk=64, device="cpu")
        assert knn.LAST.route == "brute" and knn.LAST.points == 500
        np.testing.assert_allclose(got.numpy(), knn.knn_mean_dist_numpy(pts, 3), rtol=1e-5,
                                   atol=0)
        # on a card a failed build raises rather than fall back to the blocks
        with pytest.raises(RuntimeError, match="no compiler"):
            knn.knn_mean_dist(pts, 3, device="cuda")
    finally:
        _native._open.cache_clear()


@pytest.mark.parametrize("chunk", [64, 2048])
def test_brute_forces_agree(chunk):
    pts = cloud("uniform", 700, seed=3)
    np.testing.assert_allclose(knn.knn_mean_dist_brute(pts, 3, chunk, "cpu").numpy(),
                               knn.knn_mean_dist_numpy(pts, 3, chunk), rtol=1e-5, atol=0)


def test_a_call_is_a_span_with_a_record():
    _compiler()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        knn.knn_mean_dist(cloud("uniform", 300), 3, device="cpu")
    assert any(e.name == "chs.init.knn" for e in prof.events())
    last = knn.LAST
    assert (last.points, last.route) == (300, "grid") and last.ms >= 0.0
    assert not profiling.recording()


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card's routes run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_grid_at_ladder5_size_on_the_card(cuda):
    """ladder5-pod's 3,145,728 points: the grid's result on the card, no
    [2048, N] block allocated, equal within rtol 1e-5 to the brute force on
    the card over a 262,144-point subset."""
    gen = torch.Generator().manual_seed(5)
    pts = (torch.rand((3 << 20, 3), generator=gen) * 2.0 - 1.0).numpy()
    torch.cuda.reset_peak_memory_stats(cuda)
    got = knn.knn_mean_dist(pts, 3, device=cuda)
    assert knn.LAST.route == "grid" and got.device.type == "cuda"
    assert torch.cuda.max_memory_allocated(cuda) < 2 ** 28
    sub = pts[: 1 << 18]
    np.testing.assert_allclose(knn.knn_mean_dist(sub, 3, device=cuda).cpu().numpy(),
                               knn.knn_mean_dist_brute(sub, 3, 2048, cuda).cpu().numpy(),
                               rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_stream_gather_offsets_at_ladder5_size_on_the_card(cuda):
    """The packed step's stream at 3,145,728 Gaussians: 8 views of a
    6N-slot stream, 2,415,919,104 floats, past 2^31.  The gather and G1 at
    the slots whose element offsets pass 2^31: the last view's tail."""
    from casualhdrsplat_torch.ops import stream_gather as sg

    n, views = 3 << 20, 8
    rows, s = n + 1, 6 * n
    gen = torch.Generator(device=cuda).manual_seed(2)
    ids = torch.randint(0, rows - 1, (s,), generator=gen, device=cuda, dtype=torch.int32)
    ids[-1000:] = rows - 1  # the budget's unused tail names the pad row
    payload = torch.randn((views, rows, 16), generator=gen, device=cuda)
    payload[:, rows - 1] = 0.0
    stream = sg.gather_stream(payload, ids)
    assert stream.numel() > 2 ** 31
    tail = torch.arange(s - 5000, s, device=cuda)
    for v in (0, views - 1):
        assert torch.equal(stream[v, tail], payload[v, ids[tail].long()])
    del stream
    cot = torch.randn((views, s, 16), generator=gen, device=cuda)
    got = sg._backward_cuda(cot, ids, rows)
    assert torch.equal(got[:, rows - 1], torch.zeros_like(got[:, rows - 1]))
    # the rows that the last 5,000 real slots name, summed directly
    last = ids[-6000:-1000].long().unique()
    slot = torch.isin(ids.long(), last).nonzero()[:, 0]
    which = torch.searchsorted(last, ids[slot].long())
    for v in (0, views - 1):
        want = torch.zeros((last.numel(), 16), dtype=torch.float64, device=cuda)
        want.index_add_(0, which, cot[v, slot].double())
        torch.testing.assert_close(got[v, last].double(), want, rtol=1e-5, atol=1e-5)
