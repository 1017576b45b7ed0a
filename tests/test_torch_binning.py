"""Port parity: ops/binning.py (streaming half) against the JAX reference.

Every integer output must be EQUAL, not close: the stream order, segment
starts, waterfill caps, chunk schedule and compacted ids decide which
Gaussian lands in which slot.  The float payload is held at atol 0 (it is
a pure re-layout)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casualhdrsplat_torch.ops import binning as tb
from casualhdrsplat_torch.ops.projection import Projected as TProjected
from casualhdrsplat_torch.ops.rasterize_packed import row_windows
from casualhdrsplat_tpu.ops import binning as jb
from casualhdrsplat_tpu.ops.projection import Projected as JProjected

W, H, TH, TW = 40, 28, 8, 16


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _footprints(rng, n, max_r=30.0, ties=True):
    m2d = rng.uniform(-10, [W + 10, H + 10], size=(n, 2)).astype(np.float32)
    radii = np.ceil(rng.uniform(0.0, max_r, size=n)).astype(np.float32)
    depths = rng.uniform(0.5, 5.0, size=n).astype(np.float32)
    if ties:  # depth ties must break by index, as jnp's stable argsort does
        depths[::7] = depths[0]
    valid = rng.uniform(size=n) > 0.2
    return m2d, radii, depths, valid


def _both(*arrays):
    return ([torch.from_numpy(np.array(a)) for a in arrays],
            [jnp.asarray(a) for a in arrays])


@pytest.mark.parametrize("mtpg", [4, 32])
def test_sorted_stream_and_tile_demand(rng, mtpg):
    args_t, args_j = _both(*_footprints(rng, 150))
    out_t = tb.sorted_stream(*args_t, W, H, TH, TW, mtpg)
    out_j = jb.sorted_stream(*args_j, W, H, TH, TW, mtpg)
    for a, b in zip(out_t, out_j):
        _equal(a, b)
    assert int(out_t[3]) > 0 or mtpg == 32  # the mtpg clamp clipped cells
    m2d, r, _, v = args_t
    _equal(tb.tile_demand(m2d, r, v, W, H, TH, TW, mtpg),
           jb.tile_demand(args_j[0], args_j[1], args_j[3], W, H, TH, TW, mtpg))
    assert tb.tile_grid(W, H, TH, TW) == jb.tile_grid(W, H, TH, TW)


def test_sorted_stream_two_key_fallback(rng):
    """rank_bits + tile bits > 31 (2^20 + 1 Gaussians over 1024 tiles)
    takes the reference's two-key sort; the port uses one int64 key."""
    n = (1 << 20) + 1
    m2d = rng.uniform(0, 32, size=(n, 2)).astype(np.float32)
    radii = np.zeros(n, np.float32)
    depths = rng.integers(0, 1000, size=n).astype(np.float32)  # many ties
    valid = rng.uniform(size=n) > 0.1
    args_t, args_j = _both(m2d, radii, depths, valid)
    assert tb._ceil_log2(n) + tb._ceil_log2(32 * 32 + 1) > 31
    out_t = tb.sorted_stream(*args_t, 32, 32, 1, 1, 1)
    out_j = jb.sorted_stream(*args_j, 32, 32, 1, 1, 1)
    for a, b in zip(out_t, out_j):
        _equal(a, b)


@pytest.mark.parametrize("budget", [10_000, 300, 97, 0])
def test_waterfill_segments(rng, budget):
    seg_len = rng.integers(0, 60, size=35).astype(np.int32)
    seg_len[3] = 400  # one overloaded tile
    out_t = tb.waterfill_segments(torch.from_numpy(seg_len), budget)
    out_j = jb.waterfill_segments(jnp.asarray(seg_len), budget)
    for a, b in zip(out_t, out_j):
        _equal(a, b)
    assert int(out_t[0].sum()) <= budget


def _stream_case(rng, budget):
    args_t, args_j = _both(*_footprints(rng, 120))
    s_gauss, starts, seg_len, _ = tb.sorted_stream(*args_t, W, H, TH, TW, 8)
    seg_c, starts_c = tb.waterfill_segments(seg_len, budget)
    return s_gauss, starts, seg_len, seg_c, starts_c


@pytest.mark.parametrize("budget", [4096, 256])  # no overflow / overflow
def test_compact_stream_ids(rng, budget):
    s_gauss, starts, seg_len, seg_c, starts_c = _stream_case(rng, budget)
    overflow = int(seg_len.sum()) > budget
    assert overflow == (budget == 256)
    ids_t = tb.compact_stream_ids(s_gauss, starts, starts_c, budget, 120)
    j = [jnp.asarray(x.numpy()) for x in (s_gauss, starts, starts_c)]
    _equal(ids_t, jb.compact_stream_ids(*j, budget, 120))
    _equal(ids_t, jb.compact_stream_ids(*j, budget, 120, unconditional=True))


@pytest.mark.parametrize("chunk", [8, 32])
def test_pack_stream_chunks_matches_row_windows(rng, chunk):
    """The reference's chunk schedule is reproduced exactly, and the port's
    compositor windows (per-row (lo, hi)) are the schedule's used chunks."""
    budget = 512
    _, _, _, seg_c, starts_c = _stream_case(rng, budget)
    m = budget
    num_tiles = seg_c.shape[0]
    c_budget = m // chunk + num_tiles + 1
    out_t = tb.pack_stream_chunks(starts_c, seg_c, m, chunk, c_budget, 0, num_tiles)
    out_j = jb.pack_stream_chunks(jnp.asarray(starts_c.numpy()), jnp.asarray(seg_c.numpy()),
                                  m, chunk, c_budget, 0, num_tiles)
    for a, b in zip(out_t, out_j):
        _equal(a, b)

    lo = starts_c[:-1].to(torch.int32)
    first, count = row_windows(lo, lo + seg_c, chunk)
    live = (out_t.seg_lo < out_t.seg_hi).numpy()
    sched = sorted(zip(out_t.out_row.numpy()[live], out_t.block_id.numpy()[live]))
    mine = sorted((r, int(first[r]) + k) for r in range(num_tiles)
                  for k in range(int(count[r])))
    assert sched == mine
    assert tb.stream_budget(120, 8, num_tiles, chunk) == jb.stream_budget(
        120, 8, num_tiles, chunk)


def test_build_payload(rng):
    n = 30
    proj = dict(
        means2d=rng.normal(size=(n, 2)), depths=rng.normal(size=n),
        conics=rng.normal(size=(n, 3)), radii=rng.uniform(size=n),
        valid=rng.uniform(size=n) > 0.3, compensation=rng.uniform(size=n),
    )
    proj = {k: np.asarray(v, bool if k == "valid" else np.float32) for k, v in proj.items()}
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    opa = rng.uniform(size=n).astype(np.float32)
    pt = tb.build_payload(TProjected(**{k: torch.from_numpy(v) for k, v in proj.items()}),
                          torch.from_numpy(colors), torch.from_numpy(opa))
    pj = jb.build_payload(JProjected(**{k: jnp.asarray(v) for k, v in proj.items()}),
                          jnp.asarray(colors), jnp.asarray(opa))
    _equal(pt, pj)
    assert (tb.PAYLOAD_DIM, tb.COL_OPA, tb.COL_ONE) == (jb.PAYLOAD_DIM, jb.COL_OPA, jb.COL_ONE)
