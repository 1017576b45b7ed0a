"""The packed stream gather and its transpose, kernel G1
(ops/stream_gather.py, csrc/stream_gather_bwd.cu).

On the CPU, on small streams (N = 200 Gaussians on a 4x6 grid of 16x8
tiles, chunk 32) whose ids come from the reference's own binning
(`binning.sorted_stream`, `waterfill_segments`, `compact_stream_ids`): a
budget that overflows (waterfilled far tails dropped) and one that leaves a
pad tail, one Gaussian in many tiles and one in none, with shared ids (the
reference's `payload[stream_ids]` under `jax.vmap`) and per-view ids
(`payload[stream_ids]` per view):
- the port's gather equals the reference's to the bit, and its backward is
  within atol 1e-6 x the largest gradient + rtol 1e-6 of `jax.vjp` of the
  reference's expression on rows 0..N-1 (the pad row's gradient is
  dropped; XLA's scatter-add may add a row's slots in another order, a
  few float32 roundings of sums of a handful of terms);
- the backward equals the autograd transpose the port used before
  (`torch.gather` / `index_select`) to the bit on those rows: on a CPU both
  add in index order;
- the emulation of G1's schedule equals the plain version (`index_add_`)
  to the bit;
- the inverse index holds every slot once, in increasing order within its
  row, under its own row;
- the emulation of the counting pass that builds G1's index on the card
  (`slot_index_emulation`: histogram, scan, a placement stable by
  construction) gives every real row the list `inverse_index` gives it, on
  those streams, on ids all pad, on an empty stream, on a row holding
  max_tiles_per_gaussian slots and under a random bucketing order; and
  G1's emulation fed the index of a random bucketing order still equals
  the plain version to the bit.
Also: the function checks its inputs, without grad it is the gather
alone, and `step_compare` (G1's parent-against-this measurement) exits 2
without a card.

On the card (marked `cuda`, skipped here; JAX is imported only by the CPU
tests, so the file runs with --noconftest there): the kernel equal to the
emulation to the bit, two launches equal to the bit, and the kernel within
BWD_ATOL_REL x the largest + BWD_RTOL (chip_smoke.py's backward tolerance:
1e-4, 1e-3) of `scatter_add_`, which adds with float atomics; the index
kernel equal to its emulation (offsets, and the placed slots) on the CPU
cases above; G1 at the quality run's per-view size and past 2^31 gradient
elements.
"""

import numpy as np
import pytest
import torch

from casualhdrsplat_torch.ops import binning as t_binning
from casualhdrsplat_torch.ops import cuda_build
from casualhdrsplat_torch.ops import stream_gather as sg

N, WIDTH, HEIGHT, TILE_H, TILE_W, MTPG, CHUNK = 200, 64, 48, 8, 16, 16, 32
NUM_TILES = (WIDTH // TILE_W) * (HEIGHT // TILE_H)
# the reference's tolerance: atol this x the largest gradient, rtol this
ATOL_REL = RTOL = 1e-6
# the card's: chip_smoke.py's BWD_ATOL_REL and BWD_RTOL
BWD_ATOL_REL, BWD_RTOL = 1e-4, 1e-3


def _footprints(seed: int):
    """Seeded screen footprints of N Gaussians: Gaussian 0 covers many tiles
    (clamped to MTPG), Gaussian 1 none (invalid)."""
    rng = np.random.default_rng(seed)
    means2d = rng.uniform([0, 0], [WIDTH, HEIGHT], (N, 2)).astype(np.float32)
    radii = rng.uniform(1.0, 9.0, N).astype(np.float32)
    depths = rng.uniform(0.5, 5.0, N).astype(np.float32)
    valid = rng.uniform(size=N) > 0.1
    means2d[0], radii[0], valid[0] = (WIDTH / 2, HEIGHT / 2), 40.0, True
    valid[1] = False
    return means2d, radii, depths, valid


def _budget(kind: str) -> int:
    """A stream budget that overflows the demand of every seed, or one that
    leaves a pad tail, in whole chunks."""
    return 8 * CHUNK if kind == "overflow" else 40 * CHUNK


def _reference_ids(seed: int, budget: int):
    """(stream ids [budget] int32, dropped) by the reference's binning."""
    import jax.numpy as jnp

    from casualhdrsplat_tpu.ops import binning as j_binning

    m, r, d, v = (jnp.asarray(a) for a in _footprints(seed))
    s_gauss, starts, seg_len, _ = j_binning.sorted_stream(m, r, d, v, WIDTH, HEIGHT, TILE_H,
                                                          TILE_W, MTPG)
    seg_c, starts_c = j_binning.waterfill_segments(seg_len, budget)
    ids = j_binning.compact_stream_ids(s_gauss, starts, starts_c, budget, N,
                                       unconditional=True)
    return np.array(ids, np.int32), int(seg_len.sum() - seg_c.sum())


def _port_ids(seed: int, budget: int, device="cpu"):
    m, r, d, v = (torch.as_tensor(a, device=device) for a in _footprints(seed))
    s_gauss, starts, seg_len, _ = t_binning.sorted_stream(m, r, d, v, WIDTH, HEIGHT, TILE_H,
                                                          TILE_W, MTPG)
    _, starts_c = t_binning.waterfill_segments(seg_len, budget)
    return t_binning.compact_stream_ids(s_gauss, starts, starts_c, budget, N)


def _case(mode: str, kind: str, views: int = 3, seed: int = 0, reference=True):
    """(payload [V, N + 1, 16] with a zero pad row, ids [S] or [V, S],
    cotangent [V, S, 16]) as numpy arrays, and the reference's dropped
    counts."""
    budget = _budget(kind)
    seeds = [seed] if mode == "shared" else [seed + k for k in range(views)]
    make = _reference_ids if reference else (lambda s, b: (_port_ids(s, b).numpy(), None))
    ids, dropped = zip(*(make(s, budget) for s in seeds))
    ids = ids[0] if mode == "shared" else np.stack(ids)
    rng = np.random.default_rng(seed + 100)
    payload = rng.normal(size=(views, N + 1, 16)).astype(np.float32)
    payload[:, N] = 0.0
    cot = rng.normal(size=(views, budget, 16)).astype(np.float32)
    return payload, ids, cot, dropped


def _port_backward(payload, ids, cot):
    p = torch.as_tensor(payload).requires_grad_(True)
    out = sg.gather_stream(p, torch.as_tensor(ids))
    grad, = torch.autograd.grad(out, p, torch.as_tensor(cot))
    return out.detach(), grad


@pytest.mark.parametrize("kind", ["overflow", "tail"])
@pytest.mark.parametrize("mode", ["shared", "per_view"])
def test_backward_matches_the_reference_vjp(mode, kind):
    import jax
    import jax.numpy as jnp

    payload, ids, cot, dropped = _case(mode, kind)
    flat = ids.reshape(-1)
    # the case holds what it claims: drops or a pad tail, Gaussian 0 in
    # many slots, Gaussian 1 in none
    if kind == "overflow":
        assert min(dropped) > 0
    else:
        assert all(int((row == N).sum()) > 0 for row in np.atleast_2d(ids))
    assert int((flat == 0).sum()) >= 6 and int((flat == 1).sum()) == 0

    if mode == "shared":
        def gather(p):
            return jax.vmap(lambda pv: pv[jnp.asarray(ids)])(p)
    else:
        def gather(p):
            return jax.vmap(lambda pv, iv: pv[iv])(p, jnp.asarray(ids))
    want, vjp = jax.vjp(gather, jnp.asarray(payload))
    want_grad, = vjp(jnp.asarray(cot))
    want, want_grad = np.asarray(want), np.asarray(want_grad)[:, :N]

    got, grad = _port_backward(payload, ids, cot)
    np.testing.assert_array_equal(got.numpy(), want)
    grad = grad.numpy()
    np.testing.assert_allclose(grad[:, :N], want_grad, rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(want_grad).max()))
    assert float(np.abs(grad[:, N]).max()) == 0.0  # the pad row: zeros
    assert float(np.abs(grad[:, 1]).max()) == 0.0  # a Gaussian in no tile


@pytest.mark.parametrize("kind", ["overflow", "tail"])
@pytest.mark.parametrize("mode", ["shared", "per_view"])
def test_backward_equals_the_autograd_transpose_on_the_cpu(mode, kind):
    """The CPU's numbers stay those of the transpose the port used before:
    gather's scatter_add_ (shared) and index_select's index_add_ (per view)."""
    payload, ids, cot, _ = _case(mode, kind, reference=False)
    p = torch.as_tensor(payload).requires_grad_(True)
    t_ids = torch.as_tensor(ids)
    if mode == "shared":
        before = torch.gather(p, 1, t_ids.long()[None, :, None].expand(p.shape[0], -1, 16))
    else:
        before = torch.stack([p[k].index_select(0, t_ids[k].long())
                              for k in range(p.shape[0])])
    want, = torch.autograd.grad(before, p, torch.as_tensor(cot))
    got, grad = _port_backward(payload, ids, cot)
    assert torch.equal(got, before.detach())
    assert torch.equal(grad[:, :N], want[:, :N])


@pytest.mark.parametrize("kind", ["overflow", "tail"])
@pytest.mark.parametrize("mode", ["shared", "per_view"])
def test_emulation_equals_the_plain_version(mode, kind):
    _, ids, cot, _ = _case(mode, kind, reference=False)
    ids, cot = torch.as_tensor(ids), torch.as_tensor(cot)
    plain = sg.stream_gather_backward_reference(cot, ids, N + 1)
    emulated = sg.stream_gather_backward_emulation(cot, ids, N + 1)
    assert torch.equal(emulated, plain)
    assert float(plain.abs().max()) > 0.0


@pytest.mark.parametrize("mode", ["shared", "per_view"])
def test_inverse_index_holds_every_slot_once_in_order(mode):
    _, ids, _, _ = _case(mode, "tail", reference=False)
    ids = torch.as_tensor(ids)
    offsets, slots = sg.inverse_index(ids, N + 1)
    views = 1 if mode == "shared" else ids.shape[0]
    s = ids.shape[-1]
    assert offsets.dtype == slots.dtype == torch.int32
    assert offsets.shape == (views * (N + 1) + 1,) and slots.shape == (views * s,)
    assert int(offsets[0]) == 0 and int(offsets[-1]) == views * s
    # every slot once, the pad slots' included
    assert torch.equal(torch.sort(slots.long()).values, torch.arange(views * s))
    flat_ids = ids.reshape(-1).long()
    for key in range(views * (N + 1)):
        row = slots[offsets[key]:offsets[key + 1]].long()
        assert bool((row[1:] > row[:-1]).all()), key
        view, r = divmod(key, N + 1)
        assert bool((flat_ids[row] == r).all()) and bool((row // s == view).all()), key
    assert int(offsets[N + 1] - offsets[N]) > 0  # the pad tail is one row's


def _index_case(mode: str, case: str, views: int = 3):
    """Stream ids for the index tests: [S] shared or [V, S] per view, with
    N + 1 rows (N the pad id)."""
    if case in ("overflow", "tail", "shuffled"):
        _, ids, _, _ = _case(mode, "tail" if case == "shuffled" else case, views=views,
                             reference=False)
        return torch.as_tensor(ids)
    rng = np.random.default_rng(7)
    shape = (500,) if mode == "shared" else (views, 500)
    if case == "all_pad":
        return torch.full(shape, N, dtype=torch.int32)
    if case == "empty":
        return torch.zeros(shape[:-1] + (0,), dtype=torch.int32)
    # one row (7) in MTPG slots of every view, the rest random, a pad tail
    ids = rng.integers(0, N, size=shape).astype(np.int32)
    ids[ids == 7] = 8
    ids[..., 400:] = N
    for row in ids.reshape(-1, 500):
        row[rng.choice(400, MTPG, replace=False)] = 7
    return torch.as_tensor(ids)


def _real_lists(offsets, slots, ids):
    """(each real row's slot count, its slots concatenated in key order):
    the information G1 reads, whatever the pad rows hold."""
    keys = sg._keys(ids, N + 1).long()
    n_keys = offsets.numel() - 1
    counts = (offsets[1:] - offsets[:-1]).long()
    real_key = torch.arange(n_keys) % (N + 1) != N
    placed = slots[:int(offsets[-1])].long()
    placed = placed[(keys[placed] % (N + 1)) != N] if placed.numel() else placed
    return counts[real_key], placed


INDEX_CASES = ["overflow", "tail", "all_pad", "empty", "long_row", "shuffled"]


@pytest.mark.parametrize("case", INDEX_CASES)
@pytest.mark.parametrize("mode", ["shared", "per_view"])
def test_counting_index_emulation_equals_inverse_index(mode, case):
    ids = _index_case(mode, case)
    order = None
    if case == "shuffled":
        order = torch.as_tensor(np.random.default_rng(3).permutation(ids.numel()))
    offsets, slots = sg.slot_index_emulation(ids, N + 1, order)
    views = 1 if mode == "shared" else ids.shape[0]
    assert offsets.dtype == slots.dtype == torch.int32
    assert offsets.shape == (views * (N + 1) + 1,) and slots.shape == (ids.numel(),)
    counts, placed = _real_lists(offsets, slots, ids)
    want_counts, want = _real_lists(*sg.inverse_index(ids, N + 1), ids)
    assert torch.equal(counts, want_counts) and torch.equal(placed, want)
    # the pad rows hold nothing, so the placed slots are the real ones alone
    assert int(offsets[-1]) == int((ids != N).sum()) == placed.numel()
    if case == "long_row":
        assert int(counts[7]) == MTPG and int(counts.max()) == MTPG
    if case in ("all_pad", "empty"):
        assert int(offsets.abs().max()) == 0


@pytest.mark.parametrize("mode", ["shared", "per_view"])
def test_emulation_on_a_shuffled_placement_equals_the_plain_version(mode):
    """The bucketing's order (the kernel's atomics) does not reach the sums:
    the placement puts each row's slots back in increasing order."""
    _, ids, cot, _ = _case(mode, "overflow", reference=False)
    ids, cot = torch.as_tensor(ids), torch.as_tensor(cot)
    rng = np.random.default_rng(11)
    plain = sg.stream_gather_backward_reference(cot, ids, N + 1)
    for _ in range(3):
        order = torch.as_tensor(rng.permutation(ids.numel()))
        index = sg.slot_index_emulation(ids, N + 1, order)
        assert torch.equal(sg.stream_gather_backward_emulation(cot, ids, N + 1, index), plain)


def test_counting_index_runs_on_the_card_only():
    """On the CPU the backward is index_add_ and builds no index; the
    counting pass refuses a CPU tensor rather than stand in for its plain
    version.  Its histogram call is a part of its launch: only the
    placement's entry point counts (and is registered for graph replays)."""
    with pytest.raises(ValueError, match="card"):
        sg.slot_index(torch.zeros(4, dtype=torch.int32), 3)
    assert any(c is sg.INDEX for c in cuda_build.COUNTERS)
    assert not any(c is sg.INDEX_COUNT for c in cuda_build.COUNTERS)


def test_gather_checks_its_inputs_and_skips_autograd_without_grad():
    payload = torch.zeros(2, 5, 16)
    ids = torch.tensor([0, 4, 2], dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        sg.gather_stream(payload, ids.long())
    with pytest.raises(ValueError, match=r"\[S\] or \[V, S\]"):
        sg.gather_stream(payload, ids.expand(3, -1))
    with pytest.raises(ValueError, match=r"\[V, R, 16\]"):
        sg.gather_stream(payload[..., :8], ids)
    out = sg.gather_stream(payload.requires_grad_(True), ids)
    assert type(out.grad_fn).__name__ == "_GatherStreamBackward"
    with torch.no_grad():
        assert sg.gather_stream(payload, ids).grad_fn is None
    assert sg.gather_stream(payload.detach(), ids).grad_fn is None


def test_step_compare_needs_the_card(capsys):
    """The parent-against-this comparison (step_compare) measures on the
    card only: without one it exits 2 and prints no result."""
    from casualhdrsplat_torch import step_compare

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the comparison would run")
    assert step_compare.main(["--parent", "."]) == 2
    assert capsys.readouterr().out == ""


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: kernel G1 runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["overflow", "tail"])
@pytest.mark.parametrize("mode", ["shared", "per_view"])
def test_kernel_matches_emulation_on_the_card(cuda, mode, kind):
    _, ids, cot, _ = _case(mode, kind, reference=False)
    ids, cot = torch.as_tensor(ids, device=cuda), torch.as_tensor(cot, device=cuda)
    before = sg.KERNEL.launches, sg.INDEX.launches
    got = sg._backward_cuda(cot, ids, N + 1)
    again = sg._backward_cuda(cot, ids, N + 1)
    assert (sg.KERNEL.launches, sg.INDEX.launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(got, again)
    assert torch.equal(got, sg.stream_gather_backward_emulation(cot, ids, N + 1))
    assert torch.equal(got.cpu(), sg.stream_gather_backward_emulation(cot.cpu(), ids.cpu(),
                                                                      N + 1))
    want = sg.stream_gather_backward_reference(cot, ids, N + 1)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, atol=BWD_ATOL_REL * scale, rtol=BWD_RTOL)


@pytest.mark.cuda
def test_kernel_at_a_larger_stream_on_the_card(cuda):
    """8 views of a 600,000-slot stream over 100,001 rows, a heavy pad tail
    and rows of up to 40 slots, against scatter_add_ (shared) and the
    emulation: long rows cross the kernel's batches of 8."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    rows, s = 100_001, 600_000
    ids = torch.randint(0, rows - 1, (s,), generator=gen, device=cuda, dtype=torch.int32)
    ids[: s // 5] = rows - 1
    ids[s // 5: s // 5 + 40] = 7
    cot = torch.randn((8, s, 16), generator=gen, device=cuda)
    got = sg._backward_cuda(cot, ids, rows)
    assert torch.equal(got, sg._backward_cuda(cot, ids, rows))
    assert torch.equal(got, sg.stream_gather_backward_emulation(cot, ids, rows))
    index = ids.long()[None, :, None].expand(8, -1, 16)
    want = torch.zeros_like(got).scatter_add_(1, index, cot)
    want[:, rows - 1] = 0.0
    torch.testing.assert_close(got, want, atol=BWD_ATOL_REL * float(want.abs().max()),
                               rtol=BWD_RTOL)
    per_view = ids[None].expand(8, -1).contiguous()
    assert torch.equal(sg._backward_cuda(cot, per_view, rows), got)


@pytest.mark.cuda
@pytest.mark.parametrize("case", INDEX_CASES)
@pytest.mark.parametrize("mode", ["shared", "per_view"])
def test_index_kernel_matches_emulation_on_the_card(cuda, mode, case):
    """The counting pass on the card: its offsets equal the emulation's, its
    placed slots too (the tail it leaves unwritten is not compared), two
    launches equal."""
    ids = _index_case(mode, case).to(cuda)
    offsets, slots = sg.slot_index(ids, N + 1)
    again = sg.slot_index(ids, N + 1)
    want_offsets, want = sg.slot_index_emulation(ids, N + 1)
    total = int(want_offsets[-1])
    assert torch.equal(offsets, want_offsets) and torch.equal(again[0], want_offsets)
    assert torch.equal(slots[:total], want[:total]) and torch.equal(again[1][:total], want[:total])
    counts, placed = _real_lists(offsets.cpu(), slots.cpu(), ids.cpu())
    want_counts, want_placed = _real_lists(*sg.inverse_index(ids.cpu(), N + 1), ids.cpu())
    assert torch.equal(counts, want_counts) and torch.equal(placed, want_placed)


@pytest.mark.cuda
@pytest.mark.parametrize("slots_per_view", [1_572_864, 16_800_000], ids=["quality", "past_2e31"])
def test_kernel_at_the_quality_run_size_on_the_card(cuda, slots_per_view):
    """Per-view ids over the quality run's 131,072-slot store and 8 views:
    its streams (12 x 131,072 slots a view) and streams long enough that the
    gradient passes 2^31 elements (the kernel's 64-bit element offsets), a
    30% pad tail; G1 equal to its emulation and launch to launch, within the
    backward tolerance of index_add_."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    views, rows = 8, 131_073
    ids = torch.randint(0, rows - 1, (views, slots_per_view), generator=gen, device=cuda,
                        dtype=torch.int32)
    ids[:, int(0.7 * slots_per_view):] = rows - 1
    cot = torch.randn((views, slots_per_view, 16), generator=gen, device=cuda)
    assert cot.numel() > 2**31 or slots_per_view == 1_572_864
    got = sg._backward_cuda(cot, ids, rows)
    assert torch.equal(got, sg._backward_cuda(cot, ids, rows))
    assert torch.equal(got, sg.stream_gather_backward_emulation(cot, ids, rows))
    want = sg.stream_gather_backward_reference(cot, ids, rows)
    torch.testing.assert_close(got, want, atol=BWD_ATOL_REL * float(want.abs().max()),
                               rtol=BWD_RTOL)
