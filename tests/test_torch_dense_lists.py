"""Port parity: the dense compositor's list form (`composite.
composite_tile_lists`: payload rows read through the [tiles, capacity] id
table, no gathered table) against the JAX reference's
`composite_tiles(gather_payload(...))`, whose Pallas kernels B3 and B4 run
in interpret mode (backend="pallas") or whose XLA compositor runs
(backend="xla"), and against the port's own table form (`composite_tiles`
of `gather_payload`).  On the CPU the port runs the plain PyTorch versions
of its kernels.

Tolerances (those of tests/test_torch_dense.py).
- Values: atol 1e-5 + rtol 1e-5 (float32; the same log-space prefix math,
  summed in another order).
- Gradients with respect to the payload rows: atol 1e-4 * scale + rtol
  1e-3, scale = the largest gradient magnitude (sums over pixels, slots and
  tiles run in another order in each package), on the rows 0..N-1 of every
  view: the reference adds the pad slots' cotangents into the pad row N,
  the port drops them and leaves the pad row's gradient exactly zero.
- List form against table form in the port: equal bits for the values
  (the same plain version on the same rows); gradients atol 1e-6 * scale +
  rtol 1e-6 (the same per-slot gradients, scattered by two index_add_s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch.ops import binning as t_bin
from casualhdrsplat_torch.ops import composite as t_comp
from casualhdrsplat_torch.ops import projection as t_proj
from casualhdrsplat_torch.ops import rasterize as t_rast
from casualhdrsplat_torch.ops import rasterize_dense as t_dense
from casualhdrsplat_tpu.data import synthetic
from casualhdrsplat_tpu.ops import composite as j_comp

ALPHA = dict(alpha_clip=0.99, alpha_threshold=1 / 255)


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype))


def _grad_close(a, b, name=""):
    b = np.asarray(b)
    scale = float(np.abs(b).max())
    assert scale > 0.0, name
    np.testing.assert_allclose(np.asarray(a), b, atol=1e-4 * scale, rtol=1e-3, err_msg=name)


def _cloud_case(rng, n, size, tile_h, tile_w, capacity, chunk, views=1, opacity=None,
                **cloud_kw):
    """Payload [V, N+1, 16] and id tables [V, T, capacity] of a random
    cloud through the port's projection and binning: (payload, ids, counts
    [V*T], kwargs of the statics)."""
    cloud = synthetic.random_cloud(rng, n, **cloud_kw)
    opac = _t(cloud.opacities) if opacity is None else torch.full((n,), opacity)
    cams = [synthetic.orbit_camera(0.05 * k, width=size[0], img_height=size[1])
            for k in range(views)]
    cam = cams[0]
    vm = _t(np.stack([np.asarray(c.viewmat) for c in cams]))
    projs = t_proj.cull_invisible(t_proj.project_gaussians(
        _t(cloud.means3d), _t(cloud.quats), _t(cloud.scales), vm, _t(cam.fx), _t(cam.fy),
        _t(cam.cx), _t(cam.cy), *size), opac)
    payload = t_bin.build_payload(projs, _t(cloud.colors), opac)
    lists = [t_bin.assign_tiles_arrays(projs.means2d[k], projs.radii[k], projs.depths[k],
                                       projs.valid[k], *size, tile_h, tile_w, capacity, 32)
             for k in range(views)]
    ntx, nty = t_bin.tile_grid(*size, tile_h, tile_w)
    kw = dict(num_views=views, ntx=ntx, nty=nty, tile_h=tile_h, tile_w=tile_w, chunk=chunk,
              **ALPHA)
    return (payload, torch.stack([t.indices for t in lists]),
            torch.stack([t.counts for t in lists]).reshape(-1), kw)


def _random_case(seed, views, ntx, nty, n, tile_h, tile_w, capacity, chunk):
    """Random payload rows [V, N+1, 16] over a views x ntx x nty grid and
    an id table whose ids repeat across tiles and views, with empty and
    full tiles: (payload, ids [V, T, capacity], counts [V*T], kwargs)."""
    rng = np.random.default_rng(seed)
    w, h = ntx * tile_w, nty * tile_h
    payload = np.zeros((views, n + 1, 16), np.float32)
    sig = rng.uniform(0.7, 4.0, size=(views, n))
    payload[..., :n, 0] = rng.uniform(-4, w + 4, (views, n))
    payload[..., :n, 1] = rng.uniform(-4, h + 4, (views, n))
    payload[..., :n, 2] = payload[..., :n, 4] = 1 / sig**2
    payload[..., :n, 3] = rng.uniform(-0.2, 0.2, (views, n)) / sig**2
    payload[..., :n, 5] = rng.uniform(0.05, 0.99, (views, n))
    payload[..., :n, 6:9] = rng.uniform(0, 2, (views, n, 3))
    payload[..., :n, 9] = 1.0
    t = ntx * nty
    counts = rng.integers(0, capacity + 1, size=views * t)
    counts[::5] = 0  # empty tiles
    counts[3::7] = capacity  # full tiles
    # n < capacity ids drawn with repeats: every id lies in many tiles of
    # every view
    ids = rng.integers(0, n, size=(views * t, capacity))
    ids[np.arange(capacity)[None, :] >= counts[:, None]] = n  # pad slots
    kw = dict(num_views=views, ntx=ntx, nty=nty, tile_h=tile_h, tile_w=tile_w, chunk=chunk,
              **ALPHA)
    return (torch.from_numpy(payload), torch.from_numpy(ids.reshape(views, t, capacity)
                                                        .astype(np.int32)),
            torch.from_numpy(counts.astype(np.int32)), kw)


def _jax_lists(payload, ids, counts, kw, backend, g4=None, tile_indices=None,
               tiles_per_view=0):
    """The reference: composite_tiles of the gathered table (payload rows
    by id, each tile in its own view), under jax.jit; with g4 also the
    gradient with respect to the payload."""
    statics = j_comp.CompositeStatics(backend=backend, tiles_per_view=tiles_per_view, **kw)
    cap = ids.shape[-1]
    idx = ids.reshape(-1, cap).long()
    ti = torch.arange(idx.shape[0]) if tile_indices is None else tile_indices.long()
    view = ti // (tiles_per_view or kw["ntx"] * kw["nty"])
    flat = jnp.asarray((view[:, None] * payload.shape[1] + idx).numpy())
    ti_j = None if tile_indices is None else jnp.asarray(tile_indices.numpy())
    cnt = jnp.asarray(counts.numpy())

    def fn(p):
        gathered = p.reshape(-1, 16)[flat]  # gather_payload, per view
        return j_comp.composite_tiles(gathered, statics, ti_j, cnt)

    p = jnp.asarray(payload.numpy())
    if g4 is None:
        return jax.jit(fn)(p), None
    out, vjp = jax.vjp(jax.jit(fn), p)
    return out, jax.jit(vjp)(jnp.asarray(g4.numpy()))[0]


def _port_lists(payload, ids, counts, statics, tile_indices=None):
    """The port's list form on the flattened payload: (out, d payload
    [V, N+1, 16], g4)."""
    rows = payload.reshape(-1, 16).clone().requires_grad_(True)
    out = t_comp.composite_tile_lists(rows, ids.reshape(-1, ids.shape[-1]), statics,
                                      tile_indices=tile_indices, counts=counts)
    g4 = _t(np.random.default_rng(99).normal(size=tuple(out.shape)))
    (d,) = torch.autograd.grad(out, rows, g4)
    return out.detach(), d.reshape(payload.shape), g4


def _check_against_jax(payload, ids, counts, kw, backend, tile_indices=None,
                       tiles_per_view=0):
    statics = t_comp.CompositeStatics(backend=backend, tiles_per_view=tiles_per_view, **kw)
    out, d, g4 = _port_lists(payload, ids, counts, statics, tile_indices)
    out_j, d_j = _jax_lists(payload, ids, counts, kw, backend, g4, tile_indices,
                            tiles_per_view)
    n = payload.shape[1] - 1
    np.testing.assert_allclose(out, out_j, atol=1e-5, rtol=1e-5)
    _grad_close(d[:, :n], np.asarray(d_j)[:, :n])
    assert float(d[:, n].abs().max()) == 0.0  # the pad row is a constant
    assert float(d[..., 9:].abs().max()) == 0.0
    return out, d, statics


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("tile_h,tile_w,capacity,views", [(8, 16, 64, 2), (16, 16, 128, 1)])
def test_lists_match_jax(rng, backend, tile_h, tile_w, capacity, views):
    """Values and payload-row gradients of a random cloud's lists, one and
    two views, against both of the reference's compositors."""
    payload, ids, counts, kw = _cloud_case(rng, 100, (32, 32), tile_h, tile_w, capacity, 32,
                                           views=views)
    out, _, _ = _check_against_jax(payload, ids, counts, kw, backend)
    assert float(out.abs().max()) > 0.1 and int(counts.max()) > 32  # several chunks


def test_lists_equal_table_form(rng):
    """The list form against the port's table form (composite_tiles of
    gather_payload) on the same lists: equal values, the same gradient of
    the payload rows."""
    payload, ids, counts, kw = _cloud_case(rng, 100, (32, 32), 8, 16, 64, 32, views=2)
    statics = t_comp.CompositeStatics(**kw)
    out, d, g4 = _port_lists(payload, ids, counts, statics)
    leaf = payload.clone().requires_grad_(True)
    table = t_bin.gather_payload(leaf, t_bin.TileLists(ids, counts, None, None))
    out_t = t_comp.composite_tiles(table.reshape(-1, 64, 16), statics, counts=counts)
    (d_t,) = torch.autograd.grad(out_t, leaf, g4)
    assert torch.equal(out, out_t.detach())
    scale = float(d_t.abs().max())
    torch.testing.assert_close(d, d_t, atol=1e-6 * scale, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_repeated_ids_empty_and_full_tiles(seed):
    """Ids that repeat across tiles and views (a row's gradient sums over
    many tiles), empty tiles, full tiles, pad slots past counts."""
    payload, ids, counts, kw = _random_case(seed, views=2, ntx=3, nty=2, n=40, tile_h=8,
                                            tile_w=16, capacity=64, chunk=32)
    assert int((counts == 0).sum()) > 0 and int((counts == 64).sum()) > 0
    out, d, _ = _check_against_jax(payload, ids, counts, kw, "pallas")
    assert float(out[counts == 0].abs().max()) == 0.0  # an empty list composites nothing
    ref = t_comp.composite_tile_lists_reference(
        payload.reshape(-1, 16), ids.reshape(-1, 64),
        torch.arange(counts.shape[0], dtype=torch.int32), counts,
        t_comp.CompositeStatics(**kw))
    assert torch.equal(out, ref)


def test_early_stop(rng):
    """Opaque splats that cover the whole tile end it within its first
    chunk; the reference's Pallas kernel stops at the same chunk, and the
    rows of the slots the stop skipped get no gradient."""
    payload, ids, counts, kw = _cloud_case(rng, 120, (16, 16), 16, 16, 128, 32, opacity=0.98,
                                           extent=0.3, scale_range=(1.5, 2.5))
    out, d, statics = _check_against_jax(payload, ids, counts, kw, "pallas")
    rows, ti = payload.reshape(-1, 16), torch.arange(1, dtype=torch.int32)
    _, work = t_comp.composite_tile_lists_reference(rows, ids[0], ti, counts, statics,
                                                    return_work=True)
    assert work.slots % 32 == 0 and work.slots < int(counts[0])
    skipped = ids[0, 0, work.slots:int(counts[0])].long()
    visited = ids[0, 0, :work.slots].long()
    assert float(d[0, skipped].abs().max()) == 0.0 < float(d[0, visited].abs().max())


def test_padded_tile_indices_slice():
    """A caller that composites a slice of the tiles passes offset indices
    and a padded per-view stride: the view of tile i, and so its payload
    rows, come from tile_indices[i] // tiles_per_view, its origin from
    tile_indices[i] % tiles_per_view."""
    payload, ids, counts, kw = _random_case(3, views=2, ntx=3, nty=2, n=40, tile_h=8,
                                            tile_w=16, capacity=64, chunk=32)
    stride = 8  # padded from 6
    order = torch.tensor([9, 0, 7, 2, 11, 4])  # tiles of both views, shuffled
    ti = ((order // 6) * stride + order % 6).to(torch.int32)
    flat = ids.reshape(-1, 64)
    sl_ids, sl_counts = flat[order], counts[order]
    out, _, statics = _check_against_jax(payload, sl_ids, sl_counts, kw, "pallas",
                                         tile_indices=ti, tiles_per_view=stride)
    whole, _, _ = _port_lists(payload, ids, counts, t_comp.CompositeStatics(**kw))
    assert torch.equal(out, whole[order])


def test_out_of_range_ids_and_views_read_nothing():
    """The plain list form, as the kernels: a slot whose id lies outside
    [0, N + 1) composites as an empty slot, and a tile whose view lies
    outside [0, V) as an empty list; value and row gradient equal those of
    the same lists with such slots naming the zero pad row and such tiles
    empty."""
    payload, ids, counts, kw = _random_case(4, views=2, ntx=3, nty=2, n=40, tile_h=8,
                                            tile_w=16, capacity=64, chunk=32)
    statics = t_comp.CompositeStatics(**kw)
    flat, n = ids.reshape(-1, 64), payload.shape[1] - 1
    tt = flat.shape[0]
    assert int(counts[3]) == 64 and int(counts[4] * counts[6]) > 0
    bad_ids, ti = flat.clone(), torch.arange(tt, dtype=torch.int32)
    bad_ids[3, :4] = torch.tensor([n + 1, -1, 2**31 - 1, -2**31], dtype=torch.int32)
    bad_ti = ti.clone()
    bad_ti[4], bad_ti[6] = tt + 3, -1
    same_counts = counts.clone()
    same_counts[4] = same_counts[6] = 0
    same_ids = torch.where((bad_ids >= 0) & (bad_ids <= n), bad_ids, n)
    outs = []
    for args in ((bad_ids, bad_ti, counts), (same_ids, ti, same_counts)):
        rows = payload.reshape(-1, 16).clone().requires_grad_(True)
        out = t_comp.composite_tile_lists(rows, args[0], statics, tile_indices=args[1],
                                          counts=args[2])
        g4 = _t(np.random.default_rng(7).normal(size=tuple(out.shape)))
        outs.append((out.detach(), torch.autograd.grad(out, rows, g4)[0]))
    (out, d), (out_same, d_same) = outs
    assert torch.equal(out, out_same) and torch.equal(d, d_same)
    assert float(out[4].abs().max()) == 0.0 < float(out[3].abs().max())

def test_composite_tile_lists_checks_and_defaults():
    """Defaults (tile_indices arange, counts the capacity), the checks of
    shapes, types and views, and no kernel launch for CPU tensors."""
    statics = t_comp.CompositeStatics(num_views=2, ntx=2, nty=1, tile_h=4, tile_w=4,
                                      chunk=8, **ALPHA)
    rows = torch.zeros(2 * 5, 16)
    rows[..., 0:2] = 2.0
    rows[..., 2] = rows[..., 4] = 0.1
    rows[..., 5] = 0.5
    rows[..., 6:10] = 1.0
    rows[4::5] = 0.0  # each view's pad row
    ids = torch.tensor([[0, 1, 2, 3] * 4] * 4, dtype=torch.int32)
    before = (t_dense.FWD_KERNEL.launches, t_dense.BWD_KERNEL.launches)
    out = t_comp.composite_tile_lists(rows, ids, statics)
    assert out.shape == (4, 4, 16) and float(out[:, 3].min()) > 0.5
    empty = t_comp.composite_tile_lists(rows, ids, statics,
                                        counts=torch.zeros(4, dtype=torch.int32))
    assert float(empty.abs().max()) == 0.0
    assert (t_dense.FWD_KERNEL.launches, t_dense.BWD_KERNEL.launches) == before
    with pytest.raises(ValueError, match="multiple of chunk"):
        t_comp.composite_tile_lists(rows, ids[:, :12], statics)
    with pytest.raises(TypeError, match="int32"):
        t_comp.composite_tile_lists(rows, ids.long(), statics)
    with pytest.raises(TypeError, match="float32"):
        t_comp.composite_tile_lists(rows.double(), ids, statics)
    with pytest.raises(ValueError, match="views"):
        t_comp.composite_tile_lists(rows[:9], ids, statics)
    with pytest.raises(TypeError, match="shape \\[tiles\\]"):
        t_comp.composite_tile_lists(rows, ids, statics, counts=torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_dense_rasterize_gathers_no_table(backend, monkeypatch):
    """rasterize(packed=False) reads the payload through the id table:
    gather_payload runs only for backend "xla", whose plain compositor
    takes the gathered table, as the reference's does."""
    calls = []
    gather = t_bin.gather_payload

    def counted(*a, **kw):
        calls.append(1)
        return gather(*a, **kw)

    monkeypatch.setattr(t_bin, "gather_payload", counted)
    cloud = synthetic.random_cloud(np.random.default_rng(5), 60)
    cam = synthetic.orbit_camera(0.0, width=24, img_height=16)
    cfg = t_config.RasterizeConfig(packed=False, backend=backend, tile_h=8, tile_w=16,
                                   tile_capacity=64, chunk=32)
    colors = _t(cloud.colors).requires_grad_(True)
    images, _, _ = t_rast.rasterize(
        _t(cloud.means3d), _t(cloud.quats), _t(cloud.scales), _t(cloud.opacities), colors,
        _t(cam.viewmat), _t(cam.fx), _t(cam.fy), _t(cam.cx), _t(cam.cy), 24, 16, cfg)
    (d,) = torch.autograd.grad(images.sum(), colors)
    assert float(d.abs().max()) > 0.0
    assert len(calls) == (1 if backend == "xla" else 0)
