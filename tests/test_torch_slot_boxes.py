"""The slot box of the packed compositor kernels (`rasterize_packed.
slot_boxes`, the formula of `slot_box` in csrc/rasterize_packed_{fwd,bwd}.cu)
held against the plain version's own evaluation of alpha, on random and
adversarial streams: near-singular and non-positive-definite conics,
opacities below, at and above alpha_threshold and at the clip, centres off
the tile, a clip under the threshold.

Each case checks that every (slot, pixel) pair with alpha > 0 (alpha >=
threshold) lies inside the slot's box, and that the plain forward with the
pairs outside the boxes masked out equals the unmasked one bit for bit:
skipping them, as the kernels do, changes nothing."""

import numpy as np
import pytest
import torch

from casualhdrsplat_torch.ops import binning
from casualhdrsplat_torch.ops import composite
from casualhdrsplat_torch.ops import rasterize_packed as rp
from casualhdrsplat_torch.ops.composite import CompositeStatics

TILE_H, TILE_W, NTX, NTY, CHUNK = 8, 20, 3, 2, 16
THRESHOLD = 1 / 255
F32_THRESHOLD = float(np.float32(THRESHOLD))


def _conics(rng, k, sig=(0.7, 4.0)):
    s = rng.uniform(*sig, size=k)
    return np.stack([1 / s**2, rng.uniform(-0.2, 0.2, k) / s**2, 1 / s**2], axis=1)


def _near_singular(rng, k):
    """cxy^2 = cxx cyy (1 - delta)^2, delta from 1e-2 down to 1e-9: the
    box stretches along a diagonal, then gives way to the whole tile."""
    a = 10.0 ** rng.uniform(-3, 1, k)
    b = 10.0 ** rng.uniform(-3, 1, k)
    delta = 10.0 ** rng.uniform(-9, -2, k)
    sign = rng.choice([-1.0, 1.0], k)
    return np.stack([a, sign * np.sqrt(a * b) * (1 - delta), b], axis=1)


def _not_positive_definite(rng, k):
    """cxx <= 0, det <= 0 or both: power > 0 somewhere, alpha = opa there."""
    c = _conics(rng, k)
    kind = np.arange(k) % 4
    c[kind == 0, 0] = -c[kind == 0, 0]  # cxx < 0
    c[kind == 1, 1] = 2 * np.sqrt(c[kind == 1, 0] * c[kind == 1, 2])  # det < 0
    c[kind == 2, 1] = np.sqrt(c[kind == 2, 0] * c[kind == 2, 2])  # det = 0
    c[kind == 3] = 0.0  # a constant alpha = opa
    return c


def _case(name, seed):
    """(centres relative to the slot's tile origin [k, 2], conics [k, 3],
    opacities [k], alpha_clip)."""
    rng = np.random.default_rng(seed)
    k = 240
    centre = np.stack([rng.uniform(-4, TILE_W + 4, k), rng.uniform(-4, TILE_H + 4, k)], 1)
    conic, opa, clip = _conics(rng, k), rng.uniform(0.05, 0.99, k), 0.99
    if name == "near_singular":
        conic = _near_singular(rng, k)
    elif name == "not_positive_definite":
        conic = _not_positive_definite(rng, k)
    elif name == "opacity_near_threshold":
        t = np.float32(THRESHOLD)
        near = [np.nextafter(t, np.float32(0)), t, np.nextafter(t, np.float32(1)),
                t * np.float32(1.0001), t * np.float32(1.01), t * np.float32(2)]
        opa = np.asarray(near, np.float32)[np.arange(k) % len(near)]
        conic = _conics(rng, k, sig=(0.3, 8.0))
    elif name == "opacity_at_clip":
        opa = np.where(np.arange(k) % 2, 0.99, 1.0)
    elif name == "centre_off_tile":
        far = rng.choice([-1.0, 1.0], size=(k, 2)) * 10.0 ** rng.uniform(0.5, 4, (k, 2))
        centre = np.where(rng.uniform(size=(k, 2)) < 0.5, far, centre)
        conic = _conics(rng, k, sig=(0.5, 40.0))
    elif name == "pixel_on_the_edge":
        # a pixel centre at offset d sits on the threshold ellipse at its
        # extreme along an axis (axis-aligned conics, d on an axis): opa =
        # threshold * exp(Q(d)), so its alpha rounds to either side, and it
        # lies on the edge of the unpadded box
        centre = np.floor(centre) + 0.5
        d = rng.integers(1, 5, size=(k, 2)) * rng.choice([-1, 1], size=(k, 2))
        d = (d * np.stack([np.arange(k) % 2, 1 - np.arange(k) % 2], 1)).astype(np.float64)
        conic = _conics(rng, k, sig=(1.0, 4.0))
        conic[:, 1] = 0.0
        q = 0.5 * (conic[:, 0] * d[:, 0] ** 2 + conic[:, 2] * d[:, 1] ** 2)
        opa = np.minimum(THRESHOLD * np.exp(q), 0.99).astype(np.float32)
        step = np.arange(k) % 3  # one float32 step down, none, one up
        opa = np.where(step == 0, np.nextafter(opa, np.float32(0)), opa)
        opa = np.where(step == 2, np.nextafter(opa, np.float32(1)), opa)
    elif name == "clip_below_threshold":
        clip = 0.5 * THRESHOLD
    elif name != "random":
        raise ValueError(name)
    return centre, conic, opa, clip


def _stream(name, seed):
    """A stream of the case's slots, laid out over the rows of a 3x2-tile
    view: (stream [M, 16], row_lo, row_hi, statics, origin [M, 2])."""
    centre, conic, opa, clip = _case(name, seed)
    rng = np.random.default_rng(seed + 1)
    k, rows = len(opa), NTX * NTY
    row_of = np.sort(rng.integers(0, rows, k))
    seg = np.bincount(row_of, minlength=rows)
    lo = 5 + np.concatenate([[0], np.cumsum(seg)[:-1]])
    m = -(-(5 + k + 1) // CHUNK) * CHUNK
    tile = row_of % rows
    origin = np.zeros((m, 2))
    origin[5:5 + k] = np.stack([(tile % NTX) * TILE_W, (tile // NTX) * TILE_H], 1)
    stream = np.zeros((m, binning.PAYLOAD_DIM), np.float32)
    s = slice(5, 5 + k)
    stream[s, binning.COL_MX:binning.COL_MY + 1] = origin[s] + centre
    stream[s, binning.COL_CXX:binning.COL_CYY + 1] = conic
    stream[s, binning.COL_OPA] = opa
    stream[s, binning.COL_R:binning.COL_B + 1] = rng.uniform(0, 2, (k, 3))
    stream[s, binning.COL_ONE] = 1.0
    statics = CompositeStatics(num_views=1, ntx=NTX, nty=NTY, tile_h=TILE_H, tile_w=TILE_W,
                               chunk=CHUNK, alpha_clip=clip, alpha_threshold=THRESHOLD)
    return (torch.from_numpy(stream), torch.as_tensor(lo, dtype=torch.int32),
            torch.as_tensor(lo + seg, dtype=torch.int32), statics, torch.as_tensor(origin))


def _inside(boxes, tile_w, p):
    """[..., 4] boxes -> [..., P] pixels of a tile_w-wide tile inside them."""
    idx = torch.arange(p)
    x, y = idx % tile_w, idx // tile_w
    b = boxes[..., None, :]
    return (x >= b[..., 0]) & (x <= b[..., 1]) & (y >= b[..., 2]) & (y <= b[..., 3])


CASES = ["random", "near_singular", "not_positive_definite", "opacity_near_threshold",
         "opacity_at_clip", "centre_off_tile", "pixel_on_the_edge", "clip_below_threshold"]


@pytest.mark.parametrize("name", CASES)
def test_touched_pairs_lie_inside_the_box(name):
    stream, _, _, statics, origin = _stream(name, 3)
    ox, oy = origin[:, 0], origin[:, 1]
    px, py = composite.pixel_coords(ox.long(), oy.long(), TILE_H, TILE_W)  # [M, 1, P]
    alpha, *_ = composite._alpha_terms(stream[:, None, :], px, py, statics.alpha_clip,
                                       statics.alpha_threshold)
    touched = alpha[:, 0, :] > 0.0
    boxes = rp.slot_boxes(stream, ox, oy, statics)
    inside = _inside(boxes, TILE_W, TILE_H * TILE_W)
    assert not bool((touched & ~inside).any())
    in_box = int(inside.sum())
    if name == "clip_below_threshold":
        assert in_box == 0 and not bool(touched.any())
    elif name not in ("not_positive_definite", "near_singular"):
        # the box is a real bound, not the whole tile
        assert 0 < int(touched.sum()) <= in_box < inside.numel() // 2
    if name == "near_singular":  # both the stretched box and the whole tile occur
        whole = (boxes == torch.tensor([0, TILE_W - 1, 0, TILE_H - 1])).all(-1)
        assert 0 < int(whole.sum()) < len(boxes)
    if name == "opacity_near_threshold":  # under the float32 threshold: empty
        below = stream[:, binning.COL_OPA] < F32_THRESHOLD
        assert bool(below.any())
        assert bool((boxes[below] == torch.tensor(rp.EMPTY_BOX)).all())


@pytest.mark.parametrize("name", CASES)
def test_plain_forward_outside_the_boxes_is_zero(name, monkeypatch):
    stream, lo, hi, statics, _ = _stream(name, 4)
    plain = rp.composite_stream_reference(stream, lo, hi, statics)
    alpha_terms = composite._alpha_terms

    def boxed(chunk, px, py, alpha_clip, alpha_threshold):
        alpha, *rest = alpha_terms(chunk, px, py, alpha_clip, alpha_threshold)
        boxes = rp.slot_boxes(chunk, px[:, 0, :1] - 0.5, py[:, 0, :1] - 0.5, statics)
        return (torch.where(_inside(boxes, statics.tile_w, alpha.shape[-1]), alpha, 0.0),
                *rest)

    monkeypatch.setattr(composite, "_alpha_terms", boxed)
    masked = rp.composite_stream_reference(stream, lo, hi, statics)
    assert torch.equal(masked, plain)
    if name not in ("clip_below_threshold",):
        assert float(plain.abs().max()) > 0.0


def _non_finite_colours(seed):
    """The random case's stream with a colour that is not finite (inf,
    -inf, NaN, or the `one` column) in every 5th slot whose window lies
    inside its row's segment, every other one of them with its opacity
    under the threshold.  (The plain versions composite a window's slots of
    other rows at opacity 0, so a non-finite colour there would spill into
    this row as c * 0; the kernels never read those slots.)"""
    stream, lo, hi, statics, origin = _stream("random", seed)
    pos = torch.arange(int(lo.min()), int(hi.max()))
    row = torch.searchsorted(hi.long(), pos, right=True)
    window = pos // CHUNK * CHUNK
    inner = (window >= lo[row]) & (window + CHUNK <= hi[row])
    idx = pos[inner][::5].contiguous()
    cols = torch.tensor([binning.COL_R, binning.COL_G, binning.COL_B, binning.COL_ONE])
    values = torch.tensor([float("inf"), float("-inf"), float("nan")])
    col = cols[torch.arange(len(idx)) % 4]
    stream[idx, col] = values[torch.arange(len(idx)) % 3]
    stream[idx[::2], binning.COL_OPA] = 0.5 * THRESHOLD
    return stream, lo, hi, statics, origin, idx, col


def test_non_finite_colour_takes_the_whole_tile():
    """c * 0 is NaN: the plain forward's blend changes every pixel of the
    tile for such a slot, whatever its alpha (to NaN, or to +-inf where its
    alpha is not 0), so its box is the tile."""
    stream, lo, hi, statics, origin, idx, col = _non_finite_colours(5)
    boxes = rp.slot_boxes(stream, origin[:, 0], origin[:, 1], statics)
    assert bool((boxes[idx] == torch.tensor([0, TILE_W - 1, 0, TILE_H - 1])).all())
    plain = rp.composite_stream_reference(stream, lo, hi, statics)
    rows = torch.searchsorted(hi.long(), idx, right=True)
    assert not bool(plain[rows, col - binning.COL_R].isfinite().any())


def test_row_order_puts_long_rows_first():
    lo = torch.tensor([0, 3, 3, 10, 12], dtype=torch.int32)
    hi = torch.tensor([3, 3, 10, 12, 19], dtype=torch.int32)
    order = rp.row_order(lo, hi)
    assert order.dtype == torch.int32
    assert order.tolist() == [2, 4, 0, 3, 1]
