"""What the traced inputs ask of the compositor and the rest of a step or
a render, counted from the inputs alone: the benchmark's own binning of
the state the program held (benchmark/reference/render.py), never the
program's work records or its row layout.

A (slot, pixel) pair is work when the slot's alpha at the pixel reaches
alpha_threshold while the pixel's transmittance before the slot is still
at least transmittance_eps: later pairs change the pixel by less than eps
times a colour, so no implementation needs them.  A slot is needed when
some pixel of its tile still has transmittance >= eps before it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from benchmark.reference import geometry as geo
from benchmark.reference import render as ref


class Work(NamedTuple):
    pairs: int  # (slot, pixel) pairs as above
    slots: int  # needed slots
    rows: int  # distinct (view, Gaussian) payload rows among the needed slots
    pixels: int  # output pixels, over the views
    gaussian_views: int  # Gaussians projected and shaded, over the views (the store)
    params: int  # parameter elements Adam updates (training only)
    crf_pixels: int  # pixels through the CRF forward (LDR only when serving)
    loss_pixels: int  # pixels of the blurred frames the loss compares (training only)
    units: int  # steps or requests counted

    def __add__(self, other):
        return Work(*(a + b for a, b in zip(self, other)))


ZERO = Work(0, 0, 0, 0, 0, 0, 0, 0, 0)


@torch.no_grad()
def composite_work(binned: ref.Binned, r: ref.Raster):
    """(pairs, slots, rows) of one binning, by walking its rows' windows."""
    dev = binned.payload.device
    tiles = binned.ntx * binned.nty
    pairs = slots = 0
    rows_seen = torch.zeros(binned.payload.shape[0], dtype=torch.bool, device=dev)
    batches, _ = ref.row_batches(binned.windows, r.chunk * r.tile_h * r.tile_w)
    for rows in batches:
        px, py = ref._pixels(rows, tiles, binned.ntx, r)
        t = torch.ones((rows.shape[0], 1, r.tile_h * r.tile_w), device=dev)
        count = binned.windows[rows]
        for k in range(int(count.max()) if rows.numel() else 0):
            sel = ((count > k) & (t.amax(dim=(1, 2)) >= r.transmittance_eps)).nonzero()[:, 0]
            if sel.numel() == 0:
                break
            index, in_list = binned.slot_of(rows[sel], k)
            chunk = binned.payload[index]
            mx, my, cxx, cxy, cyy, opa = (chunk[..., i:i + 1] for i in range(6))
            dx, dy = px[sel] - mx, py[sel] - my
            power = -(0.5 * (cxx * dx * dx + cyy * dy * dy) + cxy * dx * dy)
            alpha = torch.clamp(opa * in_list[..., None] * torch.exp(torch.clamp(power, max=0.0)),
                                max=r.alpha_clip)
            alpha = torch.where(alpha >= r.alpha_threshold, alpha, 0.0)
            log1m = torch.log1p(-alpha)
            incl = torch.cumsum(log1m, 1)
            before = t[sel] * torch.exp(incl - log1m)  # [s, G, P]
            alive = before >= r.transmittance_eps
            pairs += int(((alpha > 0) & alive).sum())
            needed = alive.any(-1) & in_list
            slots += int(needed.sum())
            rows_seen[index[needed]] = True
            t[sel] = t[sel] * torch.exp(incl[:, -1:])
    return pairs, slots, int(rows_seen.sum())


def _frame(state, sc: ref.Scene, frame: int, model: dict, sh_degree: int) -> Work:
    viewmats, _ = ref.frame_viewmats(state, sc, frame, model["num_virtual_views"])
    means, quats, scales, opac, sh = ref.activate(state["gaussians"])
    rgb = ref.colors(means, sh, geo.se3_inverse(viewmats), sh_degree)
    r = ref.raster_from(model["rasterize"])
    binned = ref.bin_views(means, quats, scales, opac, rgb, viewmats, sc.cam, r)
    pairs, slots, rows = composite_work(binned, r)
    v, n = viewmats.shape[0], means.shape[0]
    pixels = v * sc.cam[4] * sc.cam[5]
    params = sum(t.numel() for t in _leaves(state))
    return Work(pairs, slots, rows, pixels, v * n, params, pixels, sc.cam[4] * sc.cam[5], 1)


def _leaves(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif k != "alive":
            yield v


def train_work(state, sc: ref.Scene, frames, model: dict, sh_degree: int) -> Work:
    """The work of training steps on `frames` from `state` (host tensors)."""
    dev = sc.base_knots.device
    state = _to(state, dev)
    cache: Dict[int, Work] = {}
    total = ZERO
    for f in frames:
        if f not in cache:
            cache[f] = _frame(state, sc, f, model, sh_degree)
        total = total + cache[f]
    return total


def serve_work(state, sc: ref.Scene, requests, model: dict, traffic: dict) -> Work:
    """The work of viewer requests (angle, log exposure, mode) on `state`."""
    dev = sc.base_knots.device
    state = _to(state, dev)
    means, quats, scales, opac, sh = ref.activate(state["gaussians"])
    r = ref.raster_from(model["rasterize"])
    total = ZERO
    with torch.no_grad():
        for angle, _, mode in requests:
            vm = geo.orbit_viewmat(angle, traffic["orbit_radius"], traffic["orbit_height"], dev)
            rgb = ref.colors(means, sh, geo.se3_inverse(vm[None]), model["sh_degree"])
            binned = ref.bin_views(means, quats, scales, opac, rgb, vm[None], sc.cam, r)
            pairs, slots, rows = composite_work(binned, r)
            pixels = sc.cam[4] * sc.cam[5]
            total = total + Work(pairs, slots, rows, pixels, means.shape[0], 0,
                                 pixels if mode != "hdr" else 0, 0, 1)
    return total


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}
