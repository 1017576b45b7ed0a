"""The chunk math of front-to-back alpha compositing.  Counterpart of the
shared math in casualhdrsplat_tpu/ops/composite.py.

Per tile, Gaussians come in depth-ordered chunks of G.  Within a chunk the
transmittance is a prefix sum in log space, T_k = T_in * exp(cumsum_excl
log(1 - alpha)), so a chunk is dense [G, P] elementwise work plus a
contraction.  This is the plain math the streaming compositor's reference
versions (ops/rasterize_packed.py, forward and backward) are built from;
every function takes leading batch dimensions (rows), which the reference
vmaps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from casualhdrsplat_torch.ops import binning


class CompositeStatics(NamedTuple):
    """Static compositor settings.  The reference's `backend` and `prefix`
    fields select between its XLA and Pallas variants; the port has one
    compositor and drops them."""

    num_views: int
    ntx: int
    nty: int
    tile_h: int
    tile_w: int
    chunk: int
    alpha_clip: float
    alpha_threshold: float
    # A tile's remaining windows are skipped once every pixel's
    # transmittance is below this.
    transmittance_eps: float = 1e-4


def tile_origin(tile_index: torch.Tensor, statics: CompositeStatics):
    """Pixel origin (ox, oy) of output row `tile_index` (views stack along
    the rows, ntx * nty rows each)."""
    t = tile_index % (statics.ntx * statics.nty)
    return (t % statics.ntx) * statics.tile_w, (t // statics.ntx) * statics.tile_h


def pixel_coords(origin_x, origin_y, tile_h: int, tile_w: int):
    """Pixel-centre coordinates of tiles: origins [...] -> (px, py), each
    [..., 1, P] float32, P = tile_h * tile_w in row-major order."""
    origin_x = torch.as_tensor(origin_x)
    origin_y = torch.as_tensor(origin_y)
    idx = torch.arange(tile_h * tile_w, dtype=torch.int32, device=origin_x.device)
    px = (idx % tile_w + origin_x[..., None, None]).to(torch.float32) + 0.5
    py = (idx // tile_w + origin_y[..., None, None]).to(torch.float32) + 0.5
    return px, py


def _alpha_terms(chunk, px, py, alpha_clip, alpha_threshold):
    """Chunk params [..., G, 16] x pixels [..., 1, P] -> alpha [..., G, P]
    plus the intermediates the backward needs."""

    def col(c):
        return chunk[..., c : c + 1]

    mx, my = col(binning.COL_MX), col(binning.COL_MY)
    cxx, cxy, cyy = col(binning.COL_CXX), col(binning.COL_CXY), col(binning.COL_CYY)
    opa = col(binning.COL_OPA)
    dx = px - mx
    dy = py - my
    power = -(0.5 * (cxx * dx * dx + cyy * dy * dy) + cxy * dx * dy)
    expf = torch.exp(torch.clamp(power, max=0.0))  # power <= 0 for PSD conics
    alpha_raw = opa * expf
    alpha = torch.clamp(alpha_raw, max=alpha_clip)
    alpha = torch.where(alpha >= alpha_threshold, alpha, 0.0)
    return alpha, alpha_raw, expf, dx, dy, (cxx, cxy, cyy)


def _chunk_fwd(chunk, px, py, t_in, alpha_clip, alpha_threshold):
    """One chunk of G depth-ordered Gaussians composited over P pixels.

    chunk [..., G, 16]; px/py [..., 1, P]; t_in [..., 1, P] incoming
    transmittance.  Returns (contrib [..., 4, P], t_out [..., 1, P]).
    """
    alpha, *_ = _alpha_terms(chunk, px, py, alpha_clip, alpha_threshold)
    log1m = torch.log1p(-alpha)
    s_incl = torch.cumsum(log1m, dim=-2)
    s_excl = s_incl - log1m
    w = alpha * torch.exp(s_excl) * t_in  # [..., G, P]
    c4 = chunk[..., binning.COL_R : binning.COL_ONE + 1]  # [..., G, 4]
    contrib = torch.matmul(c4.transpose(-1, -2), w)  # [..., 4, P]
    t_out = t_in * torch.exp(s_incl[..., -1:, :])
    return contrib, t_out


def _chunk_bwd(chunk, px, py, t_in, r_in, tot_dot, g4, alpha_clip, alpha_threshold):
    """Backward for one chunk, front to back.

    The suffix term of dL/dalpha_k is
        term2[k] = sum_c (c4_tot_c - prefix4_incl[k]_c) * g4_c .
    g4 does not depend on the slot k, so the channel dot commutes with the
    prefix over k:
        term2[k] = tot_dot - r_in - cumsum_incl_k(w * (c4 . g4)),
    and the carried per-channel prefix collapses to the scalar per-pixel
    carry r = sum_c prefix4_c * g4_c.

    chunk [..., G, 16]; px/py, t_in (recomputed transmittance carry), r_in
    and tot_dot (sum_c out4_c * g4_c) [..., 1, P]; g4 [..., 4, P] upstream
    gradient.  Returns (d_chunk [..., G, 16], t_out, r_out [..., 1, P]).
    """
    alpha, alpha_raw, expf, dx, dy, (cxx, cxy, cyy) = _alpha_terms(
        chunk, px, py, alpha_clip, alpha_threshold
    )
    log1m = torch.log1p(-alpha)
    s_incl = torch.cumsum(log1m, dim=-2)
    s_excl = s_incl - log1m
    t_k = torch.exp(s_excl) * t_in  # [..., G, P]
    w = alpha * t_k
    c4 = chunk[..., binning.COL_R : binning.COL_ONE + 1]  # [..., G, 4]

    # d colour (and the discarded constant-1 channel)
    d_c4 = torch.matmul(w, g4.transpose(-1, -2))  # [..., G, 4]
    cg = torch.matmul(c4, g4)  # [..., G, P]: c4_k . g4 per pixel
    u = w * cg
    term1 = t_k * cg
    term2 = tot_dot - r_in - torch.cumsum(u, dim=-2)
    dl_da = torch.where(alpha > 0.0, term1 - term2 / (1.0 - alpha), 0.0)

    # chain through alpha = min(opa * expf, clip): zero where clamped
    live = (alpha > 0.0) & (alpha_raw < alpha_clip)
    g_a = torch.where(live, dl_da, 0.0)
    g_pw = g_a * alpha  # d/d power

    d_chunk = torch.zeros_like(chunk)
    d_chunk[..., binning.COL_MX] = (g_pw * (cxx * dx + cxy * dy)).sum(-1)
    d_chunk[..., binning.COL_MY] = (g_pw * (cyy * dy + cxy * dx)).sum(-1)
    d_chunk[..., binning.COL_CXX] = (g_pw * (-0.5 * dx * dx)).sum(-1)
    d_chunk[..., binning.COL_CXY] = (g_pw * (-dx * dy)).sum(-1)
    d_chunk[..., binning.COL_CYY] = (g_pw * (-0.5 * dy * dy)).sum(-1)
    d_chunk[..., binning.COL_OPA] = (g_a * expf).sum(-1)
    d_chunk[..., binning.COL_R : binning.COL_B + 1] = d_c4[..., :3]

    t_out = t_in * torch.exp(s_incl[..., -1:, :])
    r_out = r_in + u.sum(-2, keepdim=True)
    return d_chunk, t_out, r_out
