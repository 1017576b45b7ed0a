"""Adaptive density control on the fixed-capacity store.  Counterpart of
casualhdrsplat_tpu/train/densify.py (its single-device half).

The store never changes shape: a round is masked writes on the
[capacity]-shaped parameter dict.
- prune: clear `alive` (low opacity, oversized screen radius);
- clone (small, high screen gradient) and split (large, high gradient):
  each requester is granted one free slot, requesters and free slots both
  taken in index order, so a round is deterministic;
- the optimizer moments at every touched slot are zeroed
  (optim.zero_state_at).

Screen-space gradient statistics are accumulated from the rasterizer's
`means2d_offset` gradient tap between rounds.

On a (data, gauss) mesh (parallel/) every rank holds one block of the store
and runs the same round on it (`densify_and_prune_sharded`): shard-local
free lists, so the slot surgery needs no collective but the report's sum.
`rebalance_store` evens the alive counts of the blocks when they drift
apart.

A trainer (train/trainer.py) draws a round's split noise through
`SplitNoise` into a static device buffer, on the host by the same
generator and in the same order as `densify_and_prune` draws it; on the
card the round's CUDA graph reads the buffer.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from casualhdrsplat_torch.config import DensifyConfig
from casualhdrsplat_torch.geometry.lie import quat_to_rotmat
from casualhdrsplat_torch.models.gaussians import inverse_sigmoid
from casualhdrsplat_torch.parallel import collectives, sharding
from casualhdrsplat_torch.parallel.mesh import GAUSS_AXIS
from casualhdrsplat_torch.train import optim as optim_mod


class AdcState(NamedTuple):
    grad_accum: torch.Tensor  # [N] sum of ||d loss / d means2d|| per round
    count: torch.Tensor  # [N] int32 visibility count
    max_radii: torch.Tensor  # [N] max screen radius (pixels) this round

    @staticmethod
    def zero(n: int, device="cuda") -> "AdcState":
        return AdcState(
            grad_accum=torch.zeros((n,), dtype=torch.float32, device=device),
            count=torch.zeros((n,), dtype=torch.int32, device=device),
            max_radii=torch.zeros((n,), dtype=torch.float32, device=device),
        )


def grad_scale(image_size: Tuple[int, int], device="cuda") -> torch.Tensor:
    """[w/2, h/2]: the factor `accumulate` takes the pixel-space gradient to
    the NDC-half-extent convention with.  A training loop makes it once:
    made from Python numbers, it is a copy from the host."""
    w, h = image_size
    return torch.tensor([0.5 * w, 0.5 * h], dtype=torch.float32, device=device)


def accumulate(
    state: AdcState,
    means2d_grad: torch.Tensor,
    radii: torch.Tensor,
    image_size: Optional[Tuple[int, int]] = None,
    scale: Optional[torch.Tensor] = None,
) -> AdcState:
    """Update the per-Gaussian statistics after one training step.

    means2d_grad: [N,2] pixel-space d loss / d means2d; radii: [V,N] (0
    where culled); image_size: (width, height) scales the pixel-space
    gradient by [w/2, h/2] to the NDC-half-extent convention the lineage's
    `grad_threshold` constant assumes; `scale`, `grad_scale(image_size)`
    made once, does the same without a copy from the host.
    """
    r = radii.amax(0)
    visible = r > 0
    if scale is None and image_size is not None:
        scale = grad_scale(image_size, means2d_grad.device)
    if scale is not None:
        means2d_grad = means2d_grad * scale.to(means2d_grad.dtype)
    g = torch.linalg.norm(means2d_grad, dim=-1)
    return AdcState(
        grad_accum=state.grad_accum + torch.where(visible, g, 0.0),
        count=state.count + visible.to(torch.int32),
        max_radii=torch.maximum(state.max_radii, r),
    )


class AdcReport(NamedTuple):
    num_cloned: torch.Tensor
    num_split: torch.Tensor
    num_pruned: torch.Tensor
    num_alive: torch.Tensor


class SplitNoise:
    """The split noise of a round, [2, n, 3] standard normals, in a static
    buffer: `draw` fills it from `generator` with the numbers
    `densify_and_prune` would draw (`torch.randn` on the host).  On the
    CPU it draws straight into the buffer.  On the card it draws into a
    pinned host buffer, then copies it over without waiting for the copy;
    before the next draw overwrites the host buffer, the host waits for
    that copy to finish."""

    def __init__(self, n: int, device):
        device = torch.device(device)
        self.buffer = torch.empty((2, n, 3), dtype=torch.float32, device=device)
        self._host = self._copied = None
        if device.type == "cuda":
            self._host = torch.empty((2, n, 3), dtype=torch.float32, pin_memory=True)
            self._copied = torch.cuda.Event()

    def draw(self, generator: torch.Generator) -> torch.Tensor:
        """The next [2, n, 3] draw of `generator`, in `self.buffer`."""
        if self._host is None:
            return torch.randn(self.buffer.shape, generator=generator, dtype=torch.float32,
                               out=self.buffer)
        self._copied.synchronize()  # the last copy out of the host buffer is done
        torch.randn(self._host.shape, generator=generator, dtype=torch.float32, out=self._host)
        self.buffer.copy_(self._host, non_blocking=True)
        self._copied.record()
        return self.buffer


@torch.no_grad()
def densify_and_prune(
    gauss: Dict[str, torch.Tensor],
    opt_state,
    adc: AdcState,
    generator: torch.Generator,
    cfg: DensifyConfig,
    scene_extent: float,
    image_diag: float,
    screen_prune: bool = False,
    prune_only: bool = False,
):
    """One density-control round: (new store, opt_state, zeroed statistics,
    AdcReport).  The split noise, two standard normal draws [2, N, 3], comes
    from `generator` (on the host, then copied: the same numbers on any
    device); the reference draws its own from a jax.random key.  The
    moments of `opt_state` are zeroed in place."""
    n = gauss["alive"].shape[0]
    eps = torch.randn((2, n, 3), generator=generator, dtype=torch.float32,
                      device=generator.device).to(gauss["means"].device)
    return densify_and_prune_with_noise(
        gauss, opt_state, adc, eps[0], eps[1], cfg, scene_extent, image_diag,
        screen_prune=screen_prune, prune_only=prune_only,
    )


@torch.no_grad()
def densify_and_prune_with_noise(
    gauss: Dict[str, torch.Tensor],
    opt_state,
    adc: AdcState,
    eps1: torch.Tensor,  # [N, 3] standard normal: the split parents' new means
    eps2: torch.Tensor,  # [N, 3] the split children's means
    cfg: DensifyConfig,
    scene_extent: float,
    image_diag: float,
    screen_prune: bool = False,
    prune_only: bool = False,
):
    """The arithmetic of a round for a given draw of the split noise."""
    n = gauss["alive"].shape[0]
    dev = gauss["alive"].device
    alive = gauss["alive"]
    opac = torch.sigmoid(gauss["opacity_logit"])

    prune = alive & (opac < cfg.prune_opacity)
    if screen_prune:
        # the lineage enables the screen-size prune only after the first
        # opacity reset, once opacities are informative
        prune = prune | (alive & (adc.max_radii > cfg.prune_screen_radius * image_diag))
    alive = alive & ~prune

    avg_grad = torch.where(adc.count > 0,
                           adc.grad_accum / torch.clamp(adc.count, min=1), 0.0)
    # prune_only: a round outside the densify window must not bring
    # clone/split growth back in after the schedule ended it
    high = alive & (avg_grad > cfg.grad_threshold)
    if prune_only:
        high = torch.zeros_like(high)
    scale_max = torch.exp(gauss["log_scales"]).amax(-1)
    split = high & (scale_max > cfg.split_scale_threshold_rel * scene_extent)
    clone = high & ~split

    # one new slot per requester, granted in index order from the free slots
    need = split | clone
    free = ~alive
    num_free = free.sum()
    rank = torch.cumsum(need, 0) - 1  # [N] rank among requesters
    # free slot indices first, in index order: a stable sort, as jnp.argsort
    free_slots = torch.argsort(alive.to(torch.uint8), stable=True)
    granted = need & (rank < num_free)
    dest = free_slots[torch.clamp(rank, 0, n - 1)]  # valid where granted
    # row n of an (n + 1)-row buffer takes the writes of the ungranted, which
    # the reference drops (mode="drop")
    scatter_idx = torch.where(granted, dest, n)

    # child samples for splits: x = mu + R(q) (s * eps), scales / factor
    rot = quat_to_rotmat(gauss["quats"])
    scales = torch.exp(gauss["log_scales"])

    def sample(eps):
        return gauss["means"] + (rot * (scales * eps)[:, None, :]).sum(-1)

    new_log_scales = gauss["log_scales"] - math.log(cfg.split_factor)

    # values written to the new slot: split -> second sample, clone -> copy
    child_means = torch.where(split[:, None], sample(eps2), gauss["means"])
    child_log_scales = torch.where(split[:, None], new_log_scales, gauss["log_scales"])

    def scatter(leaf, child_vals):
        buf = torch.cat([leaf, leaf[:1]])
        buf[scatter_idx] = child_vals
        return buf[:n]

    out = dict(gauss)
    out["means"] = scatter(gauss["means"], child_means)
    out["log_scales"] = scatter(gauss["log_scales"], child_log_scales)
    for k in ("quats", "opacity_logit", "sh_dc", "sh_rest"):
        out[k] = scatter(gauss[k], gauss[k])

    # parent slot updates for splits: first sample + shrunk scale
    out["means"] = torch.where(split[:, None], sample(eps1), out["means"])
    out["log_scales"] = torch.where(split[:, None], new_log_scales, out["log_scales"])

    new_slot = scatter(torch.zeros(n, dtype=torch.bool, device=dev),
                       torch.ones(n, dtype=torch.bool, device=dev))
    new_alive = alive | new_slot
    out["alive"] = new_alive

    # zero the optimizer moments at every touched slot
    opt_state = optim_mod.zero_state_at(opt_state, new_slot | split | prune)

    report = AdcReport(
        num_cloned=(clone & granted).sum(),
        num_split=(split & granted).sum(),
        num_pruned=prune.sum(),
        num_alive=new_alive.sum(),
    )
    return out, opt_state, AdcState.zero(n, dev), report


@torch.no_grad()
def densify_and_prune_sharded(
    gauss: Dict[str, torch.Tensor],
    opt_state,
    adc: AdcState,
    generator: torch.Generator,
    cfg: DensifyConfig,
    scene_extent: float,
    image_diag: float,
    mesh,
    screen_prune: bool = False,
    prune_only: bool = False,
):
    """One round on this rank's block of a `gauss`-sharded store.

    The same round as `densify_and_prune`, on the block alone: per-block
    free lists, so slot grants, scatters and the moments' zeroing stay in
    the block.  A block that runs out of free slots defers its lowest-rank
    requesters to later rounds, as the one-device round does globally.  The
    split noise [2, block, 3] comes from `generator`, which the caller seeds
    per block (the reference's fold_in(key, g)), the same on every `data`
    replica of the block, or the replicas part.  The report is summed over
    `gauss` (the same on every rank)."""
    n = gauss["alive"].shape[0]
    eps = torch.randn((2, n, 3), generator=generator, dtype=torch.float32,
                      device=generator.device).to(gauss["means"].device)
    return densify_and_prune_sharded_with_noise(
        gauss, opt_state, adc, eps[0], eps[1], cfg, scene_extent, image_diag, mesh,
        screen_prune=screen_prune, prune_only=prune_only,
    )


@torch.no_grad()
def densify_and_prune_sharded_with_noise(gauss, opt_state, adc: AdcState, eps1, eps2,
                                         cfg: DensifyConfig, scene_extent: float,
                                         image_diag: float, mesh, screen_prune: bool = False,
                                         prune_only: bool = False):
    """`densify_and_prune_sharded` for a given draw of the block's split
    noise."""
    out, opt_state, adc, report = densify_and_prune_with_noise(
        gauss, opt_state, adc, eps1, eps2, cfg, scene_extent, image_diag,
        screen_prune=screen_prune, prune_only=prune_only,
    )
    summed = collectives.all_reduce(torch.stack(list(report)).to(torch.int64), mesh,
                                    GAUSS_AXIS, "densify_report")
    return out, opt_state, adc, AdcReport(*summed.unbind())


def shard_alive_counts(alive: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Alive Gaussians of each contiguous block of a full store, [n_shards]."""
    return alive.reshape(n_shards, -1).sum(1)


def rebalance_order(alive: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The permutation that evens the blocks of a full store: src [capacity],
    slot j takes slot src[j].  Alive slots get global ranks in index order
    (a stable sort) and rank k moves to block k % n_shards, so the blocks'
    alive counts differ by at most one afterwards."""
    cap = alive.shape[0]
    if cap % n_shards:
        raise ValueError(f"capacity {cap} not divisible by {n_shards} shards")
    block = cap // n_shards
    idx = torch.arange(cap, device=alive.device)
    # alive first, each group in index order: order[k] = slot of rank k
    order = torch.argsort(torch.where(alive, idx, idx + cap), stable=True)
    # rank k lands at (k % S) block + k // S, a bijection whose inverse is
    # k(j) = (j % block) S + j // block: a gather, no scatter
    return order[(idx % block) * n_shards + idx // block]


@torch.no_grad()
def rebalance_store(gauss: Dict[str, torch.Tensor], opt_state, adc: AdcState, n_shards: int,
                    mesh=None):
    """Spread the alive Gaussians evenly over the store's `n_shards` blocks.

    One permutation (`rebalance_order`) of every capacity-indexed leaf: the
    parameters, the Adam moments and the statistics travel with their
    Gaussian.  Without a mesh the leaves are the full store.  On a mesh they
    are this rank's block: each leaf is all-gathered over `gauss`, permuted,
    and the rank keeps its block.  It runs rarely (on the imbalance
    threshold), so it needs no all-to-all.  Returns (gauss, opt_state, adc);
    the moments are rebuilt, not written in place."""
    if mesh is None:
        src = rebalance_order(gauss["alive"], n_shards)

        def take(t):
            return t[src]
    else:
        src = rebalance_order(sharding.gather_leaf(gauss["alive"], mesh, "rebalance"), n_shards)
        mine = sharding.block(src.shape[0], mesh)

        def take(t):
            return sharding.gather_leaf(t, mesh, "rebalance")[src[mine]]

    def moments(tree):
        return dict(tree, gaussians={k: take(v) for k, v in tree["gaussians"].items()})

    out = {k: take(v) for k, v in gauss.items()}
    opt_out = dict(opt_state, mu=moments(opt_state["mu"]), nu=moments(opt_state["nu"]))
    return out, opt_out, AdcState(*(take(x) for x in adc))


def screen_prune_active(step: int, cfg: DensifyConfig) -> bool:
    """Whether the max-screen-radius prune applies at `step`: from
    cfg.screen_prune_from when set, else only after the first opacity
    reset, once opacities are informative."""
    if cfg.screen_prune_from > 0:
        return step >= cfg.screen_prune_from
    return step > cfg.opacity_reset_interval


@torch.no_grad()
def reset_opacity(gauss: Dict[str, torch.Tensor], value: float = 0.01):
    """Clamp opacities down (every 3k steps in the lineage) so pruning can
    retire Gaussians that stopped contributing."""
    out = dict(gauss)
    out["opacity_logit"] = torch.clamp(gauss["opacity_logit"], max=inverse_sigmoid(value))
    return out
