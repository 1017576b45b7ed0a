"""The layout of the training state on a (data, gauss) mesh.  Counterpart
of casualhdrsplat_tpu/parallel/sharding.py.

The Gaussian store lies in contiguous blocks of capacity / gauss along the
`gauss` axis (rank (d, g) holds block g) and is replicated over `data`.
Pose knots, exposures and the CRF are small and replicated on every rank.
The Adam moments and the density-control statistics live with their
block: every leaf whose leading dimension is the capacity is cut the same
way.  `shard_*` cut a full state held by every rank; `gather_*` rebuild
the full state on every rank (checkpoints, evaluation renders).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from casualhdrsplat_torch.parallel import collectives
from casualhdrsplat_torch.parallel.mesh import GAUSS_AXIS, Mesh


def block(capacity: int, mesh: Mesh) -> slice:
    """This rank's slots of a store of `capacity`."""
    n_shards = mesh.size(GAUSS_AXIS)
    if capacity % n_shards:
        raise ValueError(f"capacity {capacity} does not split into {n_shards} blocks")
    b = capacity // n_shards
    g = mesh.axis_index(GAUSS_AXIS)
    return slice(g * b, (g + 1) * b)


def _map_capacity(tree, capacity: int, fn):
    """`tree` with fn applied to every tensor whose leading dimension is
    `capacity` (dicts rebuilt, other leaves kept)."""
    if isinstance(tree, dict):
        return {k: _map_capacity(v, capacity, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_capacity(v, capacity, fn) for v in tree))
    if isinstance(tree, torch.Tensor) and tree.dim() >= 1 and tree.shape[0] == capacity:
        return fn(tree)
    return tree


def shard_tree(tree, capacity: int, mesh: Mesh):
    """Every capacity-indexed leaf of `tree` cut to this rank's block (a
    copy); the rest kept as is."""
    sl = block(capacity, mesh)
    return _map_capacity(tree, capacity, lambda t: t[sl].clone())


def gather_leaf(t: torch.Tensor, mesh: Mesh, name: str = "gather_state") -> torch.Tensor:
    """The full leaf from every `gauss` rank's block (no gradient)."""
    wire = t.to(torch.uint8) if t.dtype == torch.bool else t
    full = torch.cat(collectives.all_gather(wire.detach(), mesh, GAUSS_AXIS, name))
    return full.bool() if t.dtype == torch.bool else full


def gather_tree(tree, block_size: int, mesh: Mesh):
    """Every block-indexed leaf of `tree` gathered over `gauss`."""
    return _map_capacity(tree, block_size, lambda t: gather_leaf(t, mesh))


def shard_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The full parameter dict (or a moment tree of the same layout) ->
    this rank's: the store cut to its block, the rest shared."""
    cap = params["gaussians"]["means"].shape[0]
    return dict(params, gaussians=shard_tree(params["gaussians"], cap, mesh))


def gather_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """Inverse of `shard_params`, on every rank."""
    b = params["gaussians"]["means"].shape[0]
    return dict(params, gaussians=gather_tree(params["gaussians"], b, mesh))


def shard_opt_state(state: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The optimizer state (train/optim.py): the store's moments cut to this
    rank's block."""
    return dict(state, mu=shard_params(state["mu"], mesh), nu=shard_params(state["nu"], mesh))


def gather_opt_state(state: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """Inverse of `shard_opt_state`, on every rank."""
    return dict(state, mu=gather_params(state["mu"], mesh), nu=gather_params(state["nu"], mesh))


def broadcast_tree(tree, mesh: Mesh) -> None:
    """Overwrite every tensor of `tree` with global rank 0's, in place."""
    if isinstance(tree, dict):
        for v in tree.values():
            broadcast_tree(v, mesh)
    elif isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bool:
            wire = tree.to(torch.uint8)
            tree.copy_(collectives.broadcast(wire, mesh, "broadcast_state").bool())
        else:
            collectives.broadcast(tree, mesh, "broadcast_state")
