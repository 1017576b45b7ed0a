"""The collectives of the sharded path and their gradient rules.

shard_map derives the transposes of the reference's collectives
(casualhdrsplat_tpu/parallel/render.py); here each rule is written by hand
as a torch.autograd.Function.  A wrong rule multiplies or drops a gradient
by the size of a mesh axis, so each one states its own:

- `gather_blocks` (the payload rows along `gauss`): forward all-gathers
  the blocks in group order (shard g's rows at [g B, (g + 1) B), the
  one-device order); backward sums the cotangents over the group and keeps
  the rank's own block: the reference's psum-scatter, written as an
  all-reduce and a slice.
- `assemble` (every rank's tile composites to full images): forward
  all-gathers over the world; every rank then computes the same loss from
  the same images, so backward keeps the rank's own slice and sums
  nothing.
- `sum_grad` (an input replicated into the body, each rank adding a
  partial: the view matrices over the world, the Gaussian shard and the
  screen-gradient probe over `data`): identity forward, backward an
  all-reduce over the axis.
- Whatever is computed identically on every rank after `assemble` (the
  CRF, the exposure product, the blur mean, the loss) needs no rule.

Only all_gather, all_reduce and broadcast are used: gloo has no
reduce_scatter (torch.distributed.nn's all_gather calls it in its
backward).  gloo carries CUDA tensors for all three (it stages through the
host itself), which is how ranks that share one card run.

Every call adds [calls, bytes, host seconds] to `mesh.stats[name]`: the
bytes that land on this rank (the gathered output, or the reduced tensor),
and the host time of the call (NCCL returns once the work is queued; gloo
once it is done).  A call made while a CUDA graph captures (the mesh step
over NCCL, utils/cuda_graphs.py) runs nothing then: its calls and bytes
are added on every replay of the graph instead, and the entry's host
seconds become None, not measured, since a replay runs no Python around
the collective.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from casualhdrsplat_torch.parallel.mesh import WORLD_AXIS, Mesh
from casualhdrsplat_torch.utils import cuda_graphs


def _add(mesh: Mesh, name: str, nbytes: int, seconds) -> None:
    entry = mesh.stats.setdefault(name, [0, 0, 0.0])
    entry[0] += 1
    entry[1] += nbytes
    entry[2] = None if seconds is None or entry[2] is None else entry[2] + seconds


def _record(mesh: Mesh, name: str, nbytes: int, seconds: float) -> None:
    # under capture: counted on each replay, host seconds not measured
    if not cuda_graphs.on_replay(lambda: _add(mesh, name, nbytes, None)):
        _add(mesh, name, nbytes, seconds)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, name: str) -> list:
    """The tensors `x` of every rank of `axis`, in group order (no
    gradient)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    t0 = time.perf_counter()
    dist.all_gather(parts, x, group=mesh.group(axis))
    _record(mesh, name, x.numel() * x.element_size() * len(parts), time.perf_counter() - t0)
    return parts


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str, name: str) -> torch.Tensor:
    """Sum `x` over `axis`, in place; returns it (no gradient)."""
    t0 = time.perf_counter()
    dist.all_reduce(x, group=mesh.group(axis))
    _record(mesh, name, x.numel() * x.element_size(), time.perf_counter() - t0)
    return x


def broadcast(x: torch.Tensor, mesh: Mesh, name: str) -> torch.Tensor:
    """Global rank 0's `x` on every rank, in place; returns it."""
    t0 = time.perf_counter()
    dist.broadcast(x, 0)
    _record(mesh, name, x.numel() * x.element_size(), time.perf_counter() - t0)
    return x


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, name):
        ctx.mesh, ctx.axis, ctx.dim, ctx.name = mesh, axis, dim, name
        ctx.block = x.shape[dim]
        return torch.cat(all_gather(x, mesh, axis, name), dim=dim)

    @staticmethod
    def backward(ctx, g):
        # every rank of the group read this rank's block: sum their
        # cotangents, keep the own block (the psum-scatter)
        g = all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.mesh, ctx.axis,
                       ctx.name + ".grad")
        start = ctx.mesh.axis_index(ctx.axis) * ctx.block
        return g.narrow(ctx.dim, start, ctx.block), None, None, None, None


class _Assemble(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, name):
        ctx.rank = mesh.axis_index(WORLD_AXIS)
        return torch.stack(all_gather(x, mesh, WORLD_AXIS, name))

    @staticmethod
    def backward(ctx, g):
        # every rank computes the same loss from the same full images: the
        # own slice of the cotangent is the whole gradient; a sum would
        # multiply it by the world size
        return g[ctx.rank], None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, name):
        ctx.mesh, ctx.axis, ctx.name = mesh, axis, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # each rank of the axis added its partial of the gradient
        g = all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.mesh, ctx.axis,
                       ctx.name)
        return g, None, None, None


def gather_blocks(x: torch.Tensor, mesh: Mesh, axis: str, dim: int, name: str) -> torch.Tensor:
    """The blocks `x` of every rank of `axis`, concatenated along `dim` in
    group order; backward: the sum over the group of the cotangents of
    this rank's block."""
    return _GatherBlocks.apply(x, mesh, axis, dim, name)


def assemble(x: torch.Tensor, mesh: Mesh, name: str) -> torch.Tensor:
    """[world, ...]: every rank's `x` stacked in rank order; backward: the
    cotangent of this rank's slice only."""
    return _Assemble.apply(x, mesh, name)


def sum_grad(x: torch.Tensor, mesh: Mesh, axis: str, name: str) -> torch.Tensor:
    """`x` itself; backward: its cotangent summed over `axis`."""
    return _SumGrad.apply(x, mesh, axis, name)
