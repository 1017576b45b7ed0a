"""The (data, gauss) device mesh over the ranks of a torch.distributed
world.  Counterpart of casualhdrsplat_tpu/parallel/mesh.py.

Axes:
- `data`: the virtual views of a frame, rendered independently;
- `gauss`: the Gaussian store in contiguous blocks; after the all-gather of
  the projected payload rows the same axis splits the tiles.

Rank r sits at (d, g) = divmod(r, gauss).  Each row of the mesh (one d,
every g) is a `gauss` process group and each column (one g, every d) a
`data` group; the whole world is the third axis the collectives name.
Every rank creates every group, in the same order, as torch.distributed
requires, so meshes of several shapes may share one world (the tests run
(2, 2), (1, 4) and (4, 1) on four ranks).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch.distributed as dist

from casualhdrsplat_torch.config import ParallelConfig

DATA_AXIS = "data"
GAUSS_AXIS = "gauss"
# the whole world: the collectives' name for all ranks of the mesh
WORLD_AXIS = "world"


def mesh_shape(cfg: Optional[ParallelConfig], world: int) -> Tuple[int, int]:
    """(data, gauss) for `world` ranks: the config's when their product is
    the world, else the reference's fallback: keep `gauss` where it divides
    the world (else 1) and give the rest to `data`."""
    cfg = cfg or ParallelConfig()
    data, gauss = cfg.data, cfg.gauss
    if data * gauss != world:
        gauss = gauss if world % max(gauss, 1) == 0 else 1
        data = world // gauss
    return data, gauss


class Mesh:
    """A (data, gauss) mesh over the initialized default process group.

    `stats` accumulates, per collective name, [calls, bytes, host seconds]
    of the collectives run on this mesh (parallel/collectives.py; the
    seconds None once a replayed graph ran one: not measured); a caller
    may clear it."""

    def __init__(self, data: int, gauss: int):
        world = dist.get_world_size()
        if data * gauss != world:
            raise ValueError(f"mesh ({data}, {gauss}) does not cover a world of {world}")
        self.shape: Dict[str, int] = {DATA_AXIS: data, GAUSS_AXIS: gauss}
        self.rank = dist.get_rank()
        self.data_index, self.gauss_index = divmod(self.rank, gauss)
        self.stats: Dict[str, List] = {}
        groups = {}
        for d in range(data):  # the rows: one gauss group each
            ranks = [d * gauss + g for g in range(gauss)]
            groups[(GAUSS_AXIS, d)] = dist.new_group(ranks)
        for g in range(gauss):  # the columns: one data group each
            ranks = [d * gauss + g for d in range(data)]
            groups[(DATA_AXIS, g)] = dist.new_group(ranks)
        self._groups = {
            GAUSS_AXIS: groups[(GAUSS_AXIS, self.data_index)],
            DATA_AXIS: groups[(DATA_AXIS, self.gauss_index)],
            WORLD_AXIS: dist.group.WORLD,
        }

    def size(self, axis: str) -> int:
        return self.shape[DATA_AXIS] * self.shape[GAUSS_AXIS] if axis == WORLD_AXIS \
            else self.shape[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's position along `axis` (its group rank)."""
        return {DATA_AXIS: self.data_index, GAUSS_AXIS: self.gauss_index,
                WORLD_AXIS: self.rank}[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def backends(self) -> set:
        """The backends of the mesh's process groups ("nccl", "gloo")."""
        return {dist.get_backend(g) for g in self._groups.values()}


def make_mesh(cfg: Optional[ParallelConfig] = None) -> Mesh:
    """The mesh of `cfg` over the initialized world (`mesh_shape`'s
    fallback when the shape does not cover it)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "a (data, gauss) mesh needs a torch.distributed world: launch with "
            "torchrun and call parallel.distributed.initialize(), or use "
            "parallel.launch.spawn")
    return Mesh(*mesh_shape(cfg, dist.get_world_size()))
