"""The port's data-parallel world (counterpart of
`vitadapter/parallel/mesh.py`).

The JAX package runs one program over a 1-D `data` mesh of every chip: the
batch is sharded over it, the state replicated, and the compiler inserts
the collectives. The port runs one process per rank, launched by
`torchrun` (`python -m torch.distributed.run`): each rank holds a replica
of the model on its own card (`cuda:LOCAL_RANK`), runs its share of the
global batch and takes part in explicit collectives
(`parallel/collectives.py`). Without a process group, or with one rank,
every path runs as on one card.

A `Mesh` lays the ranks out on named axes, as JAX's `Mesh` lays out
devices: rank r sits at the row-major coordinates of r, and each axis has
one process group per line of ranks along it. `parallel/tp.py` trains on
a (data, model) grid and makes it the process's grid (`use_grid`): the
batch, the loss normalizers, SyncBN, the averaged logs and the gradient
average then run over the data group, and ranks of one model group draw
alike. Without a grid the data group is the world.
"""

import contextlib
import datetime
import math
import os
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vitadapter_torch.parallel.collectives import broadcast_tensors

# the variables torchrun sets for each rank
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# how long a collective may wait for a rank: gloo's default, and three
# times NCCL's, so that the other ranks outwait a cold build of every
# kernel (about 15 s on an H100) at the barrier
GROUP_TIMEOUT = datetime.timedelta(minutes=30)


def world() -> Tuple[int, int, int]:
    """(rank, world size, local rank): (0, 1, 0) without a process group.
    The local rank, the card's index on this host, is torchrun's
    `LOCAL_RANK` (the rank where it is not set)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1, 0
    rank = dist.get_rank()
    return (rank, dist.get_world_size(),
            int(os.environ.get("LOCAL_RANK", rank)))


def rank_device() -> torch.device:
    """This rank's card: `cuda:LOCAL_RANK`."""
    return torch.device("cuda", world()[2])


def init_distributed(device_type: str = "cuda") -> Tuple[int, int, int]:
    """Join the process group torchrun's environment describes (NCCL for
    CUDA, gloo for the CPU), after making this rank's card the current
    one, with `GROUP_TIMEOUT`. A group the caller has already initialized
    is kept as it is. On CUDA with more than one rank, local rank 0 of
    each host builds every kernel while the others wait, so that the ranks
    do not run nvcc once each. Returns `world()`."""
    if not dist.is_initialized():
        missing = [k for k in TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"--multi-host: {missing} not set; launch with python -m "
                "torch.distributed.run --nproc_per_node N ...")
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                timeout=GROUP_TIMEOUT)
    rank, size, local = world()
    if device_type == "cuda":
        torch.cuda.set_device(local)
        if size > 1:
            if local == 0:
                from vitadapter_torch.ops import cuda_ext
                cuda_ext.build()
            dist.barrier()
    return rank, size, local


@contextlib.contextmanager
def distributed(multi_host: bool, device_type: str = "cuda") -> Iterator:
    """`init_distributed` where `multi_host`, the group destroyed on exit
    if this call made it; yields `world()`."""
    made = multi_host and not dist.is_initialized()
    if multi_host:
        init_distributed(device_type)
    try:
        yield world()
    finally:
        if made:
            dist.destroy_process_group()


def device_type(device) -> str:
    """The process group's device type for a `--device` argument: `cuda`
    unless it names another device."""
    return "cuda" if device is None else torch.device(device).type


class Mesh:
    """The world's ranks on named axes of `shape` (their product is the
    world size; rank r = the row-major index of its coordinates, so the
    last axis holds consecutive ranks). Every rank must build the same
    meshes in the same order: each builds one process group for every
    line of ranks along every axis (`dist.new_group` is collective), on
    the world's backend."""

    def __init__(self, names: Sequence[str], shape: Sequence[int]):
        self.names, self.shape = tuple(names), tuple(int(n) for n in shape)
        rank, size, _ = world()
        if math.prod(self.shape) != size:
            raise ValueError(f"a {dict(zip(self.names, self.shape))} mesh "
                             f"over {size} ranks")
        grid = np.arange(size).reshape(self.shape)
        self.coords = tuple(int(c) for c in np.unravel_index(rank,
                                                             self.shape))
        self._ranks, self._groups = {}, {}
        for a, name in enumerate(self.names):
            lines = np.moveaxis(grid, a, -1).reshape(-1, self.shape[a])
            for line in lines:
                ranks = [int(r) for r in line]
                group = (dist.new_group(ranks) if dist.is_initialized()
                         else None)
                if rank in ranks:
                    self._ranks[name], self._groups[name] = ranks, group

    def size(self, axis: str) -> int:
        return self.shape[self.names.index(axis)]

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        return self.coords[self.names.index(axis)]

    def group(self, axis: str):
        """The process group of this rank's line along `axis`."""
        return self._groups[axis]

    def ranks(self, axis: str) -> Sequence[int]:
        """The global ranks of this rank's line along `axis`, in order."""
        return self._ranks[axis]


_GRID: Optional[Mesh] = None


def use_grid(mesh: Optional[Mesh]) -> None:
    """Make `mesh`, a mesh with a `data` and a `model` axis, the grid the
    process trains on (None: none, the world is the data group)."""
    global _GRID
    _GRID = mesh


def grid() -> Optional[Mesh]:
    return _GRID


def data_group():
    """The data group: this rank's line along the grid's `data` axis, or
    the world (None) without a grid."""
    return None if _GRID is None else _GRID.group("data")


def data_rank() -> Tuple[int, int]:
    """(this rank's index in the data group, the data group's size)."""
    if _GRID is None:
        rank, size, _ = world()
        return rank, size
    return _GRID.index("data"), _GRID.size("data")


def rank_rows(batch_size: int) -> range:
    """This rank's rows `[r*s, (r+1)*s)` of a global batch of `batch_size`
    rows, r its index in the data group (s = batch_size / the data
    group's size; the shards are equal, as JAX's sharding requires):
    ranks of one model group take the same rows."""
    rank, size = data_rank()
    if batch_size % size:
        raise ValueError(f"a global batch of {batch_size} does not split "
                         f"over {size} ranks")
    s = batch_size // size
    return range(rank * s, (rank + 1) * s)


def shard_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """This rank's rows of every entry of a global batch."""
    rows = rank_rows(len(next(iter(batch.values()))))
    return {k: v[rows.start:rows.stop] for k, v in batch.items()}


def replicate(model: torch.nn.Module) -> torch.nn.Module:
    """Give every rank the parameters and buffers of data rank 0 of its
    data group (in place): rank 0's without a grid; under a grid each
    model rank takes its own shard from its column's first rank."""
    group = data_group()
    if world()[1] > 1:
        src = 0 if _GRID is None else _GRID.ranks("data")[0]
        with torch.no_grad():
            broadcast_tensors([*model.parameters(), *model.buffers()], src,
                              group)
    return model


def rank_generator(device, seed: int) -> torch.Generator:
    """A generator on `device` seeded from (seed, data rank): `seed` itself
    on data rank 0, so one process draws as it always did, and independent
    streams on the other data ranks, as the images of JAX's global batch
    draw independent DropPath masks; the ranks of one model group, which
    hold the same images, draw the same (JAX's masks do not depend on how
    the model is split)."""
    return torch.Generator(device).manual_seed(seed + (data_rank()[0] << 32))
