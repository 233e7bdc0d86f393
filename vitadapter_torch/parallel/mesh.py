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
"""

import contextlib
import datetime
import os
from typing import Dict, Iterator, Tuple

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


def rank_rows(batch_size: int) -> range:
    """This rank's rows `[r*s, (r+1)*s)` of a global batch of `batch_size`
    rows (s = batch_size / world size; the shards are equal, as JAX's
    sharding requires)."""
    rank, size, _ = world()
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
    """Give every rank rank 0's parameters and buffers (in place)."""
    if world()[1] > 1:
        with torch.no_grad():
            broadcast_tensors([*model.parameters(), *model.buffers()])
    return model


def rank_generator(device, seed: int) -> torch.Generator:
    """A generator on `device` seeded from (seed, rank): `seed` itself on
    rank 0, so one process draws as it always did, and independent
    streams on the other ranks, as the images of JAX's global batch draw
    independent DropPath masks."""
    return torch.Generator(device).manual_seed(seed + (world()[0] << 32))
