"""Data parallelism over `torch.distributed` (counterpart of
`vitadapter/parallel/`): one process per rank, launched by torchrun."""

from vitadapter_torch.parallel.collectives import (  # noqa: F401
    all_reduce_dict, all_reduce_sum, allreduce_grads, barrier,
    broadcast_object, global_normalizer, process_allgather, reduce_mean)
from vitadapter_torch.parallel.mesh import (  # noqa: F401
    distributed, init_distributed, rank_device, rank_generator, rank_rows,
    replicate, shard_batch, world)
