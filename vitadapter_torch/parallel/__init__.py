"""Data, tensor, pipeline and sequence parallelism over
`torch.distributed` (counterpart of `vitadapter/parallel/`): one process
per rank, launched by torchrun."""

from vitadapter_torch.parallel.collectives import (  # noqa: F401
    all_reduce_dict, all_reduce_sum, allreduce_grads, barrier,
    broadcast_object, copy_to_group, global_normalizer, process_allgather,
    reduce_from_group, reduce_mean)
from vitadapter_torch.parallel.mesh import (  # noqa: F401
    Mesh, data_group, distributed, grid, init_distributed, rank_device,
    rank_generator, rank_rows, replicate, shard_batch, use_grid, world)
from vitadapter_torch.parallel.pp import (  # noqa: F401
    make_pp_mesh, pipeline_apply, split_stages)
from vitadapter_torch.parallel.sp import (  # noqa: F401
    msda_token_sharded, query_rows)
from vitadapter_torch.parallel.tp import (  # noqa: F401
    Split, gather_grads, gather_state_dict, make_tp_mesh, partition_specs,
    shard_batch_2d, shard_model)
