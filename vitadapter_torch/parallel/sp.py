"""Sequence (token) parallelism for multi-scale deformable attention
(counterpart of `vitadapter/parallel/sp.py`).

Each query samples the value on its own, so the queries split over the
ranks of a mesh axis with the value whole on every rank: each rank runs
the MSDA core (`ops/msda.py::ms_deform_attn`: `msda_fwd.cu`/`msda_bwd.cu`
on the card, or the per-level kernels where `msda_route` sends a large
value) on its Lq / n queries, and its output stays split by query. In the
backward the value's gradient, which every rank's queries add to, is
summed over the ranks (`copy_to_group`: JAX's `shard_map` transpose of a
replicated input); the locations' and weights' stay with their queries.
"""

from typing import Sequence, Tuple

import torch

from vitadapter_torch.ops.msda import ms_deform_attn
from vitadapter_torch.parallel.collectives import copy_to_group
from vitadapter_torch.parallel.mesh import Mesh


def query_rows(Lq: int, mesh: Mesh, axis: str = "model") -> slice:
    """This rank's queries of `Lq` split over `axis`; raises ValueError
    unless they split evenly (JAX asserts it)."""
    n = mesh.size(axis)
    if Lq % n:
        raise ValueError(f"{Lq} queries do not split over {n} ranks")
    s = Lq // n
    i = mesh.index(axis)
    return slice(i * s, (i + 1) * s)


def msda_token_sharded(value: torch.Tensor,
                       spatial_shapes: Sequence[Tuple[int, int]],
                       sampling_locations: torch.Tensor,
                       attention_weights: torch.Tensor, mesh: Mesh,
                       axis: str = "model") -> torch.Tensor:
    """MSDA of this rank's queries: `value` (B, S, M, D) the same on every
    rank of `axis`, `sampling_locations` (B, Lq / n, M, L, P, 2) and
    `attention_weights` (B, Lq / n, M, L, P) this rank's rows of the
    queries (`query_rows`, which refuses an Lq the n ranks do not
    divide); returns this rank's (B, Lq / n, M * D). Per-level query
    segments are not passed (a rank's rows straddle pyramid levels), as
    in JAX."""
    return ms_deform_attn(copy_to_group(value, mesh.group(axis)),
                          spatial_shapes, sampling_locations,
                          attention_weights)
