"""Cross-rank reductions (counterpart of `vitadapter/parallel/
collectives.py`; reference `mmseg_custom/core/utils/dist_utils.py`).

Under `jax.jit` over a sharded batch the compiler inserts these; the port's
ranks call them explicitly, each in the same order on every rank:
  * `reduce_mean` (`:66-73`), and `global_normalizer` on it: a loss
    normalizer counted over the global batch (mmdet's
    `reduce_mean(num_pos)`);
  * `all_reduce_sum`: a differentiable sum (SyncBN's statistics);
  * `allreduce_grads` (`:14-56`): the gradients averaged, coalesced into
    buckets;
  * `all_reduce_dict` (`:87-121`): logged scalars, averaged;
  * `process_allgather`, `broadcast_object`: host results of the
    evaluation (the reference `multi_gpu_test`'s collection);
  * `copy_to_group`, `reduce_from_group`: Megatron's conjugate pair
    around a tensor-parallel layer (`parallel/tp.py`).
Each takes a `group`: None is the whole world (`torch.distributed`'s
default group). A train step under a (data, model) grid passes the data
group (`parallel.mesh.data_group`). With one rank in the group none of
them communicates. The collectives run on
NCCL for CUDA tensors, or on gloo, which reduces and broadcasts CUDA
tensors but gathers only objects here.
"""

from typing import Any, Callable, Dict, List, Sequence

import torch
import torch.distributed as dist

# the largest bucket one collective takes
BUCKET_BYTES = 64 * 2 ** 20


def world_size(group=None) -> int:
    """The number of ranks in `group` (None: the world); 1 without a
    process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _coalesced(tensors: Sequence[torch.Tensor],
               op: Callable[[torch.Tensor], None]) -> None:
    """Apply the in-place collective `op` to `tensors` through flat buckets
    of one dtype and device, at most `BUCKET_BYTES` each (a tensor larger
    than that is a bucket of its own), copying the results back."""
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        buckets, size = [[]], 0
        for t in group:
            nbytes = t.numel() * t.element_size()
            if buckets[-1] and size + nbytes > BUCKET_BYTES:
                buckets.append([])
                size = 0
            buckets[-1].append(t)
            size += nbytes
        for bucket in buckets:
            flat = torch.cat([b.reshape(-1) for b in bucket])
            op(flat)
            for b, v in zip(bucket, flat.split([b.numel() for b in bucket])):
                b.copy_(v.view_as(b))


def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0,
                      group=None) -> None:
    """Rank `src`'s values (a global rank in `group`) into `tensors` on
    every rank of `group`."""
    if world_size(group) > 1:
        _coalesced(tensors, lambda flat: dist.broadcast(flat, src, group))


def reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of `x` over the ranks of `group` (no gradient)."""
    n = world_size(group)
    if n == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y / n


def global_normalizer(count: torch.Tensor, floor: float = 1.0,
                      group=None) -> torch.Tensor:
    """A loss normalizer for one rank's share of a batch: `count` (this
    rank's) summed over the ranks and floored at `floor`, over the world
    size. A rank dividing its loss by it, and the ranks' gradients then
    averaged, give the gradient of the loss that one process takes over
    the global batch (JAX's normalizer, counted under `jit` over the whole
    sharded batch), and the ranks' mean loss is that loss. The ranks are
    those of `group`, the data group where the model is split. With one
    rank, `count.clamp(min=floor)`."""
    n = world_size(group)
    if n == 1:
        return count.clamp(min=floor)
    return reduce_mean(count.float(), group).clamp(min=floor / n)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its gradient is the sum of the ranks'
    gradients (each rank's input reaches every rank's output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    """The identity; its gradient is summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """The sum over the group; its gradient passes as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of `x` over the ranks of `group`."""
    return x if world_size(group) == 1 else _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's `f` in front of a column-parallel layer: `x`, the same on
    every rank of `group`, as it is; in the backward the ranks' partial
    gradients of it (each from its own slice of the layer's outputs) are
    summed."""
    return x if world_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's `g` after a row-parallel layer: the ranks' partial sums
    added; the gradient, the same on every rank, passes as it is."""
    return x if world_size(group) == 1 else _ReduceFromGroup.apply(x, group)


def allreduce_grads(params: Sequence[torch.nn.Parameter], group=None) -> None:
    """Average the gradients of `params` over the ranks of `group`, in
    place. A
    trainable parameter without a gradient takes a zero one first (frozen
    ones are left out), so that every rank reduces the same list (a rank
    whose data reached a parameter the others' did not would otherwise
    issue other collectives, and the group would hang); JAX's
    `value_and_grad` gives it zero as well."""
    n = world_size(group)
    if n == 1:
        return
    grads = []
    for p in params:
        if p.grad is None and p.requires_grad:
            p.grad = torch.zeros_like(p)
        if p.grad is not None:
            grads.append(p.grad)

    def mean(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(n)

    _coalesced(grads, mean)


def all_reduce_dict(d: Dict[str, torch.Tensor], group=None
                    ) -> Dict[str, torch.Tensor]:
    """Scalars (0-d tensors of one device) averaged over the ranks of
    `group` in one collective, in the dict's key order."""
    if world_size(group) == 1 or not d:
        return d
    keys = list(d)
    return dict(zip(keys, reduce_mean(torch.stack(
        [d[k].detach().float() for k in keys]), group).unbind()))


def process_allgather(obj: Any, group=None) -> List[Any]:
    """Every rank's picklable `obj`, in rank order, on every rank of
    `group`."""
    n = world_size(group)
    if n == 1:
        return [obj]
    out: List[Any] = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object(obj: Any, src: int = 0, group=None) -> Any:
    """Rank `src`'s picklable `obj` (a global rank in `group`) on every
    rank of `group`."""
    if world_size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src, group=group)
    return box[0]


def barrier(group=None) -> None:
    if world_size(group) > 1:
        dist.barrier(group=group)
