"""Tensor parallelism over a (data, model) grid of ranks (counterpart of
`vitadapter/parallel/tp.py`).

JAX writes Megatron's split as `PartitionSpec`s and the compiler places the
collectives. Here each rank holds its shard of every split layer and the
two conjugate functions of `parallel/collectives.py` are written out:
  * a column-parallel layer (the first of a pair: attention `qkv` and the
    q/k/v projections, the MLP's and FFN's `fc1`) keeps this rank's rows
    of the weight and bias (torch dim 0; JAX's kernel's output dim) and
    takes its replicated input through `copy_to_group`;
  * a row-parallel layer (the second: attention `proj`/`out_proj`, the
    MLP's and FFN's `fc2`) keeps this rank's columns (torch dim 1; JAX's
    input dim), and its partial products go through `reduce_from_group`
    before the whole bias is added, once.
A packed q/k/v weight is split head-aligned: rank m of a model group of
`tp` holds the q, k and v rows of heads [m h/tp, (m+1) h/tp), so the
rank's attention, the fused kernels on the card, runs on its own heads.
(`torch.distributed.tensor.parallel`'s `ColwiseParallel` would cut the
packed rows contiguously, q to rank 0, and hands DTensors to an autograd
function, the attention kernel's, that takes plain local tensors.)

The layers split are those of these classes, wherever they sit:
`layers.attention.Attention` (and `WindowedAttention`), `layers.mlp.Mlp`,
`heads.pixel_decoder.FFN`, `heads.mask2former.MultiheadAttention`. In the
ViT-Adapter + Mask2Former segmentor that is exactly JAX's rule (`_FANOUT`,
`_FANIN`, `mlp`, `attn`/`self_attn`/`cross_attn` parents); everything
else (norms, convolutions, the adapter's ConvFFN, every MSDA projection,
the heads' embeddings) is whole on every rank and trains as a data
parallel replica. The train step is the same function
(`train.trainer.make_m2f_train_step`): the loss, SyncBN and the logs run
over the data group, and `LayerDecayAdamW.step` averages and clips as
JAX's optax chain does on the logical arrays.
"""

import functools
from typing import Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from vitadapter_torch.layers.linear import Linear
from vitadapter_torch.parallel.collectives import (copy_to_group,
                                                   reduce_from_group,
                                                   world_size)
from vitadapter_torch.parallel.mesh import Mesh, use_grid, world


class Split(NamedTuple):
    """How a parameter is split over the model group: along torch dim
    `dim`, in `blocks` equal blocks each cut alike (3 for packed q/k/v)."""
    dim: int
    blocks: int = 1


def make_tp_mesh(tp: int = 1) -> Mesh:
    """The (data, model) grid over every rank, `tp` consecutive ranks a
    model group (JAX's layout: rank r = data * tp + model), made the
    process's grid (`parallel.mesh.use_grid`). Every rank must call it."""
    size = world()[1]
    if tp < 1 or size % tp:
        raise ValueError(f"a model group of {tp} does not split {size} "
                         "ranks")
    mesh = Mesh(("data", "model"), (size // tp, tp))
    use_grid(mesh)
    return mesh


class ColumnParallelLinear(Linear):
    """A `Linear` holding this rank's output rows, its input passed through
    `copy_to_group`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(copy_to_group(x, self.tp_group))


@functools.cache
def column_parallel_projections():
    """The column-parallel form of Mask2Former's packed q/k/v projections
    (`heads.mask2former.Projections`, imported here because the heads
    import this package): this rank's heads' rows, the input passed
    through `copy_to_group`."""
    from vitadapter_torch.heads.mask2former import Projections

    class ColumnParallelProjections(Projections):
        def project(self, x: torch.Tensor, i: int) -> torch.Tensor:
            return super().project(copy_to_group(x, self.tp_group), i)

    return ColumnParallelProjections


class RowParallelLinear(Linear):
    """A `Linear` holding this rank's input columns: its partial product
    summed over the group, then the bias (whole on every rank) added."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = reduce_from_group(F.linear(x.to(dt), self.weight.to(dt)),
                              self.tp_group)
        return y if self.bias is None else y + self.bias.to(dt)


def _layers(model: nn.Module):
    """(module name, module, {parameter: Split}, [(attribute, column or
    row)], the heads to split or None) for each layer of `model` that
    `shard_model` splits."""
    from vitadapter_torch.heads.mask2former import MultiheadAttention
    from vitadapter_torch.heads.pixel_decoder import FFN
    from vitadapter_torch.layers.attention import Attention
    from vitadapter_torch.layers.mlp import Mlp

    for name, m in model.named_modules():
        if isinstance(m, Attention):
            yield (name, m, {"qkv.weight": Split(0, 3), "qkv.bias": Split(0, 3),
                             "proj.weight": Split(1)},
                   [("qkv", ColumnParallelLinear),
                    ("proj", RowParallelLinear)], m.num_heads)
        elif isinstance(m, Mlp):
            yield (name, m, {"fc1.weight": Split(0), "fc1.bias": Split(0),
                             "fc2.weight": Split(1)},
                   [("fc1", ColumnParallelLinear),
                    ("fc2", RowParallelLinear)], None)
        elif isinstance(m, FFN):
            yield (name, m, {"layers.0.0.weight": Split(0),
                             "layers.0.0.bias": Split(0),
                             "layers.1.weight": Split(1)},
                   [("layers.0.0", ColumnParallelLinear),
                    ("layers.1", RowParallelLinear)], None)
        elif isinstance(m, MultiheadAttention):
            yield (name, m, {"attn.in_proj_weight": Split(0, 3),
                             "attn.in_proj_bias": Split(0, 3),
                             "attn.out_proj.weight": Split(1)},
                   [("attn", column_parallel_projections()),
                    ("attn.out_proj", RowParallelLinear)], m.num_heads)


def _present(m: nn.Module, splits: Dict[str, Split]):
    """(name, parameter) of the parameters in `splits` that `m` has (a
    projection may have no bias)."""
    params = dict(m.named_parameters())
    return [(p, params[p]) for p in splits if p in params]


def partition_specs(model: nn.Module) -> Dict[str, Optional[Split]]:
    """Every parameter name of `model` (its full, unsplit names) mapped to
    its `Split`, or None where it stays whole: JAX's `partition_specs`
    read on the port's names (a kernel's output dim is torch's dim 0)."""
    specs: Dict[str, Optional[Split]] = {n: None for n, _ in
                                         model.named_parameters()}
    for name, _, splits, _, _ in _layers(model):
        for p, split in splits.items():
            full = f"{name}.{p}" if name else p
            if full in specs:
                specs[full] = split
    return specs


def _cut(t: torch.Tensor, split: Split, index: int, n: int) -> torch.Tensor:
    """Shard `index` of `n` of `t` under `split`."""
    blocks = t.chunk(split.blocks, split.dim)
    return torch.cat([b.chunk(n, split.dim)[index] for b in blocks],
                     split.dim)


def _swap(parent: nn.Module, path: str, cls, group) -> None:
    """Replace the module at `path` under `parent` by one of `cls` with
    the same (already cut) parameters, names unchanged, and the model
    group."""
    *up, last = path.split(".")
    owner = parent.get_submodule(".".join(up)) if up else parent
    old = getattr(owner, last)
    new = cls.__new__(cls)
    new.__dict__.update(old.__dict__)
    new.tp_group = group
    if isinstance(new, nn.Linear):
        new.out_features, new.in_features = new.weight.shape
    setattr(owner, last, new)


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Split `model` over `mesh`'s model group, in place: each split
    parameter is cut to this rank's shard (a Parameter of its own, tagged
    `tp_dim`), the column- and row-parallel linears are swapped in, and
    each attention keeps its share of the heads. Every rank must hold the
    same full weights (build them from one seed, or `replicate`); make the
    optimizer after. Raises ValueError naming the layer whose heads or
    hidden width the model group does not divide."""
    n, index = mesh.size("model"), mesh.index("model")
    group = mesh.group("model")
    layers = list(_layers(model))
    for name, m, splits, _, heads in layers:
        if heads is not None and heads % n:
            raise ValueError(f"{name}: {heads} heads do not split over a "
                             f"model group of {n}")
        for p, t in _present(m, splits):
            size = t.shape[splits[p].dim] // splits[p].blocks
            if size % n:
                raise ValueError(f"{name}: {p}'s width {size} does not "
                                 f"split over a model group of {n}")
    if n == 1:
        return model
    for name, m, splits, swaps, heads in layers:
        for p, t in _present(m, splits):
            *up, last = p.split(".")
            owner = m.get_submodule(".".join(up)) if up else m
            shard = nn.Parameter(_cut(t.detach(), splits[p], index,
                                      n).clone())
            shard.tp_dim = splits[p].dim
            owner._parameters[last] = shard
        for path, cls in swaps:
            _swap(m, path, cls, group)
        if heads is not None:
            m.num_heads = heads // n
    return model


def shard_batch_2d(batch: Dict[str, np.ndarray], mesh: Mesh
                   ) -> Dict[str, np.ndarray]:
    """This rank's rows of every entry of a global batch: split over the
    data axis, the same on every rank of a model group."""
    n, index = mesh.size("data"), mesh.index("data")
    out = {}
    for k, v in batch.items():
        if len(v) % n:
            raise ValueError(f"a global batch of {len(v)} does not split "
                             f"over {n} data ranks")
        s = len(v) // n
        out[k] = v[index * s:(index + 1) * s]
    return out


def _gather(t: torch.Tensor, split: Split, mesh: Mesh) -> torch.Tensor:
    """The logical tensor of the model group's shards `t`, each rank's
    shard broadcast by its owner (shards of packed q/k/v put back block
    by block)."""
    group, ranks = mesh.group("model"), mesh.ranks("model")
    shards = []
    for src in ranks:
        buf = t.detach().clone() if src == dist.get_rank() else \
            torch.empty_like(t)
        dist.broadcast(buf, src, group)
        shards.append(buf)
    blocks = [s.chunk(split.blocks, split.dim) for s in shards]
    return torch.cat([torch.cat([b[j] for b in blocks], split.dim)
                      for j in range(split.blocks)], split.dim)


def _gather_all(model: nn.Module, mesh: Mesh,
                tensors: Iterable[Tuple[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    specs = partition_specs(model)
    split = world_size(mesh.group("model")) > 1
    out = {}
    for name, t in tensors:
        s = specs.get(name)
        out[name] = (_gather(t, s, mesh) if split and s is not None
                     else t.detach().clone())
    return out


def gather_state_dict(model: nn.Module, mesh: Mesh
                      ) -> Dict[str, torch.Tensor]:
    """The model's full state dict (the logical tensors of its shards, as
    reading a sharded `jax.Array`), on every rank of the model group: a
    collective of the model group."""
    return _gather_all(model, mesh, model.state_dict().items())


def gather_grads(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The full gradient of every parameter that has one, by name: a
    collective of the model group."""
    return _gather_all(model, mesh, [(n, p.grad) for n, p in
                                     model.named_parameters()
                                     if p.grad is not None])
