"""Pipeline parallelism, GPipe's fill-and-drain schedule over a `stage`
axis of ranks (counterpart of `vitadapter/parallel/pp.py`).

A stack of layers is split into S contiguous stages, one a rank
(`split_stages`), and M microbatches stream through them: with T = M + S - 1
steps, stage s computes microbatch t - s at step t while 0 <= t - s < M.
Activations go to the next stage by point-to-point sends and the last
stage's outputs reach every rank by a broadcast. The whole schedule is one
autograd function (`pipeline_apply`): its backward runs the schedule in
reverse, each stage taking its outputs' gradient from the next stage (the
last stage from the loss), back-propagating through its own layers, whose
parameters gather their gradients, and sending its inputs' gradient to the
stage before. The outputs are replicated, so every rank's loss on them is
the same logical loss: the backward takes the last stage's own gradient of
its outputs and ignores the other ranks' copies (a broadcast whose
backward summed the ranks' gradients would multiply the stack's gradients
by S). `torch.distributed.pipelining`'s schedules own the loss and the
backward and return no outputs for autograd, so the schedule is written
here.

Gloo's `send`/`recv` abort the process on a CUDA tensor (torch 2.11 on an
H100: `writev ... Bad address`): over a gloo group the
activations and their gradients are staged through host memory (gloo
reduces and broadcasts CUDA tensors itself); NCCL sends them from the
card.
"""

from typing import Callable, List, Sequence

import torch
import torch.distributed as dist
from torch import nn

from vitadapter_torch.parallel.mesh import Mesh, world


def make_pp_mesh(ranks: int = None, axis: str = "stage") -> Mesh:
    """A 1-D mesh of `ranks` stages (default: every rank)."""
    return Mesh((axis,), (world()[1] if ranks is None else ranks,))


def split_stages(blocks: Sequence[nn.Module], mesh: Mesh,
                 axis: str = "stage") -> nn.ModuleList:
    """This rank's stage: its contiguous depth / S of `blocks` (JAX's
    `stack_layer_params` + `shard_stacked`)."""
    S, s = mesh.size(axis), mesh.index(axis)
    if len(blocks) % S:
        raise ValueError(f"{len(blocks)} layers do not split into {S} "
                         "stages")
    per = len(blocks) // S
    return nn.ModuleList(list(blocks)[s * per:(s + 1) * per])


def _host_staged(group) -> bool:
    return dist.get_backend(group) == dist.Backend.GLOO


def _send(t: torch.Tensor, dst: int, group) -> None:
    t = t.detach().contiguous()
    dist.send(t.cpu() if _host_staged(group) else t, dst, group)


def _recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    if _host_staged(group):
        buf = torch.empty(like.shape, dtype=like.dtype)
        dist.recv(buf, src, group)
        return buf.to(like.device)
    buf = torch.empty_like(like)
    dist.recv(buf, src, group)
    return buf


class _Pipeline(torch.autograd.Function):
    """GPipe over `mesh`'s `axis`: forward and backward schedules, the
    stage's autograd graphs kept between them."""

    @staticmethod
    def forward(ctx, stage, mesh, axis, xs, *params):
        S, s = mesh.size(axis), mesh.index(axis)
        ranks, group = mesh.ranks(axis), mesh.group(axis)
        M = xs.shape[0]
        ctx.stage_args = (S, s, ranks, group, M)
        ctx.n_params = len(params)
        ins, outs = [], []
        with torch.enable_grad():
            for t in range(M + S - 1):
                i = t - s
                if not 0 <= i < M:
                    continue
                x = (xs[i] if s == 0 else
                     _recv(xs[i], ranks[s - 1], group)).detach()
                x.requires_grad_(s > 0 or xs.requires_grad)
                y = stage(x)
                if y.shape != xs.shape[1:] or y.dtype != xs.dtype:
                    raise ValueError(f"a stage maps {tuple(xs.shape[1:])} "
                                     f"{xs.dtype} to {tuple(y.shape)} "
                                     f"{y.dtype}")
                if s < S - 1:
                    _send(y, ranks[s + 1], group)
                ins.append(x)
                outs.append(y)
        ctx.ins, ctx.outs = ins, outs
        out = (torch.stack([y.detach() for y in outs]) if s == S - 1
               else torch.empty_like(xs))
        if S > 1:
            dist.broadcast(out, ranks[S - 1], group)
        return out

    @staticmethod
    def backward(ctx, grad):
        S, s, ranks, group, M = ctx.stage_args
        ins, outs = ctx.ins, ctx.outs
        dxs = torch.zeros_like(grad) if ctx.needs_input_grad[3] else None
        for i in reversed(range(M)):
            g = (grad[i] if s == S - 1 else
                 _recv(grad[i], ranks[s + 1], group))
            torch.autograd.backward(outs[i], g)
            if s > 0:
                _send(ins[i].grad, ranks[s - 1], group)
            elif dxs is not None:
                dxs[i] = ins[i].grad
        ctx.ins = ctx.outs = None
        if dxs is not None and S > 1:
            dist.broadcast(dxs, ranks[0], group)
        return (None, None, None, dxs) + (None,) * ctx.n_params


def pipeline_apply(stage: Callable[[torch.Tensor], torch.Tensor],
                   xs: torch.Tensor, mesh: Mesh, axis: str = "stage",
                   params: List[torch.Tensor] = None) -> torch.Tensor:
    """Run the microbatches `xs` (n_micro, micro_batch, ...), the same on
    every rank, through the pipeline of every rank's `stage` (this rank's
    layers, e.g. `split_stages`' ModuleList applied in order), which must
    map a microbatch to its own shape and dtype (JAX's loop carry). Returns
    the (n_micro, micro_batch, ...) outputs on every rank. Differentiable:
    the stage's parameters (`params`, default those of `stage` where it is
    a Module) gather their gradients when the outputs' backward runs, and
    `xs` gets its gradient where it requires one; every rank must run the
    backward (`.backward()`, not `torch.autograd.grad`), since the stages'
    backward passes exchange gradients."""
    if params is None:
        params = list(stage.parameters()) if isinstance(stage, nn.Module) \
            else []
    return _Pipeline.apply(stage, mesh, axis, xs, *params)
