"""Stochastic depth and dropout drawing from an explicit generator
(counterpart of `vitadapter/layers/drop.py` and flax's `nn.Dropout`), and
block recomputation that replays those draws."""

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def drop_path(x: torch.Tensor, keep_mask: torch.Tensor,
              keep_prob: float) -> torch.Tensor:
    """Keep sample b of x (B, ...) scaled by 1 / keep_prob where
    keep_mask[b], else zero it; in x's dtype."""
    mask = keep_mask.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    return torch.where(mask, x / keep_prob, 0.0).to(x.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth: in training mode, drop the residual
    branch of each sample with probability `rate`, the keep mask drawn as
    uniform < 1 - rate from `generator` (the default generator of x's
    device when None); the identity at eval."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        u = torch.rand((x.shape[0],), generator=generator, device=x.device)
        return drop_path(x, u < keep, keep)


class Dropout(nn.Module):
    """Element-wise dropout as flax's `nn.Dropout`: in training mode each
    element is kept where a uniform draw from `generator` is below
    1 - rate, and scaled by 1 / (1 - rate); the identity at eval."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        u = torch.rand(x.shape, generator=generator, device=x.device)
        return torch.where(u < keep, x / keep, 0.0).to(x.dtype)


def checkpointed(block: nn.Module, x: torch.Tensor,
                 generator: Optional[torch.Generator], *args) -> torch.Tensor:
    """`block(x, *args, generator)` with its activations recomputed in the
    backward (a BEiT block takes no `args`, a ViT block `H, W`). The
    recompute must draw DropPath's masks again, and an explicit generator
    has moved on by then: each run of the block draws from a private
    generator set to the caller's state at the block's start, and the
    caller's generator then takes the state the forward left, so the draws
    are those of the block run without checkpointing. (With no generator,
    DropPath draws from the device's default generator, whose state
    `checkpoint` saves and restores itself.)"""
    if generator is None:
        return checkpoint(block, x, *args, None, use_reentrant=False)
    start = generator.get_state()
    after = []

    def run(t):
        g = torch.Generator(generator.device)
        g.set_state(start)
        out = block(t, *args, g)
        after.append(g.get_state())
        return out

    out = checkpoint(run, x, use_reentrant=False)
    generator.set_state(after[0])
    return out
