"""Stochastic depth (counterpart of `vitadapter/layers/drop.py`)."""

from typing import Optional

import torch
from torch import nn


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
