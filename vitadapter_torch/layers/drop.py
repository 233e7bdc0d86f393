"""Stochastic depth (counterpart of `vitadapter/layers/drop.py`)."""

import torch
from torch import nn


class DropPath(nn.Module):
    """Per-sample stochastic depth: the identity at eval. Training-mode
    dropping is not ported yet."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.rate > 0.0:
            raise NotImplementedError(
                "DropPath in training mode is not ported; call .eval()")
        return x
