"""Transformer MLP block (counterpart of `vitadapter/layers/mlp.py`)."""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.layers.linear import Linear


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as torch's nn.GELU and the JAX package use."""
    return F.gelu(x)


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: Optional[int] = None,
                 out_features: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        hidden = hidden_features or in_features
        out = out_features or in_features
        self.fc1 = Linear(in_features, hidden, dtype=dtype, device=device)
        self.fc2 = Linear(hidden, out, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))
