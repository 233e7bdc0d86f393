"""Normalization layers (counterparts of `vitadapter/layers/norm.py` and of
the flax `nn.LayerNorm` / `nn.GroupNorm` the JAX package uses).

Statistics are always fp32. The output dtype follows flax: `dtype=None`
gives the promotion of the input with the fp32 parameters (fp32), a dtype
gives that dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(dim, eps=eps, device=device)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y if self.out_dtype is None else y.to(self.out_dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over NCHW."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(num_groups, num_channels, eps=eps, device=device)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                         self.eps)
        return y if self.out_dtype is None else y.to(self.out_dtype)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW with running statistics (eps 1e-5), returning the
    input dtype. Eval only: training-mode statistics are not ported yet."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "BatchNorm in training mode is not ported; call .eval()")
        c = (slice(None),) + (None,) * (x.dim() - 2)
        y = ((x.float() - self.running_mean[c])
             * torch.rsqrt(self.running_var[c] + self.eps))
        return (y * self.weight[c] + self.bias[c]).to(x.dtype)


class LayerNorm2d(nn.Module):
    """Channel LayerNorm for channels-last (..., C) maps, eps 1e-6, returning
    the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.eps = eps

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        u = xf.mean(-1, keepdim=True)
        s = (xf - u).square().mean(-1, keepdim=True)
        y = (xf - u) * torch.rsqrt(s + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)
