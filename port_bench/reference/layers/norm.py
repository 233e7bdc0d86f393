"""Normalization layers.

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
    """GroupNorm over NCHW. A group of one value normalizes to 0 (the
    output is the bias), as flax's does; `F.group_norm` refuses a batch of
    one such map (one channel a group on a 1x1 map)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(num_groups, num_channels, eps=eps, device=device)
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] == self.num_groups and x[0, 0].numel() == 1:
            y = x.float() * 0 + self.bias.view(1, -1, *[1] * (x.dim() - 2))
        else:
            y = F.group_norm(x.float(), self.num_groups, self.weight,
                             self.bias, self.eps)
        return y if self.out_dtype is None else y.to(self.out_dtype)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW (eps 1e-5), returning the input dtype. In
    training mode it normalizes with the statistics of the whole batch, the
    biased variance taken as E[x^2] - E[x]^2 in fp32, and moves the running
    statistics by `momentum` (0.1) towards the batch mean and the unbiased
    batch variance."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = (slice(None),) + (None,) * (x.dim() - 2)
        xf = x.float()
        if self.training:
            axes = (0,) + tuple(range(2, x.dim()))
            n = x.numel() // x.shape[1]
            mean = xf.mean(axes)
            var = xf.square().mean(axes) - mean.square()
            with torch.no_grad():
                unbiased = var * (n / max(n - 1, 1))
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * unbiased)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean[c]) * torch.rsqrt(var[c] + self.eps)
        return (y * self.weight[c] + self.bias[c]).to(x.dtype)


class LayerNorm2d(nn.Module):
    """Channel LayerNorm for channels-last (..., C) maps, eps 1e-6, returning
    the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        u = xf.mean(-1, keepdim=True)
        s = (xf - u).square().mean(-1, keepdim=True)
        y = (xf - u) * torch.rsqrt(s + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)
