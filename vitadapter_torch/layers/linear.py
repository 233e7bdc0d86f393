"""Linear and convolution layers with fp32 parameters and a compute dtype.

The counterpart of flax's `nn.Dense(dtype=...)` / `nn.Conv(dtype=...)`:
parameters are stored in fp32 and cast, with the input, to `dtype` for the
product; the result is in `dtype`. Parameter names and layouts are
PyTorch's, so reference checkpoints load as they are. Convolutions take
NCHW tensors (an NCHW view of an NHWC tensor runs channels-last).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv2d(nn.Conv2d):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, groups=groups, bias=bias,
                         device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), b,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An NCHW conv on an NHWC map, NHWC out."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
