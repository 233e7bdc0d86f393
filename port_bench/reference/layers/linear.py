"""Linear and convolution layers with fp32 parameters and a compute dtype:
parameters are stored in fp32 and cast, with the input, to `dtype` for the
product; the result is in `dtype`. Convolutions take NCHW tensors.

`LOWER_PRECISION` set true turns every bf16 product into an fp8 one (the
correctness check's control), as fp8 training does: both operands are
rounded to float8_e4m3fn with a per-tensor scale (amax / 448) before the
bf16 product, and the gradient that reaches each of them to float8_e5m2
(amax / 57344).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LOWER_PRECISION = False
FP8 = ((torch.float8_e4m3fn, 448.0), (torch.float8_e5m2, 57344.0))


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """t rounded to an fp8 `dtype` under a per-tensor scale, in t's dtype."""
    scale = t.abs().amax().float().clamp(min=1e-30) / top
    return ((t.float() / scale).to(dtype).float() * scale).to(t.dtype)


class Fp8Round(torch.autograd.Function):
    """Forward: round to e4m3; backward: round the gradient to e5m2."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, *FP8[0])

    @staticmethod
    def backward(ctx, g):
        return _round(g, *FP8[1])


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    return Fp8Round.apply(t)


def operands(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype):
    """x and w cast to the compute dtype (and to fp8 under the control)."""
    x, w = x.to(dt), w.to(dt)
    if LOWER_PRECISION and dt == torch.bfloat16:
        x, w = fp8_round(x), fp8_round(w)
    return x, w


class Linear(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(*operands(x, self.weight, dt), b)


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
        return F.conv2d(*operands(x, self.weight, dt), b, self.stride,
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
        return F.conv_transpose2d(*operands(x, self.weight, dt), b,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An NCHW conv on an NHWC map, NHWC out."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
