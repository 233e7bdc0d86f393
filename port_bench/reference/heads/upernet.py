"""UperNet decode head and FCN auxiliary head (counterpart of
`vitadapter/heads/upernet.py`): `ConvBNReLU`, `adaptive_avg_pool`,
`PSPModule`, `UPerHead` and `FCNHead`, channels-last (NHWC) in and out.

Parameter names are mmseg's, which the JAX package's
`convert_upernet_heads` reads: `psp_modules.N.1.{conv,bn}`, `bottleneck`,
`lateral_convs.N`, `fpn_convs.N`, `fpn_bottleneck` and `conv_seg` in the
decode head, `convs.N` and `conv_seg` in the auxiliary head. The heads take
their input channels (`in_channels`), which the flax heads infer. Convs and
their BatchNorm run in the head's `dtype`; `conv_seg` computes in fp32.
BatchNorm takes batch statistics in training mode (one device), and the
dropout before `conv_seg` draws from the `generator` passed down.
"""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.layers.drop import Dropout
from port_bench.reference.layers.linear import Conv2d
from port_bench.reference.layers.norm import BatchNorm
from port_bench.reference.utils.resize import resize_2d


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ConvBNReLU(nn.Module):
    """Conv (no bias, 'same' padding) -> BatchNorm -> ReLU on NHWC maps."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel,
                           padding=kernel // 2, bias=False, dtype=dtype,
                           device=device)
        self.bn = BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(F.relu(self.bn(self.conv(_nchw(x)))))


def adaptive_avg_pool(x: torch.Tensor, out_hw: int) -> torch.Tensor:
    """`AdaptiveAvgPool2d(out_hw)` of (B, H, W, C) maps -> (B, o, o, C):
    segment i of n rows spans floor(i n / o) to ceil((i + 1) n / o), the
    segments of the JAX package's `adaptive_avg_pool`."""
    return _nhwc(F.adaptive_avg_pool2d(_nchw(x), out_hw))


class PSPModule(nn.ModuleList):
    """Pyramid pooling of the coarsest map: the map, and each pooled scale
    through a 1x1 `ConvBNReLU` resized back, concatenated on channels. As
    mmseg's PPM it is a list of (pool, conv) pairs, so the decode head's
    keys are `psp_modules.N.1.{conv,bn}` (the pool holds nothing)."""

    def __init__(self, in_channels: int, pool_scales: Sequence[int] = (
                 1, 2, 3, 6), channels: int = 512,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__([
            nn.Sequential(nn.Identity(),
                          ConvBNReLU(in_channels, channels, 1, dtype=dtype,
                                     device=device))
            for _ in pool_scales])
        self.pool_scales = tuple(pool_scales)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1:3]
        outs = [x]
        for s, mod in zip(self.pool_scales, self):
            p = mod[1](adaptive_avg_pool(x, s))
            outs.append(resize_2d(p, (H, W), "bilinear"))
        return torch.cat(outs, dim=-1)


class UPerHead(nn.Module):
    """PSP + FPN fusion head: per-pixel class logits (B, H/4, W/4, K) fp32
    from the 4 NHWC maps of strides 4-32 with `in_channels` channels."""

    def __init__(self, in_channels: Sequence[int], num_classes: int = 150,
                 channels: int = 512,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 dropout_ratio: float = 0.1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        in_channels = tuple(in_channels)
        kw = dict(dtype=dtype, device=device)
        self.psp_modules = PSPModule(in_channels[-1], pool_scales, channels,
                                     **kw)
        self.bottleneck = ConvBNReLU(
            in_channels[-1] + len(pool_scales) * channels, channels, 3, **kw)
        self.lateral_convs = nn.ModuleList([
            ConvBNReLU(c, channels, 1, **kw) for c in in_channels[:-1]])
        self.fpn_convs = nn.ModuleList([
            ConvBNReLU(channels, channels, 3, **kw) for _ in in_channels[:-1]])
        self.fpn_bottleneck = ConvBNReLU(len(in_channels) * channels,
                                         channels, 3, **kw)
        self.dropout = Dropout(dropout_ratio)
        self.conv_seg = Conv2d(channels, num_classes, 1, device=device)

    def forward(self, feats: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        laterals = [conv(f) for conv, f in zip(self.lateral_convs, feats)]
        laterals.append(self.bottleneck(self.psp_modules(feats[-1])))
        # top-down pathway
        for i in range(len(laterals) - 1, 0, -1):
            up = resize_2d(laterals[i], laterals[i - 1].shape[1:3],
                           "bilinear")
            laterals[i - 1] = laterals[i - 1] + up
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)]
        outs.append(laterals[-1])
        hw = outs[0].shape[1:3]
        outs = [outs[0]] + [resize_2d(o, hw, "bilinear") for o in outs[1:]]
        x = self.fpn_bottleneck(torch.cat(outs, dim=-1))
        x = self.dropout(x, generator)
        return _nhwc(self.conv_seg(_nchw(x)))


class FCNHead(nn.Module):
    """`num_convs` 3x3 `ConvBNReLU`s on one NHWC map, dropout, then the
    fp32 1x1 `conv_seg`: logits (B, H, W, K) fp32."""

    def __init__(self, in_channels: int, num_classes: int = 150,
                 channels: int = 256, num_convs: int = 1,
                 dropout_ratio: float = 0.1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.convs = nn.Sequential(*[
            ConvBNReLU(in_channels if i == 0 else channels, channels, 3,
                       dtype=dtype, device=device)
            for i in range(num_convs)])
        self.dropout = Dropout(dropout_ratio)
        self.conv_seg = Conv2d(channels if num_convs else in_channels,
                               num_classes, 1, device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.dropout(self.convs(x), generator)
        return _nhwc(self.conv_seg(_nchw(x)))
