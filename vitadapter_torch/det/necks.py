"""Detection necks (counterpart of `vitadapter/det/necks.py`): mmdet `FPN`
(5 outputs, the extra levels stride-2 subsamples of the last or, for
ATSS/GFL, learned stride-2 convs chained on it), the
reference's `ChannelMapperWithPooling` and HTC++'s `ExtraAttention`. They
take and return NHWC maps; their keys are mmdet's (`lateral_convs.N.conv`,
`fpn_convs.N.conv`, `convs.N.conv` / `convs.N.gn`, `extra_convs.N.conv`)
and the reference's (`norm1`, `attn.qkv`, `ffn.fc1`, `final_norm`, ...).
mmdet's `ChannelMapper` feeds the DINO detectors."""

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vitadapter_torch.layers.attention import Attention
from vitadapter_torch.layers.linear import Conv2d, conv_nhwc
from vitadapter_torch.layers.mlp import Mlp
from vitadapter_torch.layers.norm import GroupNorm, LayerNorm


def nearest_resize(x: torch.Tensor, hw) -> torch.Tensor:
    """NHWC nearest resize as torch's F.interpolate(mode='nearest') and the
    JAX package's `resize_2d(..., "nearest")`: source = floor(dst * in /
    out), by a gather (`utils/resize.resize_2d` would multiply by 0/1
    matrices, out x in a side)."""
    (H, W), (h, w) = x.shape[1:3], hw
    rows = np.minimum((np.arange(h) * (H / h)).astype(np.int64), H - 1)
    cols = np.minimum((np.arange(w) * (W / w)).astype(np.int64), W - 1)
    return x[:, torch.from_numpy(rows).to(x.device)][
        :, :, torch.from_numpy(cols).to(x.device)]


class ConvModule(nn.Module):
    """mmcv's `ConvModule` as the necks use it: `conv`, optionally `gn`."""

    def __init__(self, conv: nn.Module, gn: Optional[nn.Module] = None):
        super().__init__()
        self.conv = conv
        if gn is not None:
            self.gn = gn

    def forward(self, x):
        x = self.conv(x)
        return self.gn(x) if hasattr(self, "gn") else x


class FPN(nn.Module):
    """Top-down FPN: 1x1 laterals, nearest upsampling, 3x3 output convs on
    the inputs from `start_level` on. The levels past them are kernel-1
    stride-2 max pools of the last output (`extra="pool"`, mmdet
    `add_extra_convs=False`) or learned 3x3 stride-2 convs chained on it
    (`extra="on_output"`, the ATSS/GFL configs with `start_level=1`: strides
    8-128), kept in `fpn_convs` after the outputs' convs as mmdet keeps
    them."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, start_level: int = 0,
                 extra: str = "pool", dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        if extra not in ("pool", "on_output"):
            raise ValueError(f"extra {extra!r}: 'pool' or 'on_output'")
        kw = dict(dtype=dtype, device=device)
        in_channels = list(in_channels)[start_level:]
        self.num_outs = num_outs
        self.start_level = start_level
        self.n_in = len(in_channels)
        n_extra = max(num_outs - self.n_in, 0) if extra == "on_output" else 0
        self.lateral_convs = nn.ModuleList([
            ConvModule(Conv2d(c, out_channels, 1, **kw)) for c in in_channels])
        self.fpn_convs = nn.ModuleList([
            ConvModule(Conv2d(out_channels, out_channels, 3, padding=1, **kw))
            for _ in in_channels] + [
            ConvModule(Conv2d(out_channels, out_channels, 3, stride=2,
                              padding=1, **kw)) for _ in range(n_extra)])

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        feats = list(feats)[self.start_level:]
        lat = [conv_nhwc(m, f) for m, f in zip(self.lateral_convs, feats)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + nearest_resize(lat[i],
                                                     lat[i - 1].shape[1:3])
        outs = [conv_nhwc(m, x) for m, x in zip(self.fpn_convs, lat)]
        for m in self.fpn_convs[self.n_in:]:
            outs.append(conv_nhwc(m, outs[-1]))
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, ::2, ::2])
        return outs


class ChannelMapperWithPooling(nn.Module):
    """A 1x1 conv (no bias) and GroupNorm(32) per level, the extra levels
    2x2 stride-2 max pools of the last map (reference
    `detection/mmdet_custom/models/necks/channel_mapper.py`)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 4, groups: int = 32,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_outs = num_outs
        self.convs = nn.ModuleList([
            ConvModule(Conv2d(c, out_channels, 1, bias=False, dtype=dtype,
                              device=device),
                       GroupNorm(groups, out_channels, dtype=dtype,
                                 device=device))
            for c in in_channels])

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        outs = [conv_nhwc(m, f) for m, f in zip(self.convs, feats)]
        while len(outs) < self.num_outs:
            x = outs[-1].permute(0, 3, 1, 2)
            outs.append(F.max_pool2d(x, 2, 2).permute(0, 2, 3, 1))
        return outs


class ChannelMapper(nn.Module):
    """mmdet's `ChannelMapper` as the DINO configs use it (kernel 1,
    GroupNorm(32), no activation): a 1x1 conv (no bias) and GroupNorm per
    input level, then LEARNED extra levels, each a 3x3 stride-2 conv (no
    bias) and GroupNorm; the first extra reads the last INPUT map, later
    ones chain."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 4, groups: int = 32,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)

        def conv_gn(cin, kernel, stride):
            return ConvModule(
                Conv2d(cin, out_channels, kernel, stride=stride,
                       padding=kernel // 2, bias=False, **kw),
                GroupNorm(groups, out_channels, **kw))

        self.convs = nn.ModuleList([conv_gn(c, 1, 1) for c in in_channels])
        n_extra = max(num_outs - len(in_channels), 0)
        self.extra_convs = nn.ModuleList([
            conv_gn(in_channels[-1] if j == 0 else out_channels, 3, 2)
            for j in range(n_extra)])

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        outs = [conv_nhwc(m, f) for m, f in zip(self.convs, feats)]
        src = feats[-1]
        for m in self.extra_convs:
            src = conv_nhwc(m, src)
            outs.append(src)
        return outs


class ExtraAttention(nn.Module):
    """One global MHSA block on the coarsest level before the FPN
    (reference `extra_attention.py:60-152`, with the JAX module's defaults,
    which every config keeps): LayerNorm (torch's eps 1e-5), the global
    `Attention` (8 heads, qkv with bias, the fused attention kernel on the
    card), an FFN (ratio 4) with its own LayerNorm, and a final LayerNorm;
    no layer-scale gammas. Other levels pass through."""

    def __init__(self, dim: int, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5, device=device)
        self.attn = Attention(dim, num_heads, qkv_bias=True, dtype=dtype,
                              device=device)
        self.norm2 = LayerNorm(dim, eps=1e-5, device=device)
        self.ffn = Mlp(dim, 4 * dim, dtype=dtype, device=device)
        self.final_norm = LayerNorm(dim, eps=1e-5, device=device)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        feats = list(feats)
        B, H, W, C = feats[-1].shape
        x = feats[-1].reshape(B, H * W, C)
        x = x + self.attn(self.norm1(x), H, W)
        x = x + self.ffn(self.norm2(x))
        feats[-1] = self.final_norm(x).reshape(B, H, W, C)
        return feats
