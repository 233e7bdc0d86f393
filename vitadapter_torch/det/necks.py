"""Detection necks (counterpart of `vitadapter/det/necks.py`): mmdet `FPN`
(5 outputs, the extra level a stride-2 subsample of the last) and the
reference's `ChannelMapperWithPooling`. They take and return NHWC maps;
their keys are mmdet's (`lateral_convs.N.conv`, `fpn_convs.N.conv`,
`convs.N.conv` / `convs.N.gn`). `ExtraAttention` and `ChannelMapper` come
with the detectors that use them (ROADMAP.md §1 item 7)."""

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vitadapter_torch.layers.linear import Conv2d, conv_nhwc
from vitadapter_torch.layers.norm import GroupNorm


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
    """Top-down FPN: 1x1 laterals, nearest upsampling, 3x3 output convs; the
    levels past the inputs are kernel-1 stride-2 max pools of the last
    output (mmdet `add_extra_convs=False`)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList([
            ConvModule(Conv2d(c, out_channels, 1, **kw)) for c in in_channels])
        self.fpn_convs = nn.ModuleList([
            ConvModule(Conv2d(out_channels, out_channels, 3, padding=1, **kw))
            for _ in in_channels])

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        lat = [conv_nhwc(m, f) for m, f in zip(self.lateral_convs, feats)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + nearest_resize(lat[i],
                                                     lat[i - 1].shape[1:3])
        outs = [conv_nhwc(m, x) for m, x in zip(self.fpn_convs, lat)]
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
