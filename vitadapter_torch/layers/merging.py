"""Adaptive padding and Swin-style patch merging on NHWC maps (counterpart
of `vitadapter/layers/merging.py`; reference
`segmentation/mmseg_custom/models/utils/transformer.py:37,108`)."""

import torch
import torch.nn.functional as F
from torch import nn

from vitadapter_torch.layers.linear import Linear
from vitadapter_torch.layers.norm import LayerNorm


def adaptive_padding(x: torch.Tensor, kernel: int, stride: int,
                     mode: str = "corner") -> torch.Tensor:
    """Zero-pad (B, H, W, C) so that a (kernel, stride) window covers H and
    W exactly: at the bottom and right ('corner'), or split evenly with the
    odd pixel at the bottom and right ('same')."""
    H, W = x.shape[1:3]
    pad_h = max((-(-H // stride) - 1) * stride + kernel - H, 0)
    pad_w = max((-(-W // stride) - 1) * stride + kernel - W, 0)
    if pad_h == 0 and pad_w == 0:
        return x
    if mode == "corner":
        return F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    return F.pad(x, (0, 0, pad_w // 2, pad_w - pad_w // 2,
                     pad_h // 2, pad_h - pad_h // 2))


class PatchMerging(nn.Module):
    """Each 2x2 neighbourhood's channels concatenated (row-major within the
    window, as the JAX module), LayerNorm (eps 1e-5) and a linear
    projection without bias: (B, H, W, C) -> (B, ceil(H/2), ceil(W/2),
    out_channels)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.norm = LayerNorm(4 * in_channels, eps=1e-5, device=device)
        self.reduction = Linear(4 * in_channels, out_channels, bias=False,
                                dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = adaptive_padding(x, kernel=2, stride=2)
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, H // 2, W // 2, 4 * C)
        return self.reduction(self.norm(x))
