"""Patch embedding (counterpart of `vitadapter/layers/patch_embed.py`)."""

from typing import Tuple

import torch
from torch import nn

from vitadapter_torch.layers.linear import Conv2d


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int = 16, in_chans: int = 3,
                 embed_dim: int = 768, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=patch_size,
                           dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """x: (B, H, W, C) image -> (tokens (B, N, D), Hp, Wp)."""
        y = self.proj(x.permute(0, 3, 1, 2))            # (B, D, Hp, Wp)
        B, D, Hp, Wp = y.shape
        return y.permute(0, 2, 3, 1).reshape(B, Hp * Wp, D), Hp, Wp
