"""Patch embedding (counterpart of `vitadapter/layers/patch_embed.py`): the
patchify conv, and `HybridEmbed`, a CNN stem's last map projected to the
embedding."""

from typing import Tuple

import torch
from torch import nn

from vitadapter_torch.layers.linear import Conv2d, Linear


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


class HybridEmbed(nn.Module):
    """CNN-stem patch embedding (reference det `base/beit.py:270`): run
    `backbone`, an NHWC module mapping (B, H, W, 3) to (B, Hp, Wp, C) or to
    a list whose last entry is that map, flatten the map and project it to
    `embed_dim` (`proj`). C is read off one forward of a zero (1, img_size,
    img_size, 3) image on the backbone's device, as the reference probes
    it."""

    def __init__(self, backbone: nn.Module, embed_dim: int = 768,
                 img_size: int = 224, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.backbone = backbone
        p = next(backbone.parameters(), None)
        probe = torch.zeros(1, img_size, img_size, 3,
                            device=None if p is None else p.device)
        with torch.no_grad():
            feature_dim = self.last_map(probe).shape[-1]
        self.proj = Linear(feature_dim, embed_dim, dtype=dtype,
                           device=device)

    def last_map(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(x)
        return feats[-1] if isinstance(feats, (list, tuple)) else feats

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """x: (B, H, W, 3) image -> (tokens (B, Hp*Wp, D), Hp, Wp)."""
        f = self.last_map(x)
        B, Hp, Wp, C = f.shape
        return self.proj(f.reshape(B, Hp * Wp, C)), Hp, Wp
