"""Adapter-free baseline backbones (counterpart of
`vitadapter/models/baselines.py`): `SimpleFeaturePyramid`, `ViTBaseline`
and `BEiTBaseline`, each returning the 4-scale NHWC pyramid (strides
4/8/16/32, `embed_dim` channels) that `ViTAdapter` returns.

As `ViTAdapter`, the baselines subclass their trunk, so the trunk's keys
are the reference's (`blocks.N...`, `pos_embed` or `cls_token`,
`patch_embed.proj`); the pyramid's are `pyramid.<flax name>`, with the
flax modules' numbered names as lists (`out_conv1.N`, ...).
"""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vitadapter_torch.layers.linear import Conv2d, ConvTranspose2d, conv_nhwc
from vitadapter_torch.layers.mlp import gelu
from vitadapter_torch.layers.norm import LayerNorm2d
from vitadapter_torch.models.beit import BEiT
from vitadapter_torch.models.vit import TIMMVisionTransformer


class SimpleFeaturePyramid(nn.Module):
    """A 16-stride NHWC map (or one map a scale) -> strides 4/8/16/32:
    two 2x2 transposed convs with a LayerNorm2d and GELU between, one, the
    identity and a 2x2 max pool; then per scale a 1x1 conv, LayerNorm2d, a
    3x3 conv and LayerNorm2d."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.up4_a = ConvTranspose2d(dim, dim, 2, stride=2, **kw)
        self.up4_norm = LayerNorm2d(dim, device=device)
        self.up4_b = ConvTranspose2d(dim, dim, 2, stride=2, **kw)
        self.up8 = ConvTranspose2d(dim, dim, 2, stride=2, **kw)
        self.out_conv1 = nn.ModuleList([
            Conv2d(dim, dim, 1, bias=False, **kw) for _ in range(4)])
        self.out_norm1 = nn.ModuleList([
            LayerNorm2d(dim, device=device) for _ in range(4)])
        self.out_conv2 = nn.ModuleList([
            Conv2d(dim, dim, 3, padding=1, bias=False, **kw)
            for _ in range(4)])
        self.out_norm2 = nn.ModuleList([
            LayerNorm2d(dim, device=device) for _ in range(4)])

    def forward(self, x):
        xs = x if isinstance(x, (list, tuple)) else [x] * 4
        f4 = gelu(self.up4_norm(conv_nhwc(self.up4_a, xs[0])))
        f4 = conv_nhwc(self.up4_b, f4)
        f8 = conv_nhwc(self.up8, xs[1])
        f16 = xs[2]
        f32 = F.max_pool2d(xs[3].permute(0, 3, 1, 2), 2, 2).permute(
            0, 2, 3, 1)
        outs = []
        for i, f in enumerate((f4, f8, f16, f32)):
            y = self.out_norm1[i](conv_nhwc(self.out_conv1[i], f))
            outs.append(self.out_norm2[i](conv_nhwc(self.out_conv2[i], y)))
        return outs


class ViTBaseline(TIMMVisionTransformer):
    """Plain ViT + simple pyramid (reference `vit_baseline.py`)."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 drop_path_rate: float = 0.0, layer_scale: bool = True,
                 window_attn=False, window_size=14, pretrain_size: int = 224,
                 with_cp: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__(patch_size=patch_size, embed_dim=embed_dim,
                         depth=depth, num_heads=num_heads,
                         drop_path_rate=drop_path_rate,
                         layer_scale=layer_scale, pretrain_size=pretrain_size,
                         with_cp=with_cp, window_attn=window_attn,
                         window_size=window_size, dtype=dtype, device=device)
        self.pyramid = SimpleFeaturePyramid(embed_dim, dtype=dtype,
                                            device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        B = x.shape[0]
        t, H, W = self.embed(x)
        t = self.run_blocks(t, H, W, 0, len(self.blocks), generator)
        return self.pyramid(t.reshape(B, H, W, -1))


class BEiTBaseline(BEiT):
    """BEiT + simple pyramid (reference `beit_baseline.py`). The cls token
    rides along every block; `out_indices` (mmseg's `[7, 11, 15, 23]` in
    `upernet_beit_large_512_*`) names the block whose output feeds each
    scale, None all four from the last block."""

    def __init__(self, img_size: int = 512, patch_size: int = 16,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 init_values: float = 1e-6, drop_path_rate: float = 0.0,
                 use_rel_pos_bias: bool = True,
                 out_indices: Optional[Sequence[int]] = None,
                 with_cp: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__(img_size=img_size, patch_size=patch_size,
                         embed_dim=embed_dim, depth=depth,
                         num_heads=num_heads, init_values=init_values,
                         drop_path_rate=drop_path_rate,
                         use_rel_pos_bias=use_rel_pos_bias, with_cp=with_cp,
                         dtype=dtype, device=device)
        self.out_indices = (None if out_indices is None
                            else tuple(out_indices))
        self.pyramid = SimpleFeaturePyramid(embed_dim, dtype=dtype,
                                            device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        B = x.shape[0]
        t, H, W = self.embed(x)
        cls = self.cls_token.to(t.dtype).expand(B, -1, -1)
        t = torch.cat([cls, t], dim=1)
        if self.out_indices is None:
            t = self.run_blocks(t, H, W, 0, len(self.blocks), generator)
            return self.pyramid(t[:, 1:].reshape(B, H, W, -1))
        taps, start = [], 0
        for idx in self.out_indices:
            t = self.run_blocks(t, H, W, start, idx + 1, generator)
            start = idx + 1
            taps.append(t[:, 1:].reshape(B, H, W, -1))
        return self.pyramid(taps)
