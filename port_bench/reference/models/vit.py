"""Plain ViT trunk (counterpart of `vitadapter/models/vit.py`): the `Block`
with global or windowed attention and layer scale, `resample_abs_pos_embed`
and `TIMMVisionTransformer` with `embed()` / `run_blocks()`, windowing
chosen per block (`window_attn`, `window_size`, a value or a list by
depth), and the ViTDet `ResBottleneckBlock` after each block of
`residual_indices` (reference `base/vit.py:233-289`). In training mode
the blocks' DropPath draws from the `generator` passed down (JAX's
"dropout" rng). With `with_cp` each block is recomputed in the backward
(`layers/drop.py::checkpointed`, as `nn.remat` wraps the JAX block).
"""

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from port_bench.reference.layers.attention import Attention, WindowedAttention
from port_bench.reference.layers.drop import DropPath, checkpointed
from port_bench.reference.layers.linear import Conv2d, conv_nhwc
from port_bench.reference.layers.mlp import Mlp, gelu
from port_bench.reference.layers.norm import LayerNorm, LayerNorm2d
from port_bench.reference.layers.patch_embed import PatchEmbed
from port_bench.reference.utils.resize import resize_2d

def per_block(value, depth: int) -> list:
    """A per-depth option: a list or tuple as it is, a value repeated."""
    return (list(value) if isinstance(value, (list, tuple))
            else [value] * depth)


class ZeroLayerNorm2d(LayerNorm2d):
    """A `LayerNorm2d` whose weight and bias start at zero."""


class ResBottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 convs without bias on an NHWC map, each followed
    by a channel LayerNorm, GELU after the first two; the last norm starts
    at zero, so the block starts as the identity (reference
    `base/vit.py:233-289`). Returns x + the branch."""

    def __init__(self, dim: int, bottleneck: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.conv1 = Conv2d(dim, bottleneck, 1, **kw)
        self.norm1 = LayerNorm2d(bottleneck, device=device)
        self.conv2 = Conv2d(bottleneck, bottleneck, 3, padding=1, **kw)
        self.norm2 = LayerNorm2d(bottleneck, device=device)
        self.conv3 = Conv2d(bottleneck, dim, 1, **kw)
        self.norm3 = ZeroLayerNorm2d(dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = gelu(self.norm1(conv_nhwc(self.conv1, x)))
        out = gelu(self.norm2(conv_nhwc(self.conv2, out)))
        return x + self.norm3(conv_nhwc(self.conv3, out)).to(x.dtype)


class Block(nn.Module):
    """Pre-norm transformer block with optional windowing (`windowed`,
    `window_size`), layer scale and a residual bottleneck after it
    (`use_residual`)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop_path: float = 0.0,
                 layer_scale: bool = False, windowed: bool = False,
                 window_size: int = 14, use_residual: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6, device=device)
        if windowed:
            self.attn = WindowedAttention(dim, num_heads, qkv_bias=qkv_bias,
                                          window_size=window_size,
                                          dtype=dtype, device=device)
        else:
            self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias,
                                  dtype=dtype, device=device)
        self.norm2 = LayerNorm(dim, eps=1e-6, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype, device=device)
        self.drop_path = DropPath(drop_path)
        self.layer_scale = layer_scale
        if layer_scale:
            self.gamma1 = nn.Parameter(torch.ones(dim, device=device))
            self.gamma2 = nn.Parameter(torch.ones(dim, device=device))
        self.use_residual = use_residual
        if use_residual:
            self.residual = ResBottleneckBlock(dim, dim // 2, dtype=dtype,
                                               device=device)

    def forward(self, x: torch.Tensor, H: int, W: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        a = self.attn(self.norm1(x), H, W)
        if self.layer_scale:
            a = self.gamma1 * a
        x = x + self.drop_path(a, generator)
        m = self.mlp(self.norm2(x))
        if self.layer_scale:
            m = self.gamma2 * m
        x = x + self.drop_path(m, generator)
        if self.use_residual:
            B, N, C = x.shape
            x = self.residual(x.reshape(B, H, W, C)).reshape(B, N, C)
        return x


def resample_abs_pos_embed(pos_embed: torch.Tensor, grid_hw: Tuple[int, int],
                           target_hw: Tuple[int, int]) -> torch.Tensor:
    """Bicubic-resample a (1, gh*gw, D) pos embed to (1, H*W, D)."""
    (gh, gw), (H, W) = grid_hw, target_hw
    if (gh, gw) == (H, W):
        return pos_embed
    D = pos_embed.shape[-1]
    pe = resize_2d(pos_embed.reshape(gh, gw, D), (H, W), method="bicubic")
    return pe.reshape(1, H * W, D)


class TIMMVisionTransformer(nn.Module):
    """Plain ViT trunk. `embed()` (patch + pos) and `run_blocks()` let the
    adapter interleave injectors and extractors between block spans.
    Block i attends in windows of `window_size[i]` (None meaning 14) where
    `window_attn[i]`; each option is a value or a list by depth. A
    `ResBottleneckBlock` follows each block of `residual_indices`."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0,
                 layer_scale: bool = True, pretrain_size: int = 224,
                 with_cp: bool = False, window_attn=False, window_size=14,
                 residual_indices=(), dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        residual = set(residual_indices or ())
        self.embed_dim = embed_dim
        self.with_cp = with_cp
        self.patch_size = patch_size
        self.pretrain_size = pretrain_size
        dpr = np.linspace(0, drop_path_rate, depth)
        windowed = per_block(window_attn, depth)
        sizes = per_block(window_size, depth)
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim, dtype=dtype,
                                      device=device)
        grid = pretrain_size // patch_size
        self.pos_embed = nn.Parameter(
            torch.zeros(1, grid * grid + 1, embed_dim, device=device))
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias=qkv_bias,
                  drop_path=float(dpr[i]), layer_scale=layer_scale,
                  windowed=bool(windowed[i]),
                  window_size=int(sizes[i] or 14),
                  use_residual=i in residual, dtype=dtype, device=device)
            for i in range(depth)])

    def embed(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """Patchify + add the (resampled) pos embed, dropping the cls slot."""
        tokens, H, W = self.patch_embed(x)
        grid = self.pretrain_size // self.patch_size
        pe = resample_abs_pos_embed(self.pos_embed[:, 1:].float(),
                                    (grid, grid), (H, W))
        return tokens + pe.to(tokens.dtype), H, W

    def run_blocks(self, x: torch.Tensor, H: int, W: int, start: int,
                   end: int, generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """Blocks [start, end); each is checkpointed under `with_cp` when a
        gradient is taken."""
        cp = self.with_cp and self.training and torch.is_grad_enabled()
        for blk in self.blocks[start:end]:
            x = (checkpointed(blk, x, generator, H, W) if cp
                 else blk(x, H, W, generator))
        return x

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        tokens, H, W = self.embed(x)
        return self.run_blocks(tokens, H, W, 0, len(self.blocks), generator)
