"""Plain ViT trunk (counterpart of `vitadapter/models/vit.py`): the global
`Block` with layer scale, `resample_abs_pos_embed` and
`TIMMVisionTransformer` with `embed()` / `run_blocks()`. Windowed attention
and `ResBottleneckBlock` are not ported yet (`NOT_PORTED`). In training mode
the blocks' DropPath draws from the `generator` passed down (JAX's
"dropout" rng). With `with_cp` each block is recomputed in the backward
(`layers/drop.py::checkpointed`, as `nn.remat` wraps the JAX block).
"""

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from vitadapter_torch.layers.attention import Attention
from vitadapter_torch.layers.drop import DropPath, checkpointed
from vitadapter_torch.layers.mlp import Mlp
from vitadapter_torch.layers.norm import LayerNorm
from vitadapter_torch.layers.patch_embed import PatchEmbed
from vitadapter_torch.utils.resize import resize_2d

NOT_PORTED = ("the ViT trunk is ported with global attention in every "
              "block; windowed attention (`window_attn`, `window_size`) and "
              "the residual bottleneck blocks (`residual_indices`) are not "
              "ported yet: ROADMAP.md §1 item 4")


def refuse_windows(window_attn, residual_indices) -> None:
    """Raise `NotImplementedError` naming ROADMAP.md's item for the ViT
    options the port lacks."""
    windowed = (any(window_attn) if isinstance(window_attn, (list, tuple))
                else bool(window_attn))
    if windowed or tuple(residual_indices or ()):
        raise NotImplementedError(NOT_PORTED)


class Block(nn.Module):
    """Pre-norm transformer block with optional layer scale."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop_path: float = 0.0,
                 layer_scale: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6, device=device)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias, dtype=dtype,
                              device=device)
        self.norm2 = LayerNorm(dim, eps=1e-6, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype, device=device)
        self.drop_path = DropPath(drop_path)
        self.layer_scale = layer_scale
        if layer_scale:
            self.gamma1 = nn.Parameter(torch.ones(dim, device=device))
            self.gamma2 = nn.Parameter(torch.ones(dim, device=device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        if self.layer_scale:
            self.gamma1.fill_(1.0)
            self.gamma2.fill_(1.0)

    def forward(self, x: torch.Tensor, H: int, W: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        a = self.attn(self.norm1(x), H, W)
        if self.layer_scale:
            a = self.gamma1 * a
        x = x + self.drop_path(a, generator)
        m = self.mlp(self.norm2(x))
        if self.layer_scale:
            m = self.gamma2 * m
        return x + self.drop_path(m, generator)


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
    `window_size` is taken, and only global attention is ported
    (`NOT_PORTED`)."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0,
                 layer_scale: bool = True, pretrain_size: int = 224,
                 with_cp: bool = False, window_attn=False, window_size=14,
                 residual_indices=(), dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        refuse_windows(window_attn, residual_indices)
        self.embed_dim = embed_dim
        self.with_cp = with_cp
        self.patch_size = patch_size
        self.pretrain_size = pretrain_size
        dpr = np.linspace(0, drop_path_rate, depth)
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim, dtype=dtype,
                                      device=device)
        grid = pretrain_size // patch_size
        self.pos_embed = nn.Parameter(
            torch.zeros(1, grid * grid + 1, embed_dim, device=device))
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias=qkv_bias,
                  drop_path=float(dpr[i]), layer_scale=layer_scale,
                  dtype=dtype, device=device)
            for i in range(depth)])

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.pos_embed.normal_(0.0, 0.02, generator=generator)

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
