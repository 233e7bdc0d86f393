"""BEiT trunk (counterpart of `vitadapter/models/beit.py`): a qkv
projection without bias plus separate q and v biases (`qkv_bias`),
per-block relative-position bias tables (`use_rel_pos_bias`), layer scale
`gamma_1`/`gamma_2`, an optional absolute position embedding over the
`pretrain_size` grid, bicubic-resampled to each input (`use_abs_pos_emb`),
the patchify conv or a CNN stem (`hybrid_backbone`,
`layers/patch_embed.py::HybridEmbed`), and `embed()` / `run_blocks()` to
let the adapter interleave its interactions between block spans. Parameter
names are the reference's (`cls_token`, `pos_embed`, `patch_embed.proj`,
`blocks.N.attn.relative_position_bias_table`, `blocks.N.gamma_1`, ...).

The segmentation variant carries a cls token along every block, and its
tables span the `img_size // patch_size` grid with three cls buckets. The
detection variant (reference det `base/beit.py`) sets `use_cls_token=False`
and per-depth `window_attn` / `window_size`: a windowed block pads the
token grid at the bottom and right to a window multiple and attends inside
each window, its table spanning the window; a global block's table spans
the `img_size // patch_size` grid; neither has cls buckets.

The attention carries a bias, so it runs as plain PyTorch (the fused
attention kernel takes none, as the JAX package's Pallas kernel takes
none). With `with_cp` each block is recomputed in the backward
(`layers/drop.py::checkpointed`, as `nn.remat` wraps the JAX block);
DropPath's draws are replayed there from the generator's saved state.
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from port_bench.reference.layers.attention import (window_partition,
                                                  window_reverse)
from port_bench.reference.layers.drop import DropPath, checkpointed
from port_bench.reference.layers.linear import Linear
from port_bench.reference.layers.mlp import Mlp
from port_bench.reference.layers.norm import LayerNorm
from port_bench.reference.layers.patch_embed import HybridEmbed, PatchEmbed
from port_bench.reference.models.vit import per_block, resample_abs_pos_embed


def relative_position_index(wh: int, ww: int, with_cls: bool) -> np.ndarray:
    """Pairwise relative-position bucket ids over a (wh, ww) grid.

    With cls: (wh*ww+1, wh*ww+1) ids into a table of (2wh-1)(2ww-1)+3 buckets
    (reference seg `base/beit.py:88-103`); without: (wh*ww, wh*ww) ids into
    (2wh-1)(2ww-1) buckets (det variant).
    """
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing="ij"))  # (2, wh, ww)
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, N, N)
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    idx = rel.sum(-1)  # (N, N)
    if not with_cls:
        return idx
    nrd = (2 * wh - 1) * (2 * ww - 1) + 3
    out = np.zeros((idx.shape[0] + 1, idx.shape[1] + 1), np.int64)
    out[1:, 1:] = idx
    out[0, :] = nrd - 3
    out[:, 0] = nrd - 2
    out[0, 0] = nrd - 1
    return out


class BEiTAttention(nn.Module):
    """BEiT MHSA over (B, N, C) tokens: a qkv projection without bias, the
    bias cat(q_bias, 0, v_bias) added after it (`qkv_bias`), and the
    relative-position bias gathered from `relative_position_bias_table` for
    the (gh, gw) grid it spans (plus 3 cls buckets `with_cls`; none where
    `rel_pos_grid` is None). A `windowed` block zero-pads the (H, W) token
    grid at the bottom and right to a multiple of `window_size` before the
    projection (the padded tokens get the biases, as in the JAX module) and
    attends inside each window; its grid is the window."""

    def __init__(self, dim: int, num_heads: int,
                 rel_pos_grid: Optional[Tuple[int, int]],
                 with_cls: bool = True, windowed: bool = False,
                 window_size: int = 14, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.with_cls = with_cls
        self.windowed = windowed
        self.window_size = window_size
        self.qkv_bias = qkv_bias
        self.qkv = Linear(dim, 3 * dim, bias=False, dtype=dtype,
                          device=device)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(dim, device=device))
            self.v_bias = nn.Parameter(torch.zeros(dim, device=device))
        self.rel_pos_grid = rel_pos_grid
        if rel_pos_grid is not None:
            gh, gw = rel_pos_grid
            extra = 3 if with_cls else 0
            self.relative_position_bias_table = nn.Parameter(
                torch.zeros((2 * gh - 1) * (2 * gw - 1) + extra, num_heads,
                            device=device))
            n = gh * gw + (1 if with_cls else 0)
            # recomputed, not loaded: `builder.build_model` fills it
            self.register_buffer("relative_position_index",
                                 torch.zeros(n * n, dtype=torch.long,
                                             device=device),
                                 persistent=False)
        self.proj = Linear(dim, dim, dtype=dtype, device=device)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Attention over (B, N, C) tokens, whose grid is the table's where
        there is one."""
        B, N, C = x.shape
        h = self.num_heads
        Dh = C // h
        if self.rel_pos_grid is not None:
            gh, gw = self.rel_pos_grid
            if N != gh * gw + self.with_cls:
                # as in the JAX package and the reference, whose ms test
                # pipelines resize every image's short side to at least the
                # crop (SETR_Resize) so that no crop is smaller
                raise ValueError(
                    f"BEiT's relative-position tables span a {gh}x{gw} "
                    f"patch grid (img_size / patch_size); this input has "
                    f"{N - self.with_cls} patches: crops must be img_size "
                    f"square (ROADMAP.md §3)")
        qkv = self.qkv(x)
        if self.qkv_bias:
            bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                              self.v_bias])
            qkv = qkv + bias.to(qkv.dtype)
        q, k, v = qkv.reshape(B, N, 3, h, Dh).permute(2, 0, 3, 1, 4)
        # fp32 logits, the fp32 bias added, then stored in the compute
        # dtype; fp32 softmax (the JAX module's order)
        logits = torch.matmul((q * Dh ** -0.5).float(),
                              k.float().transpose(-1, -2))
        if self.rel_pos_grid is not None:
            rel = self.relative_position_bias_table[
                self.relative_position_index].reshape(N, N, h)
            logits = logits + rel.permute(2, 0, 1)[None]
        logits = logits.to(v.dtype)
        w = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        out = torch.matmul(w, v)
        return out.transpose(1, 2).reshape(B, N, C)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        if not self.windowed:
            return self.proj(self.attend(x))
        B, N, C = x.shape
        ws = self.window_size
        Hp, Wp = math.ceil(H / ws) * ws, math.ceil(W / ws) * ws
        xm = F.pad(x.reshape(B, H, W, C), (0, 0, 0, Wp - W, 0, Hp - H))
        wnd = window_partition(xm, ws)                  # (B, L, ws*ws, C)
        L = wnd.shape[1]
        out = self.attend(wnd.reshape(B * L, ws * ws, C))
        out = window_reverse(out.reshape(B, L, ws * ws, C), ws, Hp, Wp)
        return self.proj(out[:, :H, :W].reshape(B, N, C))


class BEiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int,
                 rel_pos_grid: Optional[Tuple[int, int]],
                 mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 init_values: float = 1e-6, with_cls: bool = True,
                 windowed: bool = False, window_size: int = 14,
                 qkv_bias: bool = True, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6, device=device)
        self.attn = BEiTAttention(dim, num_heads, rel_pos_grid, with_cls,
                                  windowed, window_size, qkv_bias,
                                  dtype=dtype, device=device)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-6, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype, device=device)
        self.init_values = init_values
        self.gamma_1 = nn.Parameter(torch.zeros(dim, device=device))
        self.gamma_2 = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor, H: int, W: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.drop_path(self.gamma_1 * self.attn(self.norm1(x), H, W),
                               generator)
        return x + self.drop_path(self.gamma_2 * self.mlp(self.norm2(x)),
                                  generator)


class BEiT(nn.Module):
    """BEiT trunk with `embed()` / `run_blocks()` for adapter interleaving.
    Block i attends in windows of `window_size[i]` (None meaning 14) where
    `window_attn[i]`, each option a value or a list by depth; a windowed
    block's table spans its window, a global block's the `img_size //
    patch_size` grid (none without `use_rel_pos_bias`). With
    `use_cls_token` (the segmentation variant) the cls token rides along
    the blocks, which then must all be global. `use_abs_pos_emb` adds a
    (1, g*g, D) position embedding over the `pretrain_size // patch_size`
    grid g, resampled to the input's patch grid; `hybrid_backbone`, an
    NHWC CNN module, replaces the patchify conv (`HybridEmbed`)."""

    def __init__(self, img_size: int = 512, patch_size: int = 16,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, init_values: float = 1e-6,
                 drop_path_rate: float = 0.0, with_cp: bool = False,
                 qkv_bias: bool = True, use_abs_pos_emb: bool = False,
                 use_rel_pos_bias: bool = True, window_attn=False,
                 window_size=14, use_cls_token: bool = True,
                 hybrid_backbone: Optional[nn.Module] = None,
                 pretrain_size: int = 224,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        windowed = [bool(w) for w in per_block(window_attn, depth)]
        sizes = [int(s or 14) for s in per_block(window_size, depth)]
        if use_cls_token and any(windowed):
            # the JAX module's windowed blocks take no cls token
            raise ValueError("windowed BEiT blocks need use_cls_token=False")
        self.embed_dim = embed_dim
        self.with_cp = with_cp
        self.use_cls_token = use_cls_token
        self.use_abs_pos_emb = use_abs_pos_emb
        self.pos_grid = pretrain_size // patch_size
        grid = img_size // patch_size
        dpr = np.linspace(0, drop_path_rate, depth)
        if hybrid_backbone is not None:
            self.patch_embed = HybridEmbed(hybrid_backbone, embed_dim,
                                           img_size=img_size, dtype=dtype,
                                           device=device)
        else:
            self.patch_embed = PatchEmbed(patch_size, 3, embed_dim,
                                          dtype=dtype, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim,
                                                  device=device))
        if use_abs_pos_emb:
            self.pos_embed = nn.Parameter(torch.zeros(
                1, self.pos_grid ** 2, embed_dim, device=device))

        def rel_grid(i):
            if not use_rel_pos_bias:
                return None
            return (sizes[i], sizes[i]) if windowed[i] else (grid, grid)

        self.blocks = nn.ModuleList([
            BEiTBlock(embed_dim, num_heads, rel_grid(i), mlp_ratio,
                      drop_path=float(dpr[i]), init_values=init_values,
                      with_cls=use_cls_token and not windowed[i],
                      windowed=windowed[i], window_size=sizes[i],
                      qkv_bias=qkv_bias, dtype=dtype, device=device)
            for i in range(depth)])

    def embed(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """Patchify (and add the resampled position embedding): (B, H*W, C)
        tokens, no cls token."""
        tokens, H, W = self.patch_embed(x)
        if self.use_abs_pos_emb:
            g = self.pos_grid
            pe = resample_abs_pos_embed(self.pos_embed.float(), (g, g),
                                        (H, W))
            tokens = tokens + pe.to(tokens.dtype)
        return tokens, H, W

    def run_blocks(self, x: torch.Tensor, H: int, W: int, start: int,
                   end: int, generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """Blocks [start, end) on (B, H*W, C) tokens of an (H, W) grid, the
        cls token first under `use_cls_token`; each block is checkpointed
        under `with_cp` when a gradient is taken."""
        cp = self.with_cp and self.training and torch.is_grad_enabled()
        for blk in self.blocks[start:end]:
            x = (checkpointed(blk, x, generator, H, W) if cp
                 else blk(x, H, W, generator))
        return x

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        tokens, H, W = self.embed(x)
        if self.use_cls_token:
            cls = self.cls_token.to(tokens.dtype).expand(tokens.shape[0], -1,
                                                          -1)
            tokens = torch.cat([cls, tokens], dim=1)
        return self.run_blocks(tokens, H, W, 0, len(self.blocks), generator)
