"""BEiT trunk (counterpart of `vitadapter/models/beit.py`, the segmentation
variant): a qkv projection without bias plus separate q and v biases,
per-block relative-position bias tables over the full patch grid with three
cls buckets, layer scale `gamma_1`/`gamma_2`, and a cls token riding along
every block. `embed()` / `run_blocks()` let the adapter interleave its
interactions between block spans. Parameter names are the reference's
(`cls_token`, `patch_embed.proj`, `blocks.N.attn.relative_position_bias_table`,
`blocks.N.gamma_1`, ...).

The attention carries a bias, so it runs as plain PyTorch (the fused
attention kernel takes none, as the JAX package's Pallas kernel takes
none). With `with_cp` each block is recomputed in the backward
(`layers/drop.py::checkpointed`, as `nn.remat` wraps the JAX block);
DropPath's draws are replayed there from the generator's saved state.
"""

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from vitadapter_torch.layers.drop import DropPath, checkpointed
from vitadapter_torch.layers.linear import Linear
from vitadapter_torch.layers.mlp import Mlp
from vitadapter_torch.layers.norm import LayerNorm
from vitadapter_torch.layers.patch_embed import PatchEmbed

# the port has BEiT as every config of `configs/` sets it for segmentation:
# q/v biases, relative-position tables with cls buckets, no absolute pos
# embed, global attention, a cls token, layer scale
NOT_PORTED = ("BEiT is ported as the segmentation configs set it (q/v "
              "biases, relative-position bias, no absolute pos embed, "
              "global attention with a cls token); the detection variant "
              "(windowed attention, no cls token, a hybrid stem, version "
              "'new') is not ported yet: ROADMAP.md §1 item 4")


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
    bias cat(q_bias, 0, v_bias) added after it, and the relative-position
    bias gathered from `relative_position_bias_table` ((nrd, heads), 3 cls
    buckets) for the (gh, gw) patch grid plus the cls token."""

    def __init__(self, dim: int, num_heads: int, rel_pos_grid: Tuple[int, int],
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim, bias=False, dtype=dtype,
                          device=device)
        self.q_bias = nn.Parameter(torch.zeros(dim, device=device))
        self.v_bias = nn.Parameter(torch.zeros(dim, device=device))
        self.rel_pos_grid = gh, gw = rel_pos_grid
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * gh - 1) * (2 * gw - 1) + 3, num_heads,
                        device=device))
        n = gh * gw + 1
        # recomputed, not loaded: `init_weights` fills it
        self.register_buffer("relative_position_index",
                             torch.zeros(n * n, dtype=torch.long,
                                         device=device), persistent=False)
        self.proj = Linear(dim, dim, dtype=dtype, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.q_bias.zero_()
        self.v_bias.zero_()
        self.relative_position_bias_table.zero_()
        idx = relative_position_index(*self.rel_pos_grid, with_cls=True)
        self.relative_position_index.copy_(torch.from_numpy(idx.reshape(-1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        h = self.num_heads
        Dh = C // h
        gh, gw = self.rel_pos_grid
        if N != gh * gw + 1:
            # as in the JAX package and the reference, whose ms test
            # pipelines resize every image's short side to at least the
            # crop (SETR_Resize) so that no crop is smaller
            raise ValueError(
                f"BEiT's relative-position tables span a {gh}x{gw} patch "
                f"grid (img_size / patch_size); this input has {N - 1} "
                f"patches: crops must be img_size square (ROADMAP.md §3)")
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias])
        qkv = self.qkv(x)
        qkv = qkv + bias.to(qkv.dtype)
        q, k, v = qkv.reshape(B, N, 3, h, Dh).permute(2, 0, 3, 1, 4)
        # fp32 logits, the fp32 bias added, then stored in the compute
        # dtype; fp32 softmax (the JAX module's order)
        logits = torch.matmul((q * Dh ** -0.5).float(),
                              k.float().transpose(-1, -2))
        rel = self.relative_position_bias_table[
            self.relative_position_index].reshape(N, N, h)
        logits = (logits + rel.permute(2, 0, 1)[None]).to(v.dtype)
        w = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        out = torch.matmul(w, v)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class BEiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, rel_pos_grid: Tuple[int, int],
                 mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 init_values: float = 1e-6,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6, device=device)
        self.attn = BEiTAttention(dim, num_heads, rel_pos_grid, dtype=dtype,
                                  device=device)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=1e-6, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype, device=device)
        self.init_values = init_values
        self.gamma_1 = nn.Parameter(torch.zeros(dim, device=device))
        self.gamma_2 = nn.Parameter(torch.zeros(dim, device=device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.gamma_1.fill_(self.init_values)
        self.gamma_2.fill_(self.init_values)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.drop_path(self.gamma_1 * self.attn(self.norm1(x)),
                               generator)
        return x + self.drop_path(self.gamma_2 * self.mlp(self.norm2(x)),
                                  generator)


class BEiT(nn.Module):
    """BEiT trunk with `embed()` / `run_blocks()` for adapter interleaving;
    the relative-position tables span the `img_size // patch_size` grid.
    The flags of the JAX module that the configs set are taken, and must
    have the one value every config gives them (`NOT_PORTED`)."""

    def __init__(self, img_size: int = 512, patch_size: int = 16,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, init_values: float = 1e-6,
                 drop_path_rate: float = 0.0, with_cp: bool = False,
                 qkv_bias: bool = True, use_abs_pos_emb: bool = False,
                 use_rel_pos_bias: bool = True, window_attn=False,
                 window_size=14, use_cls_token: bool = True,
                 hybrid_backbone=None,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        windowed = (any(window_attn) if isinstance(window_attn, (list, tuple))
                    else bool(window_attn))
        if (not qkv_bias or use_abs_pos_emb or not use_rel_pos_bias
                or windowed or not use_cls_token
                or hybrid_backbone is not None):
            raise NotImplementedError(NOT_PORTED)
        self.embed_dim = embed_dim
        self.with_cp = with_cp
        grid = img_size // patch_size
        dpr = np.linspace(0, drop_path_rate, depth)
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim, dtype=dtype,
                                      device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim,
                                                  device=device))
        self.blocks = nn.ModuleList([
            BEiTBlock(embed_dim, num_heads, (grid, grid), mlp_ratio,
                      drop_path=float(dpr[i]), init_values=init_values,
                      dtype=dtype, device=device)
            for i in range(depth)])

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.cls_token.normal_(0.0, 0.02, generator=generator)

    def embed(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """Patchify: (B, H*W, C) tokens, no cls token."""
        return self.patch_embed(x)

    def run_blocks(self, x: torch.Tensor, start: int, end: int,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """Blocks [start, end) on (B, 1 + H*W, C) tokens, cls first; each
        block is checkpointed under `with_cp` when a gradient is taken."""
        cp = self.with_cp and self.training and torch.is_grad_enabled()
        for blk in self.blocks[start:end]:
            x = checkpointed(blk, x, generator) if cp else blk(x, generator)
        return x

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        tokens, _, _ = self.embed(x)
        cls = self.cls_token.to(tokens.dtype).expand(tokens.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        return self.run_blocks(tokens, 0, len(self.blocks), generator)
