"""Uni-Perceiver multimodal trunk (counterpart of
`vitadapter/models/uniperceiver.py`): `JointAttention`,
`MultiModelBertLayer`, the visual and text embeddings,
`UnifiedBertEncoder` with `run_layers`, and `GroundingCrossAttention`.

Image tokens and text tokens attend jointly, globally or in windows with the
text copied into every window and its outputs averaged back; the text keys
are masked where the text is padding (logit `NEG_INF`). These attentions
are plain tensor ops, as they are plain einsums in the JAX package: fp32
logits, rounded to the value's dtype, an fp32 softmax. Parameter names are
the reference's (`layers.{i}.self_attn.in_proj`, `linear1`,
`visual_embed.patch_embed.*`, `token_embed.embeddings_pos.
position_embeddings`, `cross_attn.{g}.attn.kv`, ...), which the JAX
package's `convert_uniperceiver_backbone` reads. Under `with_cp` each layer
is recomputed in the backward (`layers/drop.py::checkpointed`, as `nn.remat`
wraps the JAX layer).
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vitadapter_torch.layers.attention import window_partition, window_reverse
from vitadapter_torch.layers.drop import DropPath, checkpointed
from vitadapter_torch.layers.linear import Conv2d, Linear
from vitadapter_torch.layers.mlp import Mlp, gelu
from vitadapter_torch.layers.norm import LayerNorm
from vitadapter_torch.models.vit import per_block, resample_abs_pos_embed

NEG_INF = -1e9


def masked_softmax_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float,
                          key_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, h, Nq, Dh) x (B, h, Nk, Dh) -> (B, h, Nq, Dh): logits of q *
    scale against k, masked to `NEG_INF` where key_mask (B, Nk) is False,
    rounded to v's dtype, an fp32 softmax in v's dtype, the weighted sum of
    v (the JAX modules' einsums)."""
    logits = torch.matmul(q * scale, k.transpose(-1, -2)).float()
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], NEG_INF)
    logits = logits.to(v.dtype)
    w = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    return torch.matmul(w, v)


class JointAttention(nn.Module):
    """Self-attention over [image; text], text keys masked by `q_mask`."""

    def __init__(self, dim: int, num_heads: int = 12, windowed: bool = False,
                 window_size: int = 14, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.windowed = windowed
        self.window_size = window_size
        self.in_proj = Linear(dim, 3 * dim, dtype=dtype, device=device)
        self.out_proj = Linear(dim, dim, dtype=dtype, device=device)

    def _attend(self, tokens: torch.Tensor,
                key_mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, n, C = tokens.shape
        h = self.num_heads
        Dh = C // h
        qkv = self.in_proj(tokens).reshape(b, n, 3, h, Dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = masked_softmax_attend(q, k, v, Dh ** -0.5, key_mask)
        return out.transpose(1, 2).reshape(b, n, C)

    def forward(self, x: torch.Tensor, q: torch.Tensor,
                q_mask: Optional[torch.Tensor], H: int, W: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, H*W, C) image tokens, q (B, Nq, C) text tokens, q_mask
        (B, Nq) nonzero where the text is real -> (image, text) outputs."""
        B, N, C = x.shape
        Nq = q.shape[1]
        if not self.windowed:
            key_mask = None
            if q_mask is not None:
                key_mask = torch.cat([torch.ones((B, N), dtype=torch.bool,
                                                 device=x.device),
                                      q_mask.bool()], dim=1)
            out = self.out_proj(self._attend(torch.cat([x, q], 1), key_mask))
            return out[:, :N], out[:, N:]

        # the image tokens, zero padded to a window multiple (padded tokens
        # are keys like the others), each window with a copy of the text
        ws = self.window_size
        Hp, Wp = math.ceil(H / ws) * ws, math.ceil(W / ws) * ws
        xm = F.pad(x.reshape(B, H, W, C), (0, 0, 0, Wp - W, 0, Hp - H))
        wnd = window_partition(xm, ws)                   # (B, L, ws*ws, C)
        L, Nw = wnd.shape[1], ws * ws
        qx = q[:, None].expand(B, L, Nq, C)
        tokens = torch.cat([wnd, qx], 2).reshape(B * L, Nw + Nq, C)
        key_mask = None
        if q_mask is not None:
            key_mask = torch.cat([torch.ones((B, Nw), dtype=torch.bool,
                                             device=x.device),
                                  q_mask.bool()], dim=1)
            key_mask = key_mask[:, None].expand(B, L, Nw + Nq).reshape(
                B * L, -1)
        out = self._attend(tokens, key_mask).reshape(B, L, Nw + Nq, C)
        img = window_reverse(out[:, :, :Nw], ws, Hp, Wp)[:, :H, :W]
        img = self.out_proj(img.reshape(B, N, C))
        txt = self.out_proj(out[:, :, Nw:].mean(dim=1))  # mean over windows
        return img, txt


class MultiModelBertLayer(nn.Module):
    """Pre-norm joint layer: one `norm1`, `norm2` and FFN (`linear1`,
    `linear2`) shared by both modalities, zero-initialized `gamma_1` /
    `gamma_2` residual scales, DropPath on each residual."""

    def __init__(self, dim: int, num_heads: int = 12, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, windowed: bool = False,
                 window_size: int = 14, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = LayerNorm(dim, eps=1e-5, device=device)
        self.norm2 = LayerNorm(dim, eps=1e-5, device=device)
        self.self_attn = JointAttention(dim, num_heads, windowed, window_size,
                                        **kw)
        self.linear1 = Linear(dim, int(dim * mlp_ratio), **kw)
        self.linear2 = Linear(int(dim * mlp_ratio), dim, **kw)
        self.gamma_1 = nn.Parameter(torch.zeros(dim, device=device))
        self.gamma_2 = nn.Parameter(torch.zeros(dim, device=device))
        self.drop_path = DropPath(drop_path)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.gamma_1.zero_()
        self.gamma_2.zero_()

    def forward(self, x, q, q_mask, H: int, W: int,
                generator: Optional[torch.Generator] = None):
        x_, q_ = self.self_attn(self.norm1(x), self.norm1(q), q_mask, H, W)
        x = x + self.drop_path(self.gamma_1 * x_, generator)
        q = q + self.drop_path(self.gamma_1 * q_, generator)
        x_ = self.linear2(gelu(self.linear1(self.norm2(x))))
        q_ = self.linear2(gelu(self.linear1(self.norm2(q))))
        x = x + self.drop_path(self.gamma_2 * x_, generator)
        q = q + self.drop_path(self.gamma_2 * q_, generator)
        return x, q


class _PatchEmbed(nn.Module):
    """The reference's `visual_embed.patch_embed`: the patchify conv and the
    spatial and temporal position tables."""

    def __init__(self, embed_dim: int, patch_size: int, grid: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.proj = Conv2d(3, embed_dim, patch_size, stride=patch_size,
                           dtype=dtype, device=device)
        self.spatial_pos_embed = nn.Embedding(grid * grid, embed_dim,
                                              device=device)
        self.temporal_pos_embed = nn.Embedding(8, embed_dim, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for e in (self.spatial_pos_embed, self.temporal_pos_embed):
            e.weight.normal_(0.0, 0.02, generator=generator)


class VisualPatchEmbedding(nn.Module):
    """Conv patchify + the bicubic-resampled spatial position table +
    temporal slot 0, then LayerNorm."""

    def __init__(self, embed_dim: int = 768, patch_size: int = 16,
                 pretrain_size: int = 224, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.grid = pretrain_size // patch_size
        self.patch_embed = _PatchEmbed(embed_dim, patch_size, self.grid,
                                       dtype, device)
        self.embeddings_norm = LayerNorm(embed_dim, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """x (B, H, W, 3) -> (tokens (B, H/p * W/p, C) fp32, H/p, W/p)."""
        pe = self.patch_embed
        y = pe.proj(x.permute(0, 3, 1, 2))
        B, C, H, W = y.shape
        y = y.permute(0, 2, 3, 1).reshape(B, H * W, C)
        g = self.grid
        pos = resample_abs_pos_embed(pe.spatial_pos_embed.weight[None].float(),
                                     (g, g), (H, W))
        y = y + pos.to(y.dtype) + pe.temporal_pos_embed.weight[0].to(y.dtype)
        return self.embeddings_norm(y), H, W


class _PositionTable(nn.Module):
    """The reference's `embeddings_pos` holder."""

    def __init__(self, max_len: int, dim: int, device=None):
        super().__init__()
        self.position_embeddings = nn.Embedding(max_len, dim, device=device)


class TokenBaseEmbedding(nn.Module):
    """Token embedding (CLIP BPE ids + specials) + learned positions +
    token type 0, then LayerNorm."""

    def __init__(self, vocab_size: int = 49411, embed_dim: int = 768,
                 max_len: int = 512, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.embeddings = nn.Embedding(vocab_size, embed_dim, device=device)
        self.embeddings_pos = _PositionTable(max_len, embed_dim, device)
        self.embeddings_token_type = nn.Embedding(2, embed_dim,
                                                  device=device)
        self.embeddings_norm = LayerNorm(embed_dim, eps=1e-5, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for e in (self.embeddings, self.embeddings_pos.position_embeddings,
                  self.embeddings_token_type):
            e.weight.normal_(0.0, 0.02, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        n = ids.shape[1]
        emb = self.embeddings(ids.long()).to(dt)
        emb = (emb + self.embeddings_pos.position_embeddings.weight[:n].to(dt)
               + self.embeddings_token_type.weight[0].to(dt))
        return self.embeddings_norm(emb)


class UnifiedBertEncoder(nn.Module):
    """The Uni-Perceiver trunk; `visual_embed`, `token_embed` and
    `run_layers` let the adapter interleave its interactions. Layer i
    attends in windows of `window_size[i]` (None meaning 14) where
    `window_attn[i]`; each option is a value or a list by depth."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, window_attn=False,
                 window_size=14, pretrain_size: int = 224,
                 vocab_size: int = 49411, with_cp: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.depth = depth
        self.with_cp = with_cp
        windowed = per_block(window_attn, depth)
        sizes = per_block(window_size, depth)
        dpr = np.linspace(0, drop_path_rate, depth)
        self.layers = nn.ModuleList([
            MultiModelBertLayer(embed_dim, num_heads, mlp_ratio,
                                drop_path=float(dpr[i]),
                                windowed=bool(windowed[i]),
                                window_size=int(sizes[i] or 14), dtype=dtype,
                                device=device)
            for i in range(depth)])
        self.visual_embed = VisualPatchEmbedding(embed_dim, patch_size,
                                                 pretrain_size, dtype, device)
        self.token_embed = TokenBaseEmbedding(vocab_size, embed_dim,
                                              dtype=dtype, device=device)

    def run_layers(self, x, q, q_mask, H: int, W: int, start: int, end: int,
                   generator: Optional[torch.Generator] = None):
        """Layers [start, end); each is checkpointed under `with_cp` when a
        gradient is taken."""
        cp = self.with_cp and self.training and torch.is_grad_enabled()
        for layer in self.layers[start:end]:
            x, q = (checkpointed(layer, x, generator, q, q_mask, H, W) if cp
                    else layer(x, q, q_mask, H, W, generator))
        return x, q

    def forward(self, img: torch.Tensor, question: torch.Tensor,
                q_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x, H, W = self.visual_embed(img)
        q = self.token_embed(question)
        return self.run_layers(x, q, q_mask, H, W, 0, self.depth, generator)


class _CrossProjections(nn.Module):
    """The reference's `attn` of a grounding block: `q`, the fused `kv`
    (k rows first) and `proj`."""

    def __init__(self, dim: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.q = Linear(dim, dim, dtype=dtype, device=device)
        self.kv = Linear(dim, 2 * dim, dtype=dtype, device=device)
        self.proj = Linear(dim, dim, dtype=dtype, device=device)


class GroundingCrossAttention(nn.Module):
    """Image -> text cross-attention block (reference
    `grounding_block.py:7-67`): ONE `norm1` on both inputs, queries from the
    image tokens, keys and values from the text, then an MLP after
    `norm2`."""

    def __init__(self, dim: int, num_heads: int = 12, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = LayerNorm(dim, eps=1e-5, device=device)
        self.attn = _CrossProjections(dim, dtype, device)
        self.norm2 = LayerNorm(dim, eps=1e-5, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, text: torch.Tensor,
                text_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, C = x.shape
        M = text.shape[1]
        h = self.num_heads
        Dh = C // h
        tk = self.norm1(text)
        qp = self.attn.q(self.norm1(x)).reshape(B, N, h, Dh).transpose(1, 2)
        kv = self.attn.kv(tk).reshape(B, M, 2, h, Dh)
        kp, vp = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        att = masked_softmax_attend(
            qp, kp, vp, Dh ** -0.5,
            None if text_mask is None else text_mask.bool())
        x = x + self.attn.proj(att.transpose(1, 2).reshape(B, N, C))
        return x + self.mlp(self.norm2(x))

