"""Mask2Former head (counterpart of `vitadapter/heads/mask2former.py`): the
pixel decoder, the 9-layer post-norm masked-attention decoder with
level-cycled memories, per-layer prediction heads and `semantic_inference`.
Parameter names are the reference's (mmseg `Mask2FormerHead` with
mmcv/torch `nn.MultiheadAttention`).

At eval the attention masks come from the mask feature resized ONCE to the
three memory scales (the JAX package's eval formulation; resizing every
layer's full-resolution mask logits instead flips masks near the sigmoid-0.5
threshold), and only the last layer's full-resolution mask logits are
computed unless `all_masks=True`. In training mode every layer's
full-resolution mask logits feed the losses anyway, so the attention masks
are resized from them, as the JAX train forward does.
"""

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vitadapter_torch.heads.pixel_decoder import FFN, MSDeformAttnPixelDecoder
from vitadapter_torch.layers.linear import Linear
from vitadapter_torch.layers.norm import LayerNorm
from vitadapter_torch.layers.positional import sine_positional_encoding
from vitadapter_torch.utils.resize import resize_2d, resize_hw

NEG_INF = -1e9  # masked attention logit (fp32- and bf16-safe)


class _Projections(nn.Module):
    """`nn.MultiheadAttention`'s parameter layout: packed q/k/v rows in
    `in_proj_weight`/`in_proj_bias`, and `out_proj`."""

    def __init__(self, dim: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dim = dim
        self.compute_dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim,
                                                       device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim, device=device))
        self.out_proj = Linear(dim, dim, dtype=dtype, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.in_proj_weight.normal_(0.0, self.dim ** -0.5,
                                    generator=generator)
        self.in_proj_bias.zero_()

    def project(self, x: torch.Tensor, i: int) -> torch.Tensor:
        C, dt = self.dim, self.compute_dtype
        return F.linear(x.to(dt), self.in_proj_weight[i * C:(i + 1) * C].to(dt),
                        self.in_proj_bias[i * C:(i + 1) * C].to(dt))


class MultiheadAttention(nn.Module):
    """torch-style MHA with separate q/k/v inputs and an optional boolean
    mask (True = disallowed), as plain tensor ops: fp32 logits, rounded to
    the compute dtype, fp32 softmax (mirrors the JAX module)."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.attn = _Projections(dim, dtype, device)

    def forward(self, q, k, v, attn_mask: Optional[torch.Tensor] = None):
        B, Nq, C = q.shape
        Nk = k.shape[1]
        h = self.num_heads
        Dh = C // h
        qp = self.attn.project(q, 0).reshape(B, Nq, h, Dh).transpose(1, 2)
        kp = self.attn.project(k, 1).reshape(B, Nk, h, Dh).transpose(1, 2)
        vp = self.attn.project(v, 2).reshape(B, Nk, h, Dh).transpose(1, 2)
        logits = torch.matmul(qp.float(), kp.float().transpose(-1, -2)) \
            * (Dh ** -0.5)
        if attn_mask is not None:
            # (B, 1 or h, Nq, Nk) bool, True = masked out
            logits = logits.masked_fill(attn_mask, NEG_INF)
        logits = logits.to(vp.dtype)
        w = torch.softmax(logits.float(), dim=-1).to(vp.dtype)
        out = torch.matmul(w, vp).transpose(1, 2).reshape(B, Nq, C)
        return self.attn.out_proj(out)


class DecoderLayer(nn.Module):
    """Post-norm DETR decoder layer: cross -> LN -> self -> LN -> FFN -> LN."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.attentions = nn.ModuleList([MultiheadAttention(dim, num_heads,
                                                            **kw)
                                         for _ in range(2)])
        self.norms = nn.ModuleList([LayerNorm(dim, eps=1e-5, **kw)
                                    for _ in range(3)])
        self.ffns = nn.ModuleList([FFN(dim, ffn_dim, **kw)])

    def forward(self, query, query_pos, key, key_pos, attn_mask):
        x = query + self.attentions[0](query + query_pos, key + key_pos, key,
                                       attn_mask)
        x = self.norms[0](x)
        x = x + self.attentions[1](x + query_pos, x + query_pos, x, None)
        x = self.norms[1](x)
        return self.norms[2](x + self.ffns[0](x))


class TransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, dim: int, num_heads: int,
                 ffn_dim: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.layers = nn.ModuleList([
            DecoderLayer(dim, num_heads, ffn_dim, dtype=dtype, device=device)
            for _ in range(num_layers)])
        self.post_norm = LayerNorm(dim, eps=1e-5, device=device)


class Mask2FormerHead(nn.Module):
    def __init__(self, in_channels: Sequence[int], num_classes: int = 150,
                 num_queries: int = 100, feat_channels: int = 256,
                 out_channels: int = 256, num_transformer_feat_level: int = 3,
                 num_decoder_layers: int = 9, num_heads: int = 8,
                 decoder_ffn_dim: int = 2048,
                 pixel_encoder_ffn_dim: int = 1024,
                 pixel_encoder_heads: int = 8,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        C = feat_channels
        kw = dict(dtype=dtype, device=device)
        self.num_heads = num_heads
        self.num_levels = num_transformer_feat_level
        self.feat_channels = C
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            in_channels, feat_channels=C, out_channels=out_channels,
            num_encoder_levels=num_transformer_feat_level,
            num_heads=pixel_encoder_heads, ffn_dim=pixel_encoder_ffn_dim,
            num_feats=C // 2, **kw)
        self.query_embed = nn.Embedding(num_queries, C, device=device)
        self.query_feat = nn.Embedding(num_queries, C, device=device)
        self.level_embed = nn.Embedding(num_transformer_feat_level, C,
                                        device=device)
        self.transformer_decoder = TransformerDecoder(
            num_decoder_layers, C, num_heads, decoder_ffn_dim, **kw)
        # flax Dense without a dtype: fp32 params and fp32 input -> fp32
        self.cls_embed = Linear(C, num_classes + 1, device=device)
        self.mask_embed = nn.Sequential(
            Linear(C, C, **kw), nn.ReLU(), Linear(C, C, **kw), nn.ReLU(),
            Linear(C, out_channels, **kw))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for emb in (self.query_embed, self.query_feat, self.level_embed):
            emb.weight.normal_(0.0, 1.0, generator=generator)

    def _predict(self, decoder_out, mask_feature, full_mask: bool):
        """cls logits, full-resolution mask logits (or None), mask embed."""
        x = self.transformer_decoder.post_norm(decoder_out)
        cls_pred = self.cls_embed(x).float()
        m = self.mask_embed(x)
        mask_pred = None
        if full_mask:
            mask_pred = torch.einsum("bqc,bhwc->bqhw", m.float(),
                                     mask_feature.float())
        return cls_pred, mask_pred, m

    @staticmethod
    def _attn_mask(am: torch.Tensor) -> torch.Tensor:
        """(B, Q, h, w) mask logits -> (B, 1, Q, h * w) bool, True = masked
        out; all-masked rows attend everywhere instead."""
        B, Q = am.shape[:2]
        am = (torch.sigmoid(am) < 0.5).reshape(B, Q, -1)
        am = am & ~am.all(dim=-1, keepdim=True)
        return am[:, None]

    def _forward_head(self, decoder_out, mask_feature, mask_feature_small,
                      full_mask: bool):
        """Eval: cls logits, full-resolution mask logits (or None) and the
        attention mask (B, 1, Q, S) for the next layer, from the mask
        feature pre-resized to the next memory's scale."""
        cls_pred, mask_pred, m = self._predict(decoder_out, mask_feature,
                                               full_mask)
        am = torch.einsum("bqc,bhwc->bqhw", m.float(),
                          mask_feature_small.float())
        return cls_pred, mask_pred, self._attn_mask(am)

    def _forward_head_train(self, decoder_out, mask_feature, attn_size):
        """Training: the same outputs, the attention mask from the
        full-resolution mask logits resized to `attn_size` (no gradient)."""
        cls_pred, mask_pred, _ = self._predict(decoder_out, mask_feature,
                                               True)
        am = resize_hw(mask_pred.detach(), attn_size, "bilinear")
        return cls_pred, mask_pred, self._attn_mask(am)

    def forward(self, feats: Sequence[torch.Tensor], all_masks: bool = False):
        """feats: 4-scale NHWC pyramid. Returns (cls_list, mask_list), one
        entry per decoder layer plus one. At eval, intermediate entries of
        mask_list are None unless `all_masks`; in training mode every entry
        is the layer's full-resolution mask logits."""
        B = feats[0].shape[0]
        L = self.num_levels
        mask_feature, memories = self.pixel_decoder(feats)

        dec_inputs, dec_pos, sizes = [], [], []
        for i in range(L):
            mem = memories[i]
            H, W = mem.shape[1], mem.shape[2]
            x = mem.reshape(B, H * W, -1) + self.level_embed.weight[i]
            pos = sine_positional_encoding((H, W), self.feat_channels // 2,
                                           mem.device)
            dec_inputs.append(x)
            dec_pos.append(pos.reshape(1, H * W, -1).expand_as(x).to(x.dtype))
            sizes.append((H, W))

        query = self.query_feat.weight[None].expand(B, -1, -1)
        query_pos = self.query_embed.weight[None].expand(B, -1, -1)
        layers = self.transformer_decoder.layers
        if self.training:
            def head(query, lvl, full):
                return self._forward_head_train(query, mask_feature,
                                                sizes[lvl])
        else:
            mf_small = [resize_2d(mask_feature, s, "bilinear")
                        for s in sizes]

            def head(query, lvl, full):
                return self._forward_head(query, mask_feature, mf_small[lvl],
                                          all_masks or full)

        cls_list: List[torch.Tensor] = []
        mask_list: List[Optional[torch.Tensor]] = []
        cls_pred, mask_pred, attn_mask = head(query, 0, not layers)
        cls_list.append(cls_pred)
        mask_list.append(mask_pred)
        for i, layer in enumerate(layers):
            query = layer(query, query_pos, dec_inputs[i % L], dec_pos[i % L],
                          attn_mask)
            cls_pred, mask_pred, attn_mask = head(query, (i + 1) % L,
                                                  i == len(layers) - 1)
            cls_list.append(cls_pred)
            mask_list.append(mask_pred)
        return cls_list, mask_list

    @staticmethod
    def semantic_inference(cls_pred: torch.Tensor,
                           mask_pred: torch.Tensor) -> torch.Tensor:
        """Fuse final-layer predictions into per-class logits (B, h, w, K)."""
        prob = torch.softmax(cls_pred.float(), dim=-1)[..., :-1]
        mask = torch.sigmoid(mask_pred.float())
        return torch.einsum("bqc,bqhw->bhwc", prob, mask)
