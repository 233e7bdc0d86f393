"""MaskFormer head and its plain pixel decoders (counterpart of
`vitadapter/heads/maskformer.py`; reference
`segmentation/mmseg_custom/models/decode_heads/maskformer_head.py` and
`plugins/pixel_decoder.py:10,114`).

A plain FPN pixel decoder (or one with a DETR encoder on the coarsest
level), a 6-layer post-norm DETR decoder WITHOUT masked attention (self
attention first, MaskFormer's order), and per layer the class logits and
the mask logits as the product of a 3-layer mask MLP with the stride-4
mask feature. The head returns every layer's (class, mask) logits, so it
slots into `EncoderDecoderMask2Former` and `make_m2f_train_step` as the
Mask2Former head does. Parameter names are mmseg's (`pixel_decoder.
{lateral_convs, output_convs, last_feat_conv, mask_feature,
encoder_in_proj, encoder, encoder_out_proj}`, `transformer_decoder.
{layers.N.{attentions.0 (self), attentions.1 (cross), norms, ffns},
post_norm}`, `query_embed`, `cls_embed`, `mask_embed.{0,2,4}`).

As in the JAX package, the plain decoder's memory is the backbone's
coarsest map itself: a backbone whose width is not `feat_channels` (every
BEiT-Adapter config's 1024 against 256) raises `ValueError: memory dim
mismatch` at the first forward; the encoder variant projects it.
"""

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vitadapter_torch.det.necks import nearest_resize
from vitadapter_torch.heads.mask2former import MultiheadAttention
from vitadapter_torch.heads.pixel_decoder import FFN, ConvGN
from vitadapter_torch.layers.linear import Conv2d, Linear, conv_nhwc
from vitadapter_torch.layers.norm import LayerNorm
from vitadapter_torch.layers.positional import sine_positional_encoding


class PixelDecoder(nn.Module):
    """Plain FPN pixel decoder: `last_feat_conv` (3x3 conv + GN + ReLU) on
    the coarsest map, top-down 1x1 (+GN) laterals with nearest upsampling
    and 3x3 (+GN + ReLU) outputs, then the 3x3 `mask_feature` conv.
    feats (strides 4-32, NHWC) -> (mask feature, memory = feats[-1])."""

    def __init__(self, in_channels: Sequence[int], feat_channels: int = 256,
                 out_channels: int = 256, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        C = feat_channels
        self.lateral_convs = nn.ModuleList([
            ConvGN(c, C, 1, **kw) for c in in_channels[:-1]])
        self.output_convs = nn.ModuleList([
            ConvGN(C, C, 3, act=True, **kw) for _ in in_channels[:-1]])
        self.last_feat_conv = ConvGN(in_channels[-1], C, 3, act=True, **kw)
        self.mask_feature = Conv2d(C, out_channels, 3, padding=1, **kw)

    def fpn(self, feats, y):
        """The top-down tail from the coarsest level's output `y`."""
        for i in range(len(feats) - 2, -1, -1):
            lat = conv_nhwc(self.lateral_convs[i], feats[i])
            y = lat + nearest_resize(y, lat.shape[1:3])
            y = conv_nhwc(self.output_convs[i], y)
        return conv_nhwc(self.mask_feature, y)

    def forward(self, feats: Sequence[torch.Tensor]):
        y = conv_nhwc(self.last_feat_conv, feats[-1])
        return self.fpn(feats, y), feats[-1]


class EncoderLayer(nn.Module):
    """Post-norm DETR encoder layer: the position on query and key, not
    on the value (mmcv `MultiheadAttention`)."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.attentions = nn.ModuleList([MultiheadAttention(dim, num_heads,
                                                            **kw)])
        self.norms = nn.ModuleList([LayerNorm(dim, eps=1e-5, **kw)
                                    for _ in range(2)])
        self.ffns = nn.ModuleList([FFN(dim, ffn_dim, **kw)])

    def forward(self, x, pos):
        x = self.norms[0](x + self.attentions[0](x + pos, x + pos, x))
        return self.norms[1](x + self.ffns[0](x))


class TransformerEncoderPixelDecoder(PixelDecoder):
    """`PixelDecoder` with a global self-attention encoder on the coarsest
    level: `encoder_in_proj` (1x1 conv), the encoder layers, and
    `encoder_out_proj` (3x3 conv + GN + ReLU) in place of
    `last_feat_conv`; the memory is the encoder's output."""

    def __init__(self, in_channels: Sequence[int], feat_channels: int = 256,
                 out_channels: int = 256, num_layers: int = 6,
                 num_heads: int = 8, ffn_dim: int = 2048,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_channels, feat_channels, out_channels, dtype,
                         device)
        kw = dict(dtype=dtype, device=device)
        C = feat_channels
        del self.last_feat_conv
        self.encoder_in_proj = Conv2d(in_channels[-1], C, 1, **kw)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList([
            EncoderLayer(C, num_heads, ffn_dim, **kw)
            for _ in range(num_layers)])
        self.encoder_out_proj = ConvGN(C, C, 3, act=True, **kw)

    def forward(self, feats: Sequence[torch.Tensor]):
        x = conv_nhwc(self.encoder_in_proj, feats[-1])
        B, H, W, C = x.shape
        x = x.reshape(B, H * W, C)
        pos = sine_positional_encoding((H, W), C // 2, x.device)
        pos = pos.reshape(1, H * W, C).to(x.dtype)
        for layer in self.encoder.layers:
            x = layer(x, pos)
        memory = x.reshape(B, H, W, C)
        y = conv_nhwc(self.encoder_out_proj, memory)
        return self.fpn(feats, y), memory


class DetrDecoderLayer(nn.Module):
    """Post-norm DETR decoder layer, self attention first: self -> LN ->
    cross -> LN -> FFN -> LN (the value carries no position)."""

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

    def forward(self, query, query_pos, key, key_pos):
        q = query + query_pos
        x = self.norms[0](query + self.attentions[0](q, q, query))
        x = self.norms[1](x + self.attentions[1](x + query_pos, key + key_pos,
                                                 key))
        return self.norms[2](x + self.ffns[0](x))


class MaskFormerHead(nn.Module):
    def __init__(self, in_channels: Sequence[int], num_classes: int = 150,
                 num_queries: int = 100, feat_channels: int = 256,
                 out_channels: int = 256, num_decoder_layers: int = 6,
                 num_heads: int = 8, decoder_ffn_dim: int = 2048,
                 use_encoder_decoder: bool = False,
                 pixel_encoder_layers: int = 6,
                 pixel_encoder_ffn_dim: int = 2048,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        C = feat_channels
        self.feat_channels = C
        if use_encoder_decoder:
            self.pixel_decoder = TransformerEncoderPixelDecoder(
                in_channels, C, out_channels, pixel_encoder_layers,
                num_heads, pixel_encoder_ffn_dim, **kw)
        else:
            self.pixel_decoder = PixelDecoder(in_channels, C, out_channels,
                                              **kw)
        self.query_embed = nn.Embedding(num_queries, C, device=device)
        self.transformer_decoder = nn.Module()
        self.transformer_decoder.layers = nn.ModuleList([
            DetrDecoderLayer(C, num_heads, decoder_ffn_dim, **kw)
            for _ in range(num_decoder_layers)])
        self.transformer_decoder.post_norm = LayerNorm(C, eps=1e-5,
                                                       device=device)
        # flax Dense without a dtype: fp32 params and fp32 input -> fp32
        self.cls_embed = Linear(C, num_classes + 1, device=device)
        self.mask_embed = nn.Sequential(
            Linear(C, C, **kw), nn.ReLU(), Linear(C, C, **kw), nn.ReLU(),
            Linear(C, out_channels, **kw))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.query_embed.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats: 4-scale NHWC pyramid. Returns (cls_list, mask_list), one
        entry per decoder layer: class logits (B, Q, K+1) and mask logits
        (B, Q, H/4, W/4), fp32 (the mask product summed in fp32)."""
        B = feats[0].shape[0]
        mask_feature, memory = self.pixel_decoder(feats)
        _, H, W, Cm = memory.shape
        if Cm != self.feat_channels:
            raise ValueError("memory dim mismatch")
        mem = memory.reshape(B, H * W, Cm)
        pos = sine_positional_encoding((H, W), Cm // 2, mem.device)
        pos = pos.reshape(1, H * W, Cm).to(mem.dtype)
        query_pos = self.query_embed.weight[None].to(mem.dtype).expand(
            B, -1, -1)
        query = torch.zeros_like(query_pos)
        td = self.transformer_decoder
        cls_list: List[torch.Tensor] = []
        mask_list: List[torch.Tensor] = []
        for layer in td.layers:
            query = layer(query, query_pos, mem, pos)
            x = td.post_norm(query)
            cls_list.append(self.cls_embed(x).float())
            m = self.mask_embed(x)
            mask_list.append(torch.einsum("bqc,bhwc->bqhw", m.float(),
                                          mask_feature.float()))
        return cls_list, mask_list
