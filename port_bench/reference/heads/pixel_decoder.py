"""Multi-scale deformable-attention pixel decoder for Mask2Former
(counterpart of `vitadapter/heads/pixel_decoder.py::MSDeformAttnPixelDecoder`).

1x1 conv + GN input projections of the 3 coarsest scales, 6 post-norm
deformable self-attention encoder layers over their concatenated tokens,
then an FPN tail down to the stride-4 `mask_feature`. Parameter names are
the reference's (mmseg/mmcv). Maps are NHWC at the boundaries.
"""

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.layers.linear import Conv2d, Linear
from port_bench.reference.layers.norm import GroupNorm, LayerNorm
from port_bench.reference.layers.positional import sine_positional_encoding
from port_bench.reference.ops.msda import MSDeformAttn
from port_bench.reference.utils.resize import resize_2d


class FFN(nn.Module):
    """mmcv FFN: Linear -> ReLU -> Linear, as `layers.0.0` and `layers.1`."""

    def __init__(self, dim: int, hidden: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.layers = nn.Sequential(
            nn.Sequential(Linear(dim, hidden, **kw), nn.ReLU()),
            Linear(hidden, dim, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class DeformableEncoderLayer(nn.Module):
    """Post-norm deformable self-attention layer:
    x = LN(x + MSDA(x + pos)); x = LN(x + FFN(x)). The position goes on the
    query only, not on the value."""

    def __init__(self, dim: int, num_heads: int = 8, n_levels: int = 3,
                 n_points: int = 4, ffn_dim: int = 1024,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.attentions = nn.ModuleList([MSDeformAttn(
            dim, n_levels, num_heads, n_points, dtype=dtype, device=device)])
        self.norms = nn.ModuleList([LayerNorm(dim, eps=1e-5, dtype=dtype,
                                              device=device)
                                    for _ in range(2)])
        self.ffns = nn.ModuleList([FFN(dim, ffn_dim, dtype=dtype,
                                       device=device)])

    def forward(self, x, pos, ref_points, spatial_shapes):
        segs = tuple(h * w for h, w in spatial_shapes)
        attn = self.attentions[0](x + pos, ref_points, x, spatial_shapes,
                                  query_segments=segs)
        x = self.norms[0](x + attn)
        return self.norms[1](x + self.ffns[0](x))


class DeformableEncoder(nn.Module):
    def __init__(self, num_layers: int, **layer_kw):
        super().__init__()
        self.layers = nn.ModuleList([DeformableEncoderLayer(**layer_kw)
                                     for _ in range(num_layers)])

    def forward(self, x, pos, ref_points, spatial_shapes):
        for layer in self.layers:
            x = layer(x, pos, ref_points, spatial_shapes)
        return x


class ConvGN(nn.Module):
    """Conv + GroupNorm(32) (mmcv ConvModule with GN), act optional; NCHW."""

    def __init__(self, cin: int, cout: int, kernel: int = 1,
                 groups: int = 32, act: bool = False, bias: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, padding=kernel // 2, bias=bias,
                           dtype=dtype, device=device)
        self.gn = GroupNorm(groups, cout, eps=1e-5, dtype=dtype,
                            device=device)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.gn(self.conv(x))
        return F.relu(x) if self.act else x


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class MSDeformAttnPixelDecoder(nn.Module):
    """feats (strides 4/8/16/32, NHWC) -> (mask_feature at stride 4,
    memories at strides 32/16/8, coarse to fine), all NHWC."""

    def __init__(self, in_channels: Sequence[int], feat_channels: int = 256,
                 out_channels: int = 256, num_encoder_levels: int = 3,
                 num_layers: int = 6, num_heads: int = 8, n_points: int = 4,
                 ffn_dim: int = 1024, num_feats: int = 128,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        C, L = feat_channels, num_encoder_levels
        kw = dict(dtype=dtype, device=device)
        self.num_levels = L
        self.num_feats = num_feats
        self.level_encoding = nn.Embedding(L, C, device=device)
        self.input_convs = nn.ModuleList([
            ConvGN(in_channels[-1 - i], C, 1, bias=True, **kw)
            for i in range(L)])
        n_fpn = len(in_channels) - L
        self.lateral_convs = nn.ModuleList([
            ConvGN(in_channels[i], C, 1, **kw) for i in range(n_fpn)])
        self.output_convs = nn.ModuleList([
            ConvGN(C, C, 3, act=True, **kw) for i in range(n_fpn)])
        self.mask_feature = Conv2d(C, out_channels, 1, **kw)
        self.encoder = DeformableEncoder(
            num_layers, dim=C, num_heads=num_heads, n_levels=L,
            n_points=n_points, ffn_dim=ffn_dim, **kw)

    def forward(self, feats: Sequence[torch.Tensor]):
        L = self.num_levels
        n_in = len(feats)
        B = feats[0].shape[0]
        dev = feats[0].device

        # coarsest first (stride 32, 16, 8)
        toks, poss, refs = [], [], []
        shapes: List[Tuple[int, int]] = []
        for i in range(L):
            f = feats[n_in - i - 1]
            H, W = f.shape[1], f.shape[2]
            f = _nhwc(self.input_convs[i](_nchw(f)))
            pos = sine_positional_encoding((H, W), self.num_feats, dev)
            pos = (pos + self.level_encoding.weight[i]).to(f.dtype)
            toks.append(f.reshape(B, H * W, -1))
            poss.append(pos.reshape(1, H * W, -1).expand(B, -1, -1))
            shapes.append((H, W))
            ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H
            xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W
            yy, xx = torch.meshgrid(ys, xs, indexing="ij")
            refs.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], -1))

        x = torch.cat(toks, dim=1)
        pos = torch.cat(poss, dim=1)
        # each token references its own normalized location at every level
        ref = torch.cat(refs, dim=0)[None, :, None, :].expand(B, -1, L, 2)
        x = self.encoder(x, pos, ref, tuple(shapes))

        # split back to maps, coarse -> fine
        outs = []
        start = 0
        for H, W in shapes:
            outs.append(x[:, start:start + H * W].reshape(B, H, W, -1))
            start += H * W

        # FPN over the remaining fine levels (stride 4)
        for i in range(n_in - L - 1, -1, -1):
            lateral = _nhwc(self.lateral_convs[i](_nchw(feats[i])))
            y = lateral + resize_2d(outs[-1], lateral.shape[1:3], "bilinear")
            outs.append(_nhwc(self.output_convs[i](_nchw(y))))

        mask_feature = _nhwc(self.mask_feature(_nchw(outs[-1])))
        return mask_feature, outs[:L]
