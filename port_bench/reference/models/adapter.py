"""ViT-Adapter core modules (counterpart of `vitadapter/models/adapter.py`):
`deform_inputs`, `DWConv`/`ConvFFN`, `Injector`, `Extractor`,
`InteractionBlock` and `SpatialPriorModule`. Token tensors are (B, N, C);
maps are NHWC at module boundaries and NCHW views inside convolutions.
"""

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from port_bench.reference.layers.drop import DropPath
from port_bench.reference.layers.linear import Conv2d, Linear
from port_bench.reference.layers.mlp import gelu
from port_bench.reference.layers.norm import BatchNorm, LayerNorm
from port_bench.reference.ops.msda import MSDeformAttn, SpatialShapes


def get_reference_points(spatial_shapes: SpatialShapes) -> np.ndarray:
    """Normalized cell-centre grid over the levels: (1, sum HW, 1, 2) xy."""
    pts = []
    for H, W in spatial_shapes:
        ys = (np.arange(H, dtype=np.float32) + 0.5) / H
        xs = (np.arange(W, dtype=np.float32) + 0.5) / W
        yy, xx = np.meshgrid(ys, xs, indexing="ij")
        pts.append(np.stack([xx.reshape(-1), yy.reshape(-1)], axis=-1))
    return np.concatenate(pts, axis=0)[None, :, None, :]


def deform_inputs(h: int, w: int, device=None):
    """(injector_inputs, extractor_inputs) for an h x w image, each a
    (reference_points, spatial_shapes) pair. The injector queries the
    stride-16 token grid against the [8, 16, 32]-stride prior; the extractor
    queries the prior against the stride-16 ViT map. h and w must be
    multiples of 32: elsewhere the prior's convolutions round the 1/16 and
    1/32 maps up where the patch grid and these shapes round down, and the
    JAX package fails its first injector's size assertion; the port raises
    here (ROADMAP.md §3: the HTC++ configs' [1600, 1400] crop)."""
    if h % 32 or w % 32:
        raise ValueError(
            f"the adapter's canvas must be a multiple of 32 a side; "
            f"{h}x{w} is not (the HTC++ configs' crop_size [1600, 1400] "
            f"runs as [1600, 1408])")
    shapes3 = ((h // 8, w // 8), (h // 16, w // 16), (h // 32, w // 32))
    shapes1 = ((h // 16, w // 16),)

    def ref(shapes):
        return torch.from_numpy(get_reference_points(shapes)).to(device)

    return (ref(shapes1), shapes3), (ref(shapes3), shapes1)


class DWConv(nn.Module):
    """3x3 depthwise conv shared by the three scales of the 21n-token
    pyramid sequence: 16n tokens of the (2H, 2W) map, then 4n of (H, W),
    then n of (H/2, W/2)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, padding=1, groups=dim, dtype=dtype,
                             device=device)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        n = N // 21
        splits = [(x[:, :16 * n], 2 * H, 2 * W),
                  (x[:, 16 * n:20 * n], H, W),
                  (x[:, 20 * n:], H // 2, W // 2)]
        outs = []
        for t, h_, w_ in splits:
            m = self.dwconv(t.reshape(B, h_, w_, C).permute(0, 3, 1, 2))
            outs.append(m.permute(0, 2, 3, 1).reshape(B, h_ * w_, C))
        return torch.cat(outs, dim=1)


class ConvFFN(nn.Module):
    """FFN with a depthwise conv between fc1 and the activation."""

    def __init__(self, in_features: int, hidden_features: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.fc1 = Linear(in_features, hidden_features, **kw)
        self.dwconv = DWConv(hidden_features, **kw)
        self.fc2 = Linear(hidden_features, in_features, **kw)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        return self.fc2(gelu(self.dwconv(self.fc1(x), H, W)))


class Injector(nn.Module):
    """Inject spatial-prior features into the ViT tokens through MSDA, gated
    by a per-channel gamma (zero at init)."""

    def __init__(self, dim: int, num_heads: int = 6, n_points: int = 4,
                 n_levels: int = 3, deform_ratio: float = 1.0,
                 init_values: float = 0.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.init_values = init_values
        self.query_norm = LayerNorm(dim, eps=1e-6, device=device)
        self.feat_norm = LayerNorm(dim, eps=1e-6, device=device)
        self.attn = MSDeformAttn(dim, n_levels, num_heads, n_points,
                                 ratio=deform_ratio, dtype=dtype,
                                 device=device)
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values),
                                             device=device))

    def forward(self, query, reference_points, feat,
                spatial_shapes: SpatialShapes, query_segments=None):
        attn = self.attn(self.query_norm(query), reference_points,
                         self.feat_norm(feat), spatial_shapes,
                         query_segments=query_segments)
        return query + self.gamma * attn


class Extractor(nn.Module):
    """Extract ViT-token content back into the spatial prior through MSDA,
    then an optional ConvFFN."""

    def __init__(self, dim: int, num_heads: int = 6, n_points: int = 4,
                 n_levels: int = 1, deform_ratio: float = 1.0,
                 with_cffn: bool = True, cffn_ratio: float = 0.25,
                 drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.query_norm = LayerNorm(dim, eps=1e-6, device=device)
        self.feat_norm = LayerNorm(dim, eps=1e-6, device=device)
        self.attn = MSDeformAttn(dim, n_levels, num_heads, n_points,
                                 ratio=deform_ratio, dtype=dtype,
                                 device=device)
        self.with_cffn = with_cffn
        if with_cffn:
            self.ffn_norm = LayerNorm(dim, eps=1e-6, device=device)
            self.ffn = ConvFFN(dim, int(dim * cffn_ratio), dtype=dtype,
                               device=device)
            self.drop_path = DropPath(drop_path)

    def forward(self, query, reference_points, feat,
                spatial_shapes: SpatialShapes, H: int, W: int,
                query_segments=None,
                generator: Optional[torch.Generator] = None):
        attn = self.attn(self.query_norm(query), reference_points,
                         self.feat_norm(feat), spatial_shapes,
                         query_segments=query_segments)
        query = query + attn
        if self.with_cffn:
            y = self.ffn(self.ffn_norm(query), H, W)
            query = query + self.drop_path(y, generator)
        return query


class InteractionBlock(nn.Module):
    """Injector -> span of ViT blocks -> Extractor (+ 2 extra extractors in
    the final block)."""

    def __init__(self, dim: int, num_heads: int = 6, n_points: int = 4,
                 init_values: float = 0.0, deform_ratio: float = 1.0,
                 with_cffn: bool = True, cffn_ratio: float = 0.25,
                 drop_path: float = 0.0, extra_extractor: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.injector = Injector(dim, num_heads, n_points, n_levels=3,
                                 deform_ratio=deform_ratio,
                                 init_values=init_values, **kw)

        def extractor():
            return Extractor(dim, num_heads, n_points, n_levels=1,
                             deform_ratio=deform_ratio, with_cffn=with_cffn,
                             cffn_ratio=cffn_ratio, drop_path=drop_path, **kw)

        self.extractor = extractor()
        self.extra_extractors = (nn.ModuleList([extractor(), extractor()])
                                 if extra_extractor else None)

    def forward(self, x, c, blocks_fn: Callable, injector_inputs,
                extractor_inputs, H: int, W: int,
                generator: Optional[torch.Generator] = None):
        ref1, shapes1 = injector_inputs
        ref2, shapes2 = extractor_inputs
        inj_segs = tuple(h * w for h, w in shapes2)
        ext_segs = tuple(h * w for h, w in shapes1)
        x = self.injector(x, ref1, c, shapes1, query_segments=inj_segs)
        x = blocks_fn(x)
        extractors = [self.extractor] + list(self.extra_extractors or [])
        for ex in extractors:
            c = ex(c, ref2, x, shapes2, H, W, query_segments=ext_segs,
                   generator=generator)
        return x, c


def _conv_bn_relu(cin: int, cout: int, stride: int, dtype, device):
    return [Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False,
                   dtype=dtype, device=device),
            BatchNorm(cout, device=device), nn.ReLU()]


class SpatialPriorModule(nn.Module):
    """Conv stem emitting a 4-scale prior: the c1 map (stride 4, NHWC) and
    c2..c4 token sequences at strides 8/16/32."""

    def __init__(self, inplanes: int = 64, embed_dim: int = 384,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.stem = nn.Sequential(
            *_conv_bn_relu(3, inplanes, 2, **kw),
            *_conv_bn_relu(inplanes, inplanes, 1, **kw),
            *_conv_bn_relu(inplanes, inplanes, 1, **kw),
            # max_pool2d pads with -inf
            nn.MaxPool2d(kernel_size=3, stride=2, padding=1))
        self.conv2 = nn.Sequential(*_conv_bn_relu(inplanes, 2 * inplanes, 2,
                                                  **kw))
        self.conv3 = nn.Sequential(*_conv_bn_relu(2 * inplanes, 4 * inplanes,
                                                  2, **kw))
        self.conv4 = nn.Sequential(*_conv_bn_relu(4 * inplanes, 4 * inplanes,
                                                  2, **kw))
        self.fc1 = Conv2d(inplanes, embed_dim, 1, **kw)
        self.fc2 = Conv2d(2 * inplanes, embed_dim, 1, **kw)
        self.fc3 = Conv2d(4 * inplanes, embed_dim, 1, **kw)
        self.fc4 = Conv2d(4 * inplanes, embed_dim, 1, **kw)

    def forward(self, x: torch.Tensor):
        """x: (B, H, W, 3) -> c1 (B, H/4, W/4, D), c2..c4 (B, N_i, D)."""
        c1 = self.stem(x.permute(0, 3, 1, 2))
        c2 = self.conv2(c1)
        c3 = self.conv3(c2)
        c4 = self.conv4(c3)

        def tokens(m):
            B, D = m.shape[:2]
            return m.permute(0, 2, 3, 1).reshape(B, -1, D)

        return (self.fc1(c1).permute(0, 2, 3, 1), tokens(self.fc2(c2)),
                tokens(self.fc3(c3)), tokens(self.fc4(c4)))
