"""ViT-Adapter backbone: plain ViT + spatial-prior adapter -> 4-scale
pyramid (counterpart of `vitadapter/models/vit_adapter.py`).

forward(image NHWC) -> [f1, f2, f3, f4] NHWC maps at strides 4/8/16/32, all
with `embed_dim` channels. As in the reference, the adapter subclasses the
ViT trunk, so parameter names are the reference's (`blocks.N...`,
`spm...`, `interactions.N...`). `img_size` is advisory, as in JAX (the
position embedding is resampled to each input); `with_cp` recomputes the
ViT blocks in the backward, not the interactions.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from port_bench.reference.layers.linear import ConvTranspose2d
from port_bench.reference.layers.norm import BatchNorm
from port_bench.reference.models.adapter import (InteractionBlock,
                                             SpatialPriorModule, deform_inputs)
from port_bench.reference.models.vit import TIMMVisionTransformer
from port_bench.reference.utils.resize import resize_2d


class ViTAdapter(TIMMVisionTransformer):
    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path_rate: float = 0.0, layer_scale: bool = True,
                 pretrain_size: int = 224, with_cp: bool = False,
                 window_attn=False, window_size=14, residual_indices=(),
                 conv_inplane: int = 64, n_points: int = 4,
                 deform_num_heads: int = 6, init_values: float = 0.0,
                 interaction_indexes: Sequence[Sequence[int]] = (
                     (0, 2), (3, 5), (6, 8), (9, 11)),
                 with_cffn: bool = True, cffn_ratio: float = 0.25,
                 deform_ratio: float = 1.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(patch_size=patch_size, embed_dim=embed_dim,
                         depth=depth, num_heads=num_heads, mlp_ratio=mlp_ratio,
                         qkv_bias=qkv_bias, drop_path_rate=drop_path_rate,
                         layer_scale=layer_scale, pretrain_size=pretrain_size,
                         with_cp=with_cp, window_attn=window_attn,
                         window_size=window_size,
                         residual_indices=residual_indices, dtype=dtype,
                         device=device)
        self.interaction_indexes = tuple(tuple(s) for s in interaction_indexes)
        self.level_embed = nn.Parameter(torch.zeros(3, embed_dim,
                                                    device=device))
        self.spm = SpatialPriorModule(conv_inplane, embed_dim, dtype=dtype,
                                      device=device)
        n_inter = len(self.interaction_indexes)
        self.interactions = nn.ModuleList([
            InteractionBlock(embed_dim, num_heads=deform_num_heads,
                             n_points=n_points, init_values=init_values,
                             deform_ratio=deform_ratio, with_cffn=with_cffn,
                             cffn_ratio=cffn_ratio, drop_path=drop_path_rate,
                             extra_extractor=i == n_inter - 1,
                             dtype=dtype, device=device)
            for i in range(n_inter)])
        self.up = ConvTranspose2d(embed_dim, embed_dim, 2, stride=2,
                                  dtype=dtype, device=device)
        self.norm1 = BatchNorm(embed_dim, device=device)
        self.norm2 = BatchNorm(embed_dim, device=device)
        self.norm3 = BatchNorm(embed_dim, device=device)
        self.norm4 = BatchNorm(embed_dim, device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """x: (B, H, W, 3) image, H and W divisible by 32. In training mode
        BatchNorm uses batch statistics and DropPath draws from
        `generator`."""
        B, H_img, W_img, _ = x.shape
        injector_inputs, extractor_inputs = deform_inputs(H_img, W_img,
                                                          x.device)

        # spatial prior
        c1, c2, c3, c4 = self.spm(x)
        c2 = c2 + self.level_embed[0]
        c3 = c3 + self.level_embed[1]
        c4 = c4 + self.level_embed[2]
        c = torch.cat([c2, c3, c4], dim=1)
        n2, n3 = c2.shape[1], c3.shape[1]

        # patch embedding (+ resampled pos embed, no cls token)
        t, H, W = self.embed(x)
        dim = t.shape[-1]

        # interleaved interaction
        for (a, b), layer in zip(self.interaction_indexes, self.interactions):
            def blocks_fn(tokens, _a=a, _b=b):
                return self.run_blocks(tokens, H, W, _a, _b + 1, generator)

            t, c = layer(t, c, blocks_fn, injector_inputs, extractor_inputs,
                         H, W, generator)

        # split the token pyramid back into NHWC maps
        c2 = c[:, :n2].reshape(B, H * 2, W * 2, dim)
        c3 = c[:, n2:n2 + n3].reshape(B, H, W, dim)
        c4 = c[:, n2 + n3:].reshape(B, H // 2, W // 2, dim)
        c1 = self.up(c2.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) + c1

        # add the ViT features to every scale
        x3 = t.reshape(B, H, W, dim)
        x1 = resize_2d(x3, (H * 4, W * 4), "bilinear")
        x2 = resize_2d(x3, (H * 2, W * 2), "bilinear")
        x4 = resize_2d(x3, (H // 2, W // 2), "bilinear")
        c1, c2, c3, c4 = c1 + x1, c2 + x2, c3 + x3, c4 + x4

        return [norm(f.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                for norm, f in ((self.norm1, c1), (self.norm2, c2),
                                (self.norm3, c3), (self.norm4, c4))]
