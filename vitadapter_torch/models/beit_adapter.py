"""BEiT-Adapter backbone (counterpart of `vitadapter/models/beit_adapter.py`,
the segmentation variant, `version="seg"`): the ViT-Adapter skeleton around
a BEiT trunk.

forward(image NHWC) -> [f1, f2, f3, f4] NHWC maps at strides 4/8/16/32, all
with `embed_dim` channels. The BEiT cls token rides along each span of
trunk blocks and is split off for the deformable interactions; the ViT
features added to the four scales are the per-interaction trunk outputs
x1..x4 (reference seg `beit_adapter.py:111-131`). As in the reference, the
adapter subclasses the trunk, so parameter names are the reference's
(`cls_token`, `blocks.N...`, `spm...`, `interactions.N...`).
"""

from typing import Optional, Sequence

import torch
from torch import nn

from vitadapter_torch.layers.linear import ConvTranspose2d
from vitadapter_torch.layers.norm import BatchNorm
from vitadapter_torch.models.adapter import (InteractionBlock,
                                             SpatialPriorModule, deform_inputs)
from vitadapter_torch.models.beit import BEiT, NOT_PORTED
from vitadapter_torch.utils.resize import resize_2d


class BEiTAdapter(BEiT):
    """The adapter's own settings are named here; the trunk's go to `BEiT`
    (`img_size`, `patch_size`, `depth`, `num_heads`, `mlp_ratio`, `with_cp`
    and the flags it checks)."""

    def __init__(self, embed_dim: int = 1024, init_values: float = 1e-6,
                 drop_path_rate: float = 0.0, conv_inplane: int = 64,
                 n_points: int = 4, deform_num_heads: int = 16,
                 interaction_indexes: Sequence[Sequence[int]] = (
                     (0, 5), (6, 11), (12, 17), (18, 23)),
                 cffn_ratio: float = 0.25, deform_ratio: float = 0.5,
                 version: str = "seg", dtype: torch.dtype = torch.float32,
                 device=None, **trunk):
        if version not in ("seg", "old"):
            raise NotImplementedError(NOT_PORTED)
        super().__init__(embed_dim=embed_dim, init_values=init_values,
                         drop_path_rate=drop_path_rate, dtype=dtype,
                         device=device, **trunk)
        self.interaction_indexes = tuple(tuple(s) for s in interaction_indexes)
        self.level_embed = nn.Parameter(torch.zeros(3, embed_dim,
                                                    device=device))
        self.spm = SpatialPriorModule(conv_inplane, embed_dim, dtype=dtype,
                                      device=device)
        n_inter = len(self.interaction_indexes)
        self.interactions = nn.ModuleList([
            InteractionBlock(embed_dim, num_heads=deform_num_heads,
                             n_points=n_points, init_values=init_values,
                             deform_ratio=deform_ratio, cffn_ratio=cffn_ratio,
                             drop_path=drop_path_rate,
                             extra_extractor=i == n_inter - 1,
                             dtype=dtype, device=device)
            for i in range(n_inter)])
        self.up = ConvTranspose2d(embed_dim, embed_dim, 2, stride=2,
                                  dtype=dtype, device=device)
        self.norm1 = BatchNorm(embed_dim, device=device)
        self.norm2 = BatchNorm(embed_dim, device=device)
        self.norm3 = BatchNorm(embed_dim, device=device)
        self.norm4 = BatchNorm(embed_dim, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        super().init_weights(generator)
        self.level_embed.normal_(0.0, 1.0, generator=generator)

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

        t, H, W = self.embed(x)
        dim = t.shape[-1]
        cls = [self.cls_token.to(t.dtype).expand(B, -1, -1)]

        # interleaved interaction; the cls token rides along the blocks only
        outs = []
        for (a, b), layer in zip(self.interaction_indexes, self.interactions):
            def blocks_fn(tokens, _a=a, _b=b):
                tokens = torch.cat([cls[0], tokens], dim=1)
                tokens = self.run_blocks(tokens, _a, _b + 1, generator)
                cls[0] = tokens[:, :1]
                return tokens[:, 1:]

            t, c = layer(t, c, blocks_fn, injector_inputs, extractor_inputs,
                         H, W, generator)
            outs.append(t.reshape(B, H, W, dim))

        # split the token pyramid back into NHWC maps
        c2 = c[:, :n2].reshape(B, H * 2, W * 2, dim)
        c3 = c[:, n2:n2 + n3].reshape(B, H, W, dim)
        c4 = c[:, n2 + n3:].reshape(B, H // 2, W // 2, dim)
        c1 = self.up(c2.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) + c1

        # add the per-interaction trunk maps (the last one to every scale
        # when there are not four interactions, as the JAX module does)
        x1, x2, x3, x4 = outs if len(outs) == 4 else [outs[-1]] * 4
        c1 = c1 + resize_2d(x1, (H * 4, W * 4), "bilinear")
        c2 = c2 + resize_2d(x2, (H * 2, W * 2), "bilinear")
        c3 = c3 + x3
        c4 = c4 + resize_2d(x4, (H // 2, W // 2), "bilinear")

        return [norm(f.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                for norm, f in ((self.norm1, c1), (self.norm2, c2),
                                (self.norm3, c3), (self.norm4, c4))]
