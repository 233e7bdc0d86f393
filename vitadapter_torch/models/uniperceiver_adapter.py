"""UniPerceiverAdapter: the multimodal trunk + the spatial-prior adapter
(counterpart of `vitadapter/models/uniperceiver_adapter.py`).

The ViT-Adapter skeleton with the text state carried through each trunk
span between an injector and its extractors, an optional stack of
`GroundingCrossAttention` blocks (`cross_attn.{g}`) after the interactions,
and `out_indices` choosing the scales returned. As in the reference the
adapter subclasses the trunk, so the trunk's keys are flat (`layers.N`,
`visual_embed`, `token_embed`) beside the adapter's (`level_embed`, `spm`,
`interactions`, `up`, `norm1`..`norm4`).

`forward(img, refer, r_mask=None, generator=None)`: `refer` is required, as
in the JAX package, so a segmentor or an R-CNN detector that calls the
backbone with the image alone raises the same `TypeError` there.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from vitadapter_torch.layers.linear import ConvTranspose2d
from vitadapter_torch.layers.norm import BatchNorm
from vitadapter_torch.models.adapter import (InteractionBlock,
                                             SpatialPriorModule, deform_inputs)
from vitadapter_torch.models.uniperceiver import (GroundingCrossAttention,
                                                  UnifiedBertEncoder)
from vitadapter_torch.utils.resize import resize_2d


class UniPerceiverAdapter(UnifiedBertEncoder):
    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, window_attn=False,
                 window_size=14, vocab_size: int = 49411,
                 with_cp: bool = False, conv_inplane: int = 64,
                 n_points: int = 4, deform_num_heads: int = 6,
                 init_values: float = 0.0,
                 interaction_indexes: Sequence[Sequence[int]] = (
                     (0, 2), (3, 5), (6, 8), (9, 11)),
                 with_cffn: bool = True, cffn_ratio: float = 0.25,
                 deform_ratio: float = 1.0, add_vit_feature: bool = True,
                 use_extra_extractor: bool = True,
                 num_grounding_blocks: int = 0,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(patch_size=patch_size, embed_dim=embed_dim,
                         depth=depth, num_heads=num_heads,
                         mlp_ratio=mlp_ratio, drop_path_rate=drop_path_rate,
                         window_attn=window_attn, window_size=window_size,
                         vocab_size=vocab_size, with_cp=with_cp, dtype=dtype,
                         device=device)
        self.interaction_indexes = tuple(tuple(s) for s in interaction_indexes)
        self.add_vit_feature = add_vit_feature
        self.out_indices = tuple(out_indices)
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
                             extra_extractor=(i == n_inter - 1
                                              and use_extra_extractor),
                             dtype=dtype, device=device)
            for i in range(n_inter)])
        self.cross_attn = nn.ModuleList([
            GroundingCrossAttention(embed_dim, num_heads, dtype=dtype,
                                    device=device)
            for _ in range(num_grounding_blocks)])
        self.up = ConvTranspose2d(embed_dim, embed_dim, 2, stride=2,
                                  dtype=dtype, device=device)
        self.norm1 = BatchNorm(embed_dim, device=device)
        self.norm2 = BatchNorm(embed_dim, device=device)
        self.norm3 = BatchNorm(embed_dim, device=device)
        self.norm4 = BatchNorm(embed_dim, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.level_embed.normal_(0.0, 1.0, generator=generator)

    def forward(self, img: torch.Tensor, refer: torch.Tensor,
                r_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """img (B, H, W, 3), H and W multiples of 32; refer (B, T) CLIP-BPE
        ids; r_mask (B, T) nonzero where the text is real -> the
        `out_indices` of the NHWC maps at strides 4/8/16/32. In training
        mode BatchNorm uses batch statistics and DropPath draws from
        `generator`."""
        B, H_img, W_img, _ = img.shape
        injector_inputs, extractor_inputs = deform_inputs(H_img, W_img,
                                                          img.device)

        c1, c2, c3, c4 = self.spm(img)
        c2 = c2 + self.level_embed[0]
        c3 = c3 + self.level_embed[1]
        c4 = c4 + self.level_embed[2]
        c = torch.cat([c2, c3, c4], dim=1)
        n2, n3 = c2.shape[1], c3.shape[1]

        x, H, W = self.visual_embed(img)
        q = self.token_embed(refer)
        dim = x.shape[-1]

        # the text rides through each span of trunk layers
        state = {"q": q}
        for (a, b), layer in zip(self.interaction_indexes, self.interactions):
            def blocks_fn(tokens, _a=a, _b=b):
                tokens, state["q"] = self.run_layers(
                    tokens, state["q"], r_mask, H, W, _a, _b + 1, generator)
                return tokens

            x, c = layer(x, c, blocks_fn, injector_inputs, extractor_inputs,
                         H, W, generator)
        q = state["q"]

        for block in self.cross_attn:
            x = block(x, q, r_mask)

        c2 = c[:, :n2].reshape(B, H * 2, W * 2, dim)
        c3 = c[:, n2:n2 + n3].reshape(B, H, W, dim)
        c4 = c[:, n2 + n3:].reshape(B, H // 2, W // 2, dim)
        c1 = self.up(c2.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) + c1

        if self.add_vit_feature:
            x3 = x.reshape(B, H, W, dim)
            c1 = c1 + resize_2d(x3, (H * 4, W * 4), "bilinear")
            c2 = c2 + resize_2d(x3, (H * 2, W * 2), "bilinear")
            c3 = c3 + x3
            c4 = c4 + resize_2d(x3, (H // 2, W // 2), "bilinear")

        feats = [norm(f.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                 for norm, f in ((self.norm1, c1), (self.norm2, c2),
                                 (self.norm3, c3), (self.norm4, c4))]
        return [feats[i] for i in self.out_indices]
