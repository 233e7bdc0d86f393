"""Encoder-decoder segmentor with a Mask2Former head (counterpart of
`vitadapter/models/mask2former_segmentor.py`)."""

from typing import Optional

import torch
from torch import nn

from vitadapter_torch.heads.mask2former import Mask2FormerHead
from vitadapter_torch.utils.resize import resize_2d


class EncoderDecoderMask2Former(nn.Module):
    def __init__(self, backbone: nn.Module, decode_head: Mask2FormerHead):
        super().__init__()
        self.backbone = backbone
        self.decode_head = decode_head

    def forward(self, img: torch.Tensor, return_queries: bool = False,
                generator: Optional[torch.Generator] = None):
        """img: normalized (B, H, W, 3). In training mode returns every
        decoder layer's (cls_list, mask_list): cls logits (B, Q, K+1) and
        full-resolution mask logits (B, Q, H/4, W/4), DropPath drawing from
        `generator`. At eval returns per-class logits (B, H, W, K) at input
        size or, with `return_queries`, the final layer's raw cls logits
        (B, Q, K+1) and mask logits (B, Q, H, W) at input size (for
        panoptic / instance fusion)."""
        feats = self.backbone(img, generator)
        cls_list, mask_list = self.decode_head(feats)
        if self.training:
            return cls_list, mask_list
        if return_queries:
            masks = resize_2d(mask_list[-1].permute(0, 2, 3, 1),
                              img.shape[1:3], "bilinear")
            return cls_list[-1], masks.permute(0, 3, 1, 2)
        seg = Mask2FormerHead.semantic_inference(cls_list[-1], mask_list[-1])
        return resize_2d(seg, img.shape[1:3], "bilinear")
