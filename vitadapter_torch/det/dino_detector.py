"""The DINO detector: backbone -> `ChannelMapper` -> the DINO head
(counterpart of `vitadapter/det/dino_detector.py`).

Strides 8/16/32 of the backbone and a learned stride-64 extra level feed
the 6+6 transformer; training adds the denoising groups and sums the
focal + L1 + GIoU losses of every decoder layer and of the encoder's
proposals; inference takes the flat top-k of the sigmoid class scores. No
config of the repo builds it; it shares every module with `GroundingDINO`.
Parameter names are the reference's (`backbone`, `neck`, `bbox_head`).
"""

from typing import Dict, Optional

import torch
from torch import nn

from vitadapter_torch.det.dino import (Assigner, DinoTransformer, DnDraws,
                                       cdn_draws, cdn_queries, decode_top_k,
                                       dino_losses)
from vitadapter_torch.det.losses import xyxy_to_cxcywh
from vitadapter_torch.det.necks import ChannelMapper
from vitadapter_torch.ops.matching import hungarian_assign


def normalized_gt(gt_boxes: torch.Tensor, hw) -> torch.Tensor:
    """Pixel xyxy gts -> normalized cxcywh."""
    H, W = hw
    scale = torch.tensor([W, H, W, H], dtype=torch.float32,
                         device=gt_boxes.device)
    return xyxy_to_cxcywh(gt_boxes.float() / scale)


class DINO(nn.Module):
    def __init__(self, backbone: nn.Module, num_classes: int = 80,
                 num_queries: int = 900, embed_dim: int = 256,
                 num_heads: int = 8, ffn_dim: int = 2048,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dn_groups: int = 2, max_dets: int = 100,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_queries = num_queries
        self.dn_groups = dn_groups
        self.max_dets = max_dets
        self.backbone = backbone
        self.neck = ChannelMapper([backbone.embed_dim] * 3, embed_dim,
                                  num_outs=4, dtype=dtype, device=device)
        self.bbox_head = DinoTransformer(
            embed_dim, num_heads, num_encoder_layers, num_decoder_layers,
            ffn_dim=ffn_dim, num_queries=num_queries,
            num_classes=num_classes, dtype=dtype, device=device)

    def extract(self, img, generator=None):
        return self.neck(self.backbone(img, generator=generator)[1:])

    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """img (B, H, W, 3) normalized -> the top `max_dets` detections:
        boxes (B, k, 4) xyxy pixels, scores, labels."""
        return decode_top_k(self.bbox_head(self.extract(img)),
                            img.shape[1:3], self.max_dets)

    def forward_train(self, img, gt_boxes, gt_labels, gt_valid,
                      generator: Optional[torch.Generator] = None,
                      dn_draws: Optional[DnDraws] = None,
                      assigner: Assigner = hungarian_assign
                      ) -> Dict[str, torch.Tensor]:
        """The losses on (B, G) pixel xyxy gts: DropPath and the denoising
        noise draw from `generator` (or `dn_draws` is used)."""
        feats = self.extract(img, generator)
        return dino_head_losses(self, feats, img.shape[1:3], gt_boxes,
                                gt_labels, gt_valid, generator, dn_draws,
                                assigner, enc_keys=True)


def dino_head_losses(det: nn.Module, feats, hw, gt_boxes, gt_labels,
                     gt_valid, generator, dn_draws, assigner,
                     enc_keys: bool) -> Dict[str, torch.Tensor]:
    """A DINO detector's head losses on its neck's `feats`."""
    head = det.bbox_head
    gt_n = normalized_gt(gt_boxes, hw)
    B, G = gt_labels.shape
    if dn_draws is None:
        dn_draws = cdn_draws(generator, B, G, det.dn_groups, det.num_classes,
                             device=gt_boxes.device)
    dn = cdn_queries(dn_draws, gt_labels, gt_n, gt_valid,
                     head.label_embedding.weight.to(head.compute_dtype),
                     det.dn_groups, det.num_classes, det.num_queries)
    outs = head(feats, dn.queries, dn.refs, dn.attn_mask)
    return dino_losses(outs, dn, gt_labels, gt_n, gt_valid, det.num_classes,
                       assigner=assigner, enc_keys=enc_keys)
