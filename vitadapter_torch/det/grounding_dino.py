"""GroundingDINO: text-conditioned single-box grounding (counterpart of
`vitadapter/det/grounding_dino.py`).

DINO on the Uni-Perceiver-Adapter, which reads (image, refer ids, refer
mask). The prediction is the top-scoring box of the flat top-k decode; the
multi-scale test picks one box by score plus mean IoU with the others
(`aug_test_vote`, on the host). With `with_aux_seg` training adds a dice
loss of a small conv branch on the finest neck map against the gt boxes'
rectangles (reference `grounding_dino.py:49-60, 102-119`).
"""

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vitadapter_torch.det.dino import (Assigner, DinoTransformer, DnDraws,
                                       decode_top_k)
from vitadapter_torch.det.dino_detector import dino_head_losses
from vitadapter_torch.det.necks import ChannelMapper
from vitadapter_torch.layers.linear import Conv2d
from vitadapter_torch.ops.matching import hungarian_assign
from vitadapter_torch.ops.nms import bbox_overlaps


class GroundingDINO(nn.Module):
    def __init__(self, backbone: nn.Module, num_classes: int = 1,
                 num_queries: int = 100, embed_dim: int = 256,
                 num_heads: int = 8, ffn_dim: int = 2048,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dn_groups: int = 2, max_dets: int = 100,
                 with_aux_seg: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_queries = num_queries
        self.dn_groups = dn_groups
        self.max_dets = max_dets
        self.with_aux_seg = with_aux_seg
        self.backbone = backbone
        self.neck = ChannelMapper([backbone.embed_dim] * 3, embed_dim,
                                  num_outs=4, dtype=dtype, device=device)
        self.bbox_head = DinoTransformer(
            embed_dim, num_heads, num_encoder_layers, num_decoder_layers,
            ffn_dim=ffn_dim, num_queries=num_queries,
            num_classes=num_classes, dtype=dtype, device=device)
        if with_aux_seg:
            self.aux_seg_convs = nn.ModuleList(
                [Conv2d(embed_dim, embed_dim, 3, padding=1, dtype=dtype,
                        device=device) for _ in range(2)]
                + [Conv2d(embed_dim, 1, 1, device=device)])

    def extract(self, img, refer, r_mask, generator=None):
        feats = self.backbone(img, refer, r_mask, generator=generator)
        return self.neck(feats[1:] if len(feats) == 4 else feats)

    def forward(self, img: torch.Tensor, refer: torch.Tensor,
                r_mask: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """img (B, H, W, 3) normalized, refer (B, T) ids, r_mask (B, T) ->
        the top `max_dets` boxes (B, k, 4) xyxy pixels, scores, labels."""
        return decode_top_k(self.bbox_head(self.extract(img, refer, r_mask)),
                            img.shape[1:3], self.max_dets)

    def aux_seg_loss(self, feat: torch.Tensor, gt_boxes: torch.Tensor,
                     gt_valid: torch.Tensor, hw) -> torch.Tensor:
        """Dice of the branch's sigmoid map on `feat` (B, h, w, C) against
        the union of the valid gt boxes' rectangles, sampled at the cell
        centres in pixels; the mean over the batch."""
        x = feat.permute(0, 3, 1, 2)
        for conv in self.aux_seg_convs[:-1]:
            x = F.relu(conv(x))
        seg = self.aux_seg_convs[-1](x)[:, 0].float()          # (B, h, w)
        H, W = hw
        h, w = seg.shape[1:]
        dev = seg.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * (H / h)
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * (W / w)
        b = gt_boxes.float()[:, None, None]                  # (B, 1, 1, G, 4)
        inside = ((ys[None, :, None, None] >= b[..., 1])
                  & (ys[None, :, None, None] <= b[..., 3])
                  & (xs[None, None, :, None] >= b[..., 0])
                  & (xs[None, None, :, None] <= b[..., 2])
                  & gt_valid.bool()[:, None, None, :])
        target = inside.any(-1).float()
        p = torch.sigmoid(seg)
        inter = (p * target).sum((1, 2))
        dice = 1 - (2 * inter + 1) / (p.sum((1, 2)) + target.sum((1, 2)) + 1)
        return dice.mean()

    def forward_train(self, img, refer, r_mask, gt_boxes, gt_labels,
                      gt_valid, generator: Optional[torch.Generator] = None,
                      dn_draws: Optional[DnDraws] = None,
                      assigner: Assigner = hungarian_assign
                      ) -> Dict[str, torch.Tensor]:
        """The losses on (B, G) pixel xyxy gts (`loss_aux_seg` first where
        the branch is on, then every decoder layer's; the encoder's enter
        `loss` only): DropPath and the denoising noise draw from
        `generator` (or `dn_draws` is used), the assignments come from
        `assigner`."""
        hw = img.shape[1:3]
        feats = self.extract(img, refer, r_mask, generator)
        losses = {}
        if self.with_aux_seg:
            losses["loss_aux_seg"] = self.aux_seg_loss(feats[0], gt_boxes,
                                                       gt_valid, hw)
        head = dino_head_losses(self, feats, hw, gt_boxes, gt_labels,
                                gt_valid, generator, dn_draws, assigner,
                                enc_keys=False)
        if self.with_aux_seg:
            head["loss"] = losses["loss_aux_seg"] + head["loss"]
        losses.update(head)
        return losses


def aug_test_vote(per_scale_results: Sequence[Dict[str, np.ndarray]],
                  top_k: int = 100) -> np.ndarray:
    """Single-box TTA (reference `grounding_dino.py:229-263`, on the host):
    pool the top boxes of every aug; each box's score is raised by its mean
    IoU with the pool; return the argmax box (zeros when no score is
    finite)."""
    boxes = np.concatenate([r["boxes"][:top_k] for r in per_scale_results])
    scores = np.concatenate([r["scores"][:top_k] for r in per_scale_results])
    keep = np.isfinite(scores)
    boxes, scores = boxes[keep], scores[keep]
    if len(boxes) == 0:
        return np.zeros(4, np.float32)
    b = torch.from_numpy(np.ascontiguousarray(boxes, np.float32))
    iou = bbox_overlaps(b, b).numpy()
    vote = scores + iou.mean(axis=1)
    return boxes[int(np.argmax(vote))]
