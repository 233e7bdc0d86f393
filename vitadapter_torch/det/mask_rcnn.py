"""Mask R-CNN: backbone -> FPN -> RPN -> RoI heads (counterpart of
`vitadapter/det/mask_rcnn.py`, mmdet `MaskRCNN` as the reference
`mask_rcnn_deit_adapter_tiny_fpn_3x_coco.py` sets it): FPN with 5 outputs
(or `ChannelMapperWithPooling`), the RPN with anchor scale 8 and ratios
0.5/1/2, the Shared2FC bbox head (assigner 0.5/0.5, 512 sampled rois a
quarter positive, gts added as proposals) and the FCN mask head at 28x28.
Budgets are static: 1000 proposals, 512 sampled rois, 100 detections.

`forward(image)` is the test path, `forward_train(...)` the losses. Images
are NHWC, normalized, H and W multiples of 32. The model runs on the
device of its parameters; the RoI stages take one image at a time.
"""

from typing import Dict, Optional

import torch
from torch import nn

from vitadapter_torch.det.assign import max_iou_assign, random_sample
from vitadapter_torch.det.necks import FPN, ChannelMapperWithPooling
from vitadapter_torch.det.roi_align import (crop_resize_masks,
                                            multi_level_roi_align)
from vitadapter_torch.det.roi_heads import (FCNMaskHead, Shared2FCBBoxHead,
                                            bbox_head_loss,
                                            decode_detections,
                                            mask_head_loss)
from vitadapter_torch.det.rpn import (RPNHead, get_proposals, level_anchors,
                                      rpn_loss)
from vitadapter_torch.ops.point_sample import Sampler, uniform_sampler

FPN_STRIDES = (4, 8, 16, 32, 64)
LOSS_KEYS = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox",
             "loss_mask")


class MaskRCNN(nn.Module):
    def __init__(self, backbone: nn.Module, num_classes: int = 80,
                 fpn_channels: int = 256, num_proposals_test: int = 1000,
                 num_proposals_train: int = 1000, num_roi_samples: int = 512,
                 max_dets: int = 100, neck_type: str = "fpn",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if neck_type not in ("fpn", "channel_mapper"):
            raise ValueError(f"neck_type {neck_type!r}: 'fpn' or "
                             "'channel_mapper'")
        self.backbone = backbone
        self.num_classes = num_classes
        self.num_proposals_test = num_proposals_test
        self.num_proposals_train = num_proposals_train
        self.num_roi_samples = num_roi_samples
        self.max_dets = max_dets
        dim = backbone.embed_dim
        neck = FPN if neck_type == "fpn" else ChannelMapperWithPooling
        self.neck = neck([dim] * 4, fpn_channels, num_outs=5, dtype=dtype,
                         device=device)
        self.rpn_head = RPNHead(3, fpn_channels, dtype=dtype, device=device)
        self.roi_head = nn.Module()
        self.roi_head.bbox_head = Shared2FCBBoxHead(
            num_classes, fpn_channels, dtype=dtype, device=device)
        self.roi_head.mask_head = FCNMaskHead(
            num_classes, fpn_channels, fpn_channels, dtype=dtype,
            device=device)

    def extract_feats(self, img, generator=None):
        return self.neck(self.backbone(img, generator=generator))

    def _rpn(self, feats, img_hw, num_proposals):
        cls_out, reg_out = self.rpn_head(feats)
        anchors = level_anchors([f.shape[1:3] for f in feats], FPN_STRIDES,
                                feats[0].device)
        with torch.no_grad():
            props = get_proposals(cls_out, reg_out, anchors, img_hw,
                                  max_per_img=num_proposals)
        return cls_out, reg_out, anchors, props

    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The test path: {"boxes" (B, D, 4), "scores" (B, D), "labels"
        (B, D), "masks" (B, D, 28, 28) probabilities of each box's class in
        its box frame}, D = max_dets, -inf scores and -1 labels padded."""
        B, H, W, _ = img.shape
        feats = self.extract_feats(img)
        _, _, _, (props, _, p_valid) = self._rpn(
            feats, (H, W), self.num_proposals_test)
        heads = self.roi_head
        out = {k: [] for k in ("boxes", "scores", "labels", "masks")}
        for b in range(B):
            fb = [f[b] for f in feats[:4]]
            roi_feats = multi_level_roi_align(fb, props[b], 7,
                                              FPN_STRIDES[:4])
            cls_logits, deltas = heads.bbox_head(roi_feats)
            boxes, scores, labels, _ = decode_detections(
                cls_logits, deltas, props[b], (H, W),
                max_per_img=self.max_dets, valid=p_valid[b])
            mask_logits = heads.mask_head(multi_level_roi_align(
                fb, boxes, 14, FPN_STRIDES[:4]))
            k = labels.clamp(0, self.num_classes - 1)
            masks = torch.sigmoid(
                mask_logits[torch.arange(len(k), device=k.device), k])
            for key, v in (("boxes", boxes), ("scores", scores),
                           ("labels", labels), ("masks", masks)):
                out[key].append(v)
        return {k: torch.stack(v) for k, v in out.items()}

    def forward_train(self, img: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_labels: torch.Tensor, gt_masks: torch.Tensor,
                      gt_valid: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      sampler: Optional[Sampler] = None
                      ) -> Dict[str, torch.Tensor]:
        """The losses of a batch: gt_boxes (B, G, 4), gt_labels (B, G),
        gt_masks (B, G, H, W) 0/1 (bool is read as it is), gt_valid (B, G).
        DropPath draws from `generator`; the RPN's and the RoI sampler's
        uniforms from `sampler` (by default `uniform_sampler(generator)`),
        the RPN's of every image first, then the RoI sampler's. Returns
        the five losses and their sum `loss`."""
        B, H, W, _ = img.shape
        if sampler is None:
            sampler = uniform_sampler(generator)
        feats = self.extract_feats(img, generator)
        cls_out, reg_out, anchors, (props, _, p_valid) = self._rpn(
            feats, (H, W), self.num_proposals_train)
        losses = rpn_loss(cls_out, reg_out, torch.cat(anchors), gt_boxes,
                          gt_valid, sampler, (H, W))
        heads = self.roi_head
        parts = {"loss_cls": [], "loss_bbox": [], "loss_mask": []}
        for b in range(B):
            gtb, gtv = gt_boxes[b], gt_valid[b]
            # the gts join the proposals (mmdet add_gt_as_proposals)
            rois = torch.cat([props[b], gtb])
            roi_valid = torch.cat([p_valid[b], gtv])
            assigned, _ = max_iou_assign(rois, gtb, gtv, 0.5, 0.5, 0.5,
                                         match_low_quality=False)
            assigned = torch.where(roi_valid, assigned, -2)
            s = random_sample(sampler(rois.shape[:1]).to(img.device),
                              assigned, self.num_roi_samples, 0.25)
            fb = [f[b] for f in feats[:4]]
            sel = rois[s.idx]
            cls_logits, deltas = heads.bbox_head(multi_level_roi_align(
                fb, sel, 7, FPN_STRIDES[:4]))
            loss_cls, loss_reg, labels = bbox_head_loss(
                cls_logits, deltas, s, rois, gtb, gt_labels[b],
                self.num_classes)
            mask_logits = heads.mask_head(multi_level_roi_align(
                fb, sel, 14, FPN_STRIDES[:4]))
            targets = crop_resize_masks(gt_masks[b], sel, s.gt_idx, 28)
            parts["loss_cls"].append(loss_cls)
            parts["loss_bbox"].append(loss_reg)
            parts["loss_mask"].append(mask_head_loss(mask_logits, s, labels,
                                                     targets))
        losses.update({k: torch.stack(v).mean() for k, v in parts.items()})
        losses["loss"] = sum(losses[k] for k in LOSS_KEYS)
        return losses
