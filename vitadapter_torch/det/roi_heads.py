"""RoI heads: the Shared2FC bbox head and the FCN mask head, their losses
and the detection decode (counterpart of `vitadapter/det/roi_heads.py`,
mmdet `Shared2FCBBoxHead` and `FCNMaskHead` as the reference Mask R-CNN
configs set them). Keys are mmdet's (`shared_fcs.N`, `fc_cls`, `fc_reg`,
`convs.N.conv`, `upsample`, `conv_logits`); as in mmdet, the first fc reads
the RoI features channel first."""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vitadapter_torch.det.boxes import (RCNN_STDS, batched_nms, bbox2delta,
                                        delta2bbox, stable_top_k)
from vitadapter_torch.det.necks import ConvModule
from vitadapter_torch.layers.linear import Conv2d, ConvTranspose2d, Linear


class Shared2FCBBoxHead(nn.Module):
    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 roi_size: int = 7, fc_dim: int = 1024,
                 reg_class_agnostic: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.n_reg = 1 if reg_class_agnostic else num_classes
        self.shared_fcs = nn.ModuleList([
            Linear(in_channels * roi_size * roi_size, fc_dim, dtype=dtype,
                   device=device),
            Linear(fc_dim, fc_dim, dtype=dtype, device=device)])
        self.fc_cls = Linear(fc_dim, num_classes + 1, device=device)
        self.fc_reg = Linear(fc_dim, self.n_reg * 4, device=device)

    def forward(self, roi_feats: torch.Tensor):
        """(R, 7, 7, C) -> (class logits (R, K + 1), deltas (R, K or 1, 4)),
        both fp32."""
        R = roi_feats.shape[0]
        x = roi_feats.permute(0, 3, 1, 2).reshape(R, -1)
        for fc in self.shared_fcs:
            x = torch.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x).reshape(R, self.n_reg, 4)


class FCNMaskHead(nn.Module):
    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 channels: int = 256, num_convs: int = 4,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.convs = nn.ModuleList([
            ConvModule(Conv2d(in_channels if i == 0 else channels, channels,
                              3, padding=1, **kw))
            for i in range(num_convs)])
        self.upsample = ConvTranspose2d(channels, channels, 2, stride=2, **kw)
        self.conv_logits = Conv2d(channels, num_classes, 1, device=device)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """(R, 14, 14, C) -> fp32 mask logits (R, K, 28, 28)."""
        x = roi_feats.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = torch.relu(conv(x))
        return self.conv_logits(torch.relu(self.upsample(x)))


def bbox_head_loss(cls_logits, deltas, sample, proposals, gt_boxes,
                   gt_labels, num_classes: int):
    """Softmax cross entropy over the sampled rois and L1 on the positives'
    deltas, both over the valid samples (mmdet defaults). Returns (loss_cls,
    loss_bbox, labels (R,): the gt class of positives, K otherwise)."""
    labels = torch.where(sample.is_pos, gt_labels[sample.gt_idx].long(),
                         num_classes)
    w = sample.is_valid.float()
    nll = -F.log_softmax(cls_logits, dim=-1).gather(1, labels[:, None])[:, 0]
    avg = w.sum().clamp(min=1.0)
    loss_cls = (nll * w).sum() / avg
    target = bbox2delta(proposals[sample.idx], gt_boxes[sample.gt_idx],
                        RCNN_STDS)
    if deltas.shape[1] == 1:
        d = deltas[:, 0]
    else:
        k = labels.clamp(0, num_classes - 1)
        d = deltas.gather(1, k[:, None, None].expand(-1, 1, 4))[:, 0]
    l1 = (d - target).abs().sum(-1)
    loss_reg = torch.where(sample.is_pos, l1, 0.0).sum() / avg
    return loss_cls, loss_reg, labels


def mask_head_loss(mask_logits, sample, labels, targets):
    """Binary cross entropy of each positive roi's gt-class mask (R, K, 28,
    28) against its 28x28 target, averaged over the positives."""
    k = labels.clamp(0, mask_logits.shape[1] - 1)
    logits = mask_logits[torch.arange(len(k), device=k.device), k]
    bce = (logits.clamp(min=0) - logits * targets
           + torch.log1p(torch.exp(-logits.abs())))
    n_pos = sample.is_pos.sum().clamp(min=1)
    return torch.where(sample.is_pos, bce.mean(dim=(1, 2)), 0.0).sum() / n_pos


def decode_detections(cls_logits, deltas, proposals,
                      img_hw: Tuple[int, int], score_thr: float = 0.05,
                      iou_thr: float = 0.5, max_per_img: int = 100,
                      valid: Optional[torch.Tensor] = None):
    """Per-class decode, then class-aware NMS into a static budget (mmdet
    multiclass_nms): (boxes (D, 4), scores (D,), labels (D,), NMS indices),
    -inf and -1 padded."""
    K = cls_logits.shape[-1] - 1
    probs = torch.softmax(cls_logits, dim=-1)[:, :K]
    R = proposals.shape[0]
    if deltas.shape[1] == 1:
        boxes = delta2bbox(proposals, deltas[:, 0], RCNN_STDS, img_hw)
        boxes = boxes[:, None].expand(R, K, 4)
    else:
        boxes = delta2bbox(proposals[:, None].expand(R, K, 4), deltas,
                           RCNN_STDS, img_hw)
    flat_boxes = boxes.reshape(R * K, 4)
    flat_scores = probs.reshape(R * K)
    flat_labels = torch.arange(K, device=probs.device).repeat(R)
    ok = flat_scores > score_thr
    if valid is not None:
        ok = ok & valid.repeat_interleave(K)
    # a static pre-NMS top-k keeps the NMS small
    top_s, top_i = stable_top_k(torch.where(ok, flat_scores, -torch.inf),
                                min(2048, R * K))
    return batched_nms(flat_boxes[top_i], top_s, flat_labels[top_i],
                       iou_thr, max_per_img, valid=torch.isfinite(top_s))
