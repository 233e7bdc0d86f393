"""Region Proposal Network: head, loss and proposals (counterpart of
`vitadapter/det/rpn.py`, mmdet `RPNHead` as the reference Mask R-CNN
configs set it): a shared 3x3 conv, a 1x1 sigmoid classifier over A
anchors and a 1x1 regressor (4A); the loss is sigmoid cross entropy and L1
over 256 anchors sampled an image (half positive at most, assigner
0.7/0.3); proposals are the top 1000 a level, decoded, then one NMS(0.7)
an image into a static budget of 1000."""

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vitadapter_torch.det.anchors import multi_level_anchors
from vitadapter_torch.det.assign import max_iou_assign, random_sample
from vitadapter_torch.det.boxes import (RPN_STDS, bbox2delta, delta2bbox,
                                        nms, stable_top_k)
from vitadapter_torch.layers.linear import Conv2d, conv_nhwc
from vitadapter_torch.parallel.collectives import global_normalizer

FPN_STRIDES = (4, 8, 16, 32, 64)


class RPNHead(nn.Module):
    def __init__(self, num_anchors: int = 3, channels: int = 256,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.rpn_conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype,
                               device=device)
        self.rpn_cls = Conv2d(channels, num_anchors, 1, device=device)
        self.rpn_reg = Conv2d(channels, num_anchors * 4, 1, device=device)

    def forward(self, feats: Sequence[torch.Tensor]):
        """NHWC maps -> (per level (B, H, W, A) fp32 logits, per level
        (B, H, W, 4A) fp32 deltas)."""
        cls_out, reg_out = [], []
        for f in feats:
            x = torch.relu(conv_nhwc(self.rpn_conv, f))
            cls_out.append(conv_nhwc(self.rpn_cls, x))
            reg_out.append(conv_nhwc(self.rpn_reg, x))
        return cls_out, reg_out


def flatten_levels(cls_out, reg_out):
    """Per-level maps -> (B, sum N) scores and (B, sum N, 4) deltas, N =
    H * W * A, anchors fastest."""
    scores = [c.reshape(c.shape[0], -1) for c in cls_out]
    deltas = [r.reshape(r.shape[0], -1, 4) for r in reg_out]
    return torch.cat(scores, 1), torch.cat(deltas, 1)


def rpn_loss(cls_out, reg_out, anchors: torch.Tensor, gt_boxes, gt_valid,
             sampler, img_hw: Tuple[int, int],
             num_samples: int = 256) -> Dict[str, torch.Tensor]:
    """Cross entropy and L1 over the sampled anchors of every image, each
    summed over the batch and divided by the number of samples (counted
    over the global batch: `parallel.global_normalizer`). `sampler`
    gives one uniform a anchor, an image at a time."""
    scores, deltas = flatten_levels(cls_out, reg_out)
    H, W = img_hw
    # anchors outside the image take no part (mmdet allowed_border=0)
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] <= W) & (anchors[:, 3] <= H))
    cls_sum, reg_sum, count = 0.0, 0.0, 0.0
    for b in range(scores.shape[0]):
        assigned, _ = max_iou_assign(anchors, gt_boxes[b], gt_valid[b], 0.7,
                                     0.3, 0.3)
        assigned = torch.where(inside, assigned, -2)
        s = random_sample(sampler(anchors.shape[:1]).to(anchors.device),
                          assigned, num_samples, 0.5)
        w = s.is_valid.float()
        sc = scores[b][s.idx]
        t = s.is_pos.float()
        ce = sc.clamp(min=0) - sc * t + torch.log1p(torch.exp(-sc.abs()))
        target = bbox2delta(anchors[s.idx], gt_boxes[b][s.gt_idx], RPN_STDS)
        l1 = (deltas[b][s.idx] - target).abs().sum(-1)
        cls_sum = cls_sum + (ce * w).sum()
        reg_sum = reg_sum + torch.where(s.is_pos, l1, 0.0).sum()
        count = count + w.sum()
    denom = global_normalizer(torch.as_tensor(count))
    return {"loss_rpn_cls": cls_sum / denom, "loss_rpn_bbox": reg_sum / denom}


def get_proposals(cls_out, reg_out, level_anchors: List[torch.Tensor],
                  img_hw: Tuple[int, int], nms_pre: int = 1000,
                  max_per_img: int = 1000, iou_thr: float = 0.7,
                  min_box_size: float = 0.0):
    """Static-budget proposals: (boxes (B, max_per_img, 4), scores (B,
    max_per_img), valid (B, max_per_img))."""
    B = cls_out[0].shape[0]
    all_boxes, all_scores = [], []
    for c, r, anc in zip(cls_out, reg_out, level_anchors):
        score = c.reshape(B, -1)
        delta = r.reshape(B, -1, 4)
        top_s, top_i = stable_top_k(score, min(nms_pre, score.shape[1]))
        top_d = torch.gather(delta, 1, top_i[..., None].expand(-1, -1, 4))
        all_boxes.append(delta2bbox(anc[top_i], top_d, RPN_STDS,
                                    max_shape=img_hw))
        all_scores.append(top_s)
    boxes = torch.cat(all_boxes, 1)
    scores = torch.sigmoid(torch.cat(all_scores, 1))
    wh_ok = (((boxes[..., 2] - boxes[..., 0]) > min_box_size)
             & ((boxes[..., 3] - boxes[..., 1]) > min_box_size))
    out = [nms(boxes[b], scores[b], iou_thr, max_per_img, valid=wh_ok[b])
           for b in range(B)]
    return (torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out]),
            torch.stack([o[2] >= 0 for o in out]))


def rpn_proposals(rpn_head: RPNHead, feats: Sequence[torch.Tensor],
                  img_hw: Tuple[int, int], num_proposals: int):
    """The RPN on the FPN levels `feats` (strides `FPN_STRIDES`): (cls_out,
    reg_out, the levels' anchors, `get_proposals`' (boxes, scores, valid)
    with `num_proposals` an image, computed without gradient)."""
    cls_out, reg_out = rpn_head(feats)
    anchors = level_anchors([f.shape[1:3] for f in feats], FPN_STRIDES,
                            feats[0].device)
    with torch.no_grad():
        props = get_proposals(cls_out, reg_out, anchors, img_hw,
                              max_per_img=num_proposals)
    return cls_out, reg_out, anchors, props


def level_anchors(feat_shapes, strides, device) -> List[torch.Tensor]:
    """`anchors.multi_level_anchors` as tensors on `device`."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in multi_level_anchors(feat_shapes, strides)]
