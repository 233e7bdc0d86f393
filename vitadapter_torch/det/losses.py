"""Detection losses and matching costs of the DETR/DINO family
(counterpart of `vitadapter/det/losses.py`).

Parity targets: mmdet `FocalLoss` (sigmoid, alpha .25, gamma 2),
`GIoULoss`, `L1Loss`, and the match costs of the reference DINO config
(FocalLossCost 2.0 / BBoxL1Cost 5.0 / IoUCost giou 2.0). All in fp32.
"""

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0
                       ) -> torch.Tensor:
    """Per-element focal loss; targets in {0, 1} (same shape as logits)."""
    p = torch.sigmoid(logits)
    ce = (logits.clamp(min=0) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return a_t * (1 - p_t) ** gamma * ce


def giou(boxes1: torch.Tensor, boxes2: torch.Tensor,
         eps: float = 1e-7) -> torch.Tensor:
    """Generalized IoU of aligned xyxy box pairs (..., 4)."""
    area1 = ((boxes1[..., 2] - boxes1[..., 0]).clamp(min=0)
             * (boxes1[..., 3] - boxes1[..., 1]).clamp(min=0))
    area2 = ((boxes2[..., 2] - boxes2[..., 0]).clamp(min=0)
             * (boxes2[..., 3] - boxes2[..., 1]).clamp(min=0))
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    iou = inter / union.clamp(min=eps)
    # the smallest enclosing box
    lt_e = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb_e = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh_e = (rb_e - lt_e).clamp(min=0)
    enclose = (wh_e[..., 0] * wh_e[..., 1]).clamp(min=eps)
    return iou - (enclose - union) / enclose


def giou_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) GIoU matrix."""
    return giou(a[..., :, None, :], b[..., None, :, :])


def cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def focal_cost(cls_logits: torch.Tensor, gt_labels: torch.Tensor,
               weight: float = 1.0, alpha: float = 0.25, gamma: float = 2.0,
               eps: float = 1e-8) -> torch.Tensor:
    """mmdet FocalLossCost, pos_cost - neg_cost of each (query, gt):
    cls_logits (..., Q, K) sigmoid logits, gt_labels (..., G) ->
    (..., Q, G)."""
    p = torch.sigmoid(cls_logits.float())
    neg = (1 - alpha) * p ** gamma * -torch.log(1 - p + eps)
    pos = alpha * (1 - p) ** gamma * -torch.log(p + eps)
    d = pos - neg
    idx = gt_labels[..., None, :].expand(*d.shape[:-1], gt_labels.shape[-1])
    return d.gather(-1, idx.long()) * weight


def bbox_l1_cost(pred_cxcywh: torch.Tensor, gt_cxcywh: torch.Tensor,
                 weight: float = 1.0) -> torch.Tensor:
    """(..., Q, 4) x (..., G, 4) normalized cxcywh -> (..., Q, G) L1 cost."""
    return (pred_cxcywh[..., :, None, :] - gt_cxcywh[..., None, :, :]
            ).abs().sum(-1) * weight


def giou_cost(pred_xyxy: torch.Tensor, gt_xyxy: torch.Tensor,
              weight: float = 1.0) -> torch.Tensor:
    return -giou_pairwise(pred_xyxy, gt_xyxy) * weight


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x) - torch.log1p(-x)


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """`jax.nn.one_hot` in fp32: rows of labels outside [0, num_classes)
    are all zero (the background label `num_classes` among them)."""
    ok = (labels >= 0) & (labels < num_classes)
    oh = F.one_hot(torch.where(ok, labels, 0).long(), num_classes).float()
    return oh * ok[..., None]
