"""Box primitives: deltas, IoU and NMS with static output budgets
(counterpart of `vitadapter/det/boxes.py`, mmdet `DeltaXYWHBBoxCoder` and
`bbox_overlaps`).

As in the JAX package, a variable number of kept boxes becomes a fixed
budget padded with -1 indices. The greedy suppression is `ops/nms.py`
(the kernel on the card); sorting is stable, so equal scores keep their
index order as JAX's `argsort` and `top_k` keep it.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from vitadapter_torch.ops.nms import bbox_area, bbox_overlaps, nms_keep

__all__ = ["RPN_STDS", "RCNN_STDS", "bbox_area", "bbox_overlaps",
           "bbox2delta", "delta2bbox", "stable_top_k", "nms", "batched_nms"]

# mmdet's target stds for the RPN and the RCNN
RPN_STDS = (1.0, 1.0, 1.0, 1.0)
RCNN_STDS = (0.1, 0.1, 0.2, 0.2)


def stable_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """`jax.lax.top_k` over the last axis: the k largest, equal values in
    index order."""
    _, idx = torch.sort(-x, dim=-1, stable=True)
    idx = idx[..., :k]
    return torch.gather(x, -1, idx), idx


def bbox2delta(proposals: torch.Tensor, gt: torch.Tensor,
               stds=RPN_STDS) -> torch.Tensor:
    """Encode gt relative to proposals (mmdet bbox2delta, means 0)."""
    pw = proposals[..., 2] - proposals[..., 0]
    ph = proposals[..., 3] - proposals[..., 1]
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    s = [float(np.float32(v)) for v in stds]
    dx = (gx - px) / pw.clamp(min=1e-6) / s[0]
    dy = (gy - py) / ph.clamp(min=1e-6) / s[1]
    dw = torch.log(gw.clamp(min=1e-6) / pw.clamp(min=1e-6)) / s[2]
    dh = torch.log(gh.clamp(min=1e-6) / ph.clamp(min=1e-6)) / s[3]
    return torch.stack([dx, dy, dw, dh], dim=-1)


def delta2bbox(rois: torch.Tensor, deltas: torch.Tensor, stds=RPN_STDS,
               max_shape: Optional[Tuple[int, int]] = None,
               wh_ratio_clip: float = 16 / 1000) -> torch.Tensor:
    """Decode deltas on rois (mmdet delta2bbox: wh clamp, optional clip to
    max_shape (H, W))."""
    s = [float(np.float32(v)) for v in stds]
    dx, dy = deltas[..., 0] * s[0], deltas[..., 1] * s[1]
    dw, dh = deltas[..., 2] * s[2], deltas[..., 3] * s[3]
    max_ratio = float(np.abs(np.log(np.float32(wh_ratio_clip))))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    pw = rois[..., 2] - rois[..., 0]
    ph = rois[..., 3] - rois[..., 1]
    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    out = torch.stack([gx - gw * 0.5, gy - gh * 0.5,
                       gx + gw * 0.5, gy + gh * 0.5], dim=-1)
    if max_shape is not None:
        h, w = max_shape
        out = torch.stack([out[..., 0].clamp(0, w), out[..., 1].clamp(0, h),
                           out[..., 2].clamp(0, w), out[..., 3].clamp(0, h)],
                          dim=-1)
    return out


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
        max_out: int, valid: Optional[torch.Tensor] = None,
        score_thr: float = -float("inf")):
    """Greedy NMS with a static output budget: boxes (N, 4), scores (N,)
    -> (kept boxes (max_out, 4), their scores (max_out,), their indices
    (max_out,) int64, -1 padded). Invalid boxes and scores not above
    `score_thr` take no part."""
    if valid is not None:
        scores = torch.where(valid, scores, -torch.inf)
    scores = torch.where(scores > score_thr, scores, -torch.inf)
    order = torch.sort(-scores, stable=True)[1]
    keep = nms_keep(boxes[order].float(), torch.isfinite(scores[order]),
                    iou_thr)
    # the kept entries to the front, in score order
    rank = torch.cumsum(keep.long(), 0) - 1
    slot = torch.where(keep, rank, max_out).clamp(max=max_out)
    keep_idx = torch.full((max_out + 1,), -1, dtype=torch.long,
                          device=boxes.device)
    keep_idx = keep_idx.scatter(0, slot, order)[:max_out]
    kept = keep_idx >= 0
    safe = keep_idx.clamp(min=0)
    out_boxes = torch.where(kept[:, None], boxes[safe], 0.0)
    out_scores = torch.where(kept, scores[safe], -torch.inf)
    return out_boxes, out_scores, keep_idx


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                labels: torch.Tensor, iou_thr: float, max_out: int,
                valid: Optional[torch.Tensor] = None,
                score_thr: float = -float("inf")):
    """Class-aware NMS by the coordinate-offset trick (mmdet batched_nms):
    (boxes, scores, labels (-1 padded), indices)."""
    offset = labels.to(boxes.dtype)[:, None] * (boxes.max() + 1.0)
    _, out_scores, keep_idx = nms(boxes + offset, scores, iou_thr, max_out,
                                  valid, score_thr)
    kept = keep_idx >= 0
    safe = keep_idx.clamp(min=0)
    out_boxes = torch.where(kept[:, None], boxes[safe], 0.0)
    out_labels = torch.where(kept, labels[safe], -1)
    return out_boxes, out_scores, out_labels, keep_idx
