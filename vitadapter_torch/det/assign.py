"""Target assignment and sampling with static shapes (counterpart of
`vitadapter/det/assign.py`): mmdet `MaxIoUAssigner` and `RandomSampler`
with fixed budgets and validity masks.

The sampler's randomness is one uniform draw per box. Callers take it from
a `Sampler` (`ops/point_sample.py`: a callable shape -> uniform fp32
tensor, by default `uniform_sampler` of an explicit `torch.Generator`),
so that a test can hand it JAX's draws.
"""

from typing import NamedTuple

import torch

from vitadapter_torch.det.boxes import bbox_overlaps, stable_top_k

NEG = -1
IGNORE = -2


def max_iou_assign(boxes: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_valid: torch.Tensor, pos_iou_thr: float = 0.7,
                   neg_iou_thr: float = 0.3, min_pos_iou: float = 0.3,
                   match_low_quality: bool = True):
    """boxes (N, 4), gt_boxes (G, 4), gt_valid (G,) -> (assigned (N,)
    int64: gt index, NEG or IGNORE; max IoU (N,))."""
    iou = bbox_overlaps(boxes, gt_boxes)
    iou = torch.where(gt_valid[None, :], iou, -1.0)
    max_iou = iou.max(dim=1).values
    best_gt = iou.argmax(dim=1)          # the first of equal maxima
    assigned = torch.full(boxes.shape[:1], IGNORE, dtype=torch.long,
                          device=boxes.device)
    assigned = torch.where(max_iou < neg_iou_thr, NEG, assigned)
    assigned = torch.where(max_iou >= pos_iou_thr, best_gt, assigned)
    if match_low_quality:
        # each gt claims its best boxes if IoU >= min_pos_iou; as in mmdet,
        # later gts overwrite earlier ones
        gt_best = iou.max(dim=0).values
        is_best = ((iou == gt_best[None, :]) & gt_valid[None, :]
                   & (iou >= min_pos_iou))
        G = is_best.shape[1]
        last = G - 1 - is_best.flip(1).to(torch.uint8).argmax(dim=1)
        assigned = torch.where(is_best.any(dim=1), last, assigned)
    return assigned, max_iou


class SampleResult(NamedTuple):
    idx: torch.Tensor        # (num,) sampled box indices
    is_pos: torch.Tensor     # (num,) bool
    is_valid: torch.Tensor   # (num,) bool (false: a padding slot)
    gt_idx: torch.Tensor     # (num,) assigned gt of positives (0 otherwise)


def random_sample(draws: torch.Tensor, assigned: torch.Tensor, num: int,
                  pos_fraction: float = 0.5) -> SampleResult:
    """Sample `num` boxes: up to num * pos_fraction positives, the rest
    negatives, uniformly without replacement: the boxes of each kind with
    the largest `draws` (N,) uniforms, positives first."""
    num_pos = int(num * pos_fraction)
    is_pos = assigned >= 0
    is_neg = assigned == NEG
    _, pos_idx = stable_top_k(torch.where(is_pos, draws, -torch.inf),
                              num_pos)
    pos_ok = is_pos[pos_idx]
    n_pos = pos_ok.sum()
    _, neg_idx = stable_top_k(torch.where(is_neg, draws, -torch.inf), num)
    neg_ok = is_neg[neg_idx]
    # exactly num - n_pos negatives
    neg_take = neg_ok & (torch.cumsum(neg_ok.long(), 0) - 1 < num - n_pos)
    idx = torch.cat([pos_idx, neg_idx])
    keep = torch.cat([pos_ok, neg_take])
    pos_flag = torch.cat([pos_ok, torch.zeros_like(neg_take)])
    slot = torch.where(keep, torch.cumsum(keep.long(), 0) - 1,
                       num).clamp(max=num)
    dev = assigned.device

    def packed(src):
        out = torch.zeros(num + 1, dtype=torch.long, device=dev)
        return out.scatter(0, slot, src.long())[:num]

    out_idx = packed(idx)
    gt_idx = assigned[out_idx].clamp(min=0)
    return SampleResult(out_idx, packed(pos_flag).bool(), packed(keep).bool(),
                        gt_idx)
