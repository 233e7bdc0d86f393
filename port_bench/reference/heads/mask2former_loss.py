"""Mask2Former training loss: Hungarian-matched classification plus
point-sampled mask and dice losses (counterpart of
`vitadapter/heads/mask2former_loss.py`, with its dtypes).

Random draws come from a `sampler`, a callable (shape) -> uniform [0, 1)
fp32 tensor (`ops.point_sample.uniform_sampler` draws from a
`torch.Generator`); in each call the assignment points of all layers are
drawn first, then each layer's oversampled pool and fresh points. Gt
indicator maps are bf16 ({0, 1} is exact), predicted masks are sampled in
bf16, the sampled coordinates carry no gradient and the assignment costs
are computed without one. The assignment is the device auction
(`ops.matching.hungarian_assign`), one launch for all layers and images.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference.ops.matching import (bce_mask_cost,
                                               classification_cost,
                                               dice_cost, hungarian_assign)
from port_bench.reference.ops.point_sample import (
    Sampler, get_uncertain_point_coords, point_sample, sort_points_by_y)


def present_classes(label_map: torch.Tensor, num_classes: int,
                    max_instances: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image present class ids in ascending order, padded: label_map
    (B, H, W) int with 255 = ignore -> (labels (B, G) int64, valid (B, G)
    bool), G = min(num_classes, max_instances)."""
    B = label_map.shape[0]
    flat = label_map.reshape(B, -1).long()
    inside = (flat >= 0) & (flat < num_classes)
    idx = torch.where(inside, flat, num_classes)
    count = torch.zeros((B, num_classes + 1), dtype=torch.int64,
                        device=label_map.device)
    count.scatter_add_(1, idx, torch.ones_like(idx))
    present = count[:, :num_classes] > 0
    order = torch.argsort((~present).to(torch.int8), dim=-1, stable=True)
    labels = order[:, :max_instances]
    valid = present.gather(1, order)[:, :max_instances]
    return labels, valid


def _indicator(label_map: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B, H, W) label map, (B, G) class ids -> (B * G, H, W) bf16 {0, 1}."""
    B, H, W = label_map.shape
    ind = label_map[:, None] == labels[:, :, None, None]
    return ind.to(torch.bfloat16).reshape(-1, H, W)


def sample_gt_points(label_map: torch.Tensor, points: torch.Tensor,
                     gt_labels: torch.Tensor) -> torch.Tensor:
    """Bilinear gt-indicator values of each gt class at the points of its
    image: label_map (B, H, W), points (B, P, 2), gt_labels (B, G) ->
    (B, G, P) fp32. The G maps of an image share its point set."""
    B, G = gt_labels.shape
    P = points.shape[1]
    out = point_sample(_indicator(label_map, gt_labels), points.contiguous())
    return out.reshape(B, G, P)


def _assign_all_layers(sampler: Sampler, cls_all: torch.Tensor,
                       mask_all: torch.Tensor, label_map: torch.Tensor,
                       gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                       num_points: int, cost_cls: float, cost_mask: float,
                       cost_dice: float):
    """Hungarian assignments of all decoder layers in one pass: cls_all
    (L, B, Q, K+1), mask_all (L, B, Q, h, w) -> ((L, B, Q) gt index or -1,
    the costs (L * B, Q, G), the valid gts of each matrix (L * B,)).
    Every query's mask is sampled at its image's points, one point set per
    (layer, image) shared by its Q masks; the gt maps are built once and
    sampled at all layers' points in one call."""
    L, B, Q = cls_all.shape[:3]
    G = gt_labels.shape[1]
    h, w = mask_all.shape[3:]
    P = num_points
    dev = mask_all.device
    with torch.no_grad():
        coords = sort_points_by_y(sampler((L, B, P, 2)).to(dev))
        pred_pts = point_sample(
            mask_all.to(torch.bfloat16).reshape(L * B * Q, h, w),
            coords.reshape(L * B, P, 2), sorted_by_y=True).reshape(
                L * B, Q, P)
        c_lp = coords.transpose(0, 1).reshape(B, L * P, 2)
        gt_pts = sample_gt_points(label_map, c_lp, gt_labels)
        gt_pts = gt_pts.reshape(B, G, L, P).permute(2, 0, 1, 3)
        gt_pts = gt_pts.reshape(L * B, G, P)
        labels = gt_labels.repeat(L, 1)
        cost = (classification_cost(cls_all.reshape(L * B, Q, -1), labels,
                                    cost_cls)
                + bce_mask_cost(pred_pts, gt_pts, cost_mask)
                + dice_cost(pred_pts, gt_pts, cost_dice))
        n_valid = gt_valid.sum(-1).repeat(L)
        return (hungarian_assign(cost, n_valid).reshape(L, B, Q), cost,
                n_valid)


def matching_gap(cost: torch.Tensor, n_valid: torch.Tensor,
                 given: torch.Tensor, own: torch.Tensor) -> torch.Tensor:
    """How far the matches `given` (B, Q) lie above `own` on the costs
    (B, Q, G), in units of the auction's bound n_valid * eps (eps = the
    largest valid |cost| / 2000), worst matrix; infinite where `given` is
    not a matching of every valid gt to one query."""
    B, Q, G = cost.shape
    ig = torch.arange(G, device=cost.device)
    valid = ig[None] < n_valid[:, None]
    hits = (given[:, :, None] == ig[None, None]).sum(1)          # (B, G)
    ok = ((hits == valid.long()).all(-1)
          & ((given < 0) | (given < n_valid[:, None])).all(-1))

    def total(a):
        c = cost.gather(2, a.clamp(min=0)[..., None])[..., 0]
        return torch.where(a >= 0, c, 0.0).sum(-1)

    span = torch.where(valid[:, None, :], cost.abs(), 0.0).amax((1, 2))
    unit = (n_valid * span / 2000.0).clamp(min=1e-12)
    gap = (total(given) - total(own)) / unit
    return torch.where(ok, gap, float("inf")).max()


def _keys(points: torch.Tensor) -> torch.Tensor:
    """One int64 key for each (row, x, y) of points (N, P, 2) fp32."""
    bits = points.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    row = torch.arange(points.shape[0], device=points.device)[:, None]
    return (bits[..., 0] * 4294967311 + bits[..., 1]
            + row * 1000000007) & 0x7FFFFFFFFFFFFFFF


def points_gap(given: torch.Tensor, own: torch.Tensor,
               n_important: int) -> torch.Tensor:
    """The share of the important points of `given` (N, P, 2) that `own`
    did not choose; infinite where the fresh uniform points after them
    differ (the same draws give the same points)."""
    if given.shape != own.shape or not torch.equal(
            given[:, n_important:], own[:, n_important:]):
        return torch.tensor(float("inf"))
    g = _keys(given[:, :n_important]).reshape(-1)
    o = _keys(own[:, :n_important]).reshape(-1)
    return 1.0 - torch.isin(g, o).float().mean()


def loss_single_layer(
    sampler: Sampler,
    cls_pred: torch.Tensor,      # (B, Q, K+1)
    mask_pred: torch.Tensor,     # (B, Q, h, w) logits
    label_map: torch.Tensor,     # (B, H, W) int, 255 ignore
    gt_labels: torch.Tensor,     # (B, G)
    gt_valid: torch.Tensor,      # (B, G)
    num_classes: int,
    *,
    assign: torch.Tensor,        # (B, Q) gt index or -1
    points: torch.Tensor = None,  # another run's uncertain points, to follow
    num_points: int = 12544,
    oversample_ratio: float = 3.0,
    importance_sample_ratio: float = 0.75,
    bg_weight: float = 0.1,
    loss_cls_weight: float = 2.0,
    loss_mask_weight: float = 5.0,
    loss_dice_weight: float = 5.0,
) -> Dict[str, torch.Tensor]:
    """One decoder layer's losses for the layer's assignment `assign`: CE
    with background weight 0.1, point BCE and naive dice over the matched
    queries, normalized by the number of matched masks. Both normalizers
    count over the global batch (`parallel.global_normalizer`)."""
    B, Q = cls_pred.shape[:2]
    h, w = mask_pred.shape[2:]
    pos = assign >= 0
    safe_idx = assign.clamp(min=0)
    labels = torch.where(pos, gt_labels.gather(1, safe_idx), num_classes)

    # classification CE with a background down-weight
    class_weight = torch.ones(num_classes + 1, device=cls_pred.device)
    class_weight[num_classes] = bg_weight
    logp = F.log_softmax(cls_pred.float(), dim=-1)
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    wgt = class_weight[labels]
    avg_factor = wgt.sum().clamp(min=1.0)
    loss_cls = (nll * wgt).sum() / avg_factor * loss_cls_weight

    # mask losses on the matched queries, at uncertainty-sampled points
    num_total_masks = pos.sum().float().clamp(min=1.0)
    with torch.no_grad():
        coords = get_uncertain_point_coords(
            sampler, mask_pred.detach().to(torch.bfloat16).reshape(
                B * Q, h, w), num_points, oversample_ratio,
            importance_sample_ratio)
        point_gap = torch.zeros(())
        if points is not None:
            point_gap = points_gap(points.to(coords.device), coords,
                                   int(importance_sample_ratio * num_points))
            if points.shape == coords.shape:
                coords = points.to(coords.device)
        used = coords
        coords = sort_points_by_y(coords.reshape(B, Q, num_points, 2))
    pred_pts = point_sample(
        mask_pred.to(torch.bfloat16).reshape(B * Q, h, w),
        coords.reshape(B * Q, num_points, 2), sorted_by_y=True).reshape(
            B, Q, num_points)
    # gt indicator of each query's class at its own points
    q_labels = torch.where(pos, labels, num_classes + 1)  # never matches
    gt_pts = point_sample(_indicator(label_map, q_labels),
                          coords.reshape(B * Q, num_points, 2),
                          sorted_by_y=True)
    gt_f = gt_pts.reshape(B, Q, num_points)

    pred_f = pred_pts.float()
    # naive dice (reference DiceLoss naive_dice=True, eps=1)
    pred_sig = torch.sigmoid(pred_f)
    numer = 2 * pred_sig * gt_f
    dice = 1 - (numer.sum(-1) + 1.0) / (pred_sig.sum(-1) + gt_f.sum(-1) + 1.0)
    loss_dice = (torch.where(pos, dice, 0.0).sum() / num_total_masks
                 * loss_dice_weight)
    # point BCE with logits, averaged over num_total_masks * num_points
    bce = F.softplus(pred_f) - pred_f * gt_f
    bce = torch.where(pos[..., None], bce, 0.0).sum()
    loss_mask = bce / (num_total_masks * num_points) * loss_mask_weight
    return {"loss_cls": loss_cls, "loss_mask": loss_mask,
            "loss_dice": loss_dice, "point_gap": point_gap, "points": used}


def mask2former_loss(
    sampler: Sampler,
    cls_list: Sequence[torch.Tensor],
    mask_list: Sequence[torch.Tensor],
    label_map: torch.Tensor,
    num_classes: int,
    max_instances: int = 60,
    assign: torch.Tensor = None,
    points=None,
    **kwargs,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sum of the per-decoder-layer losses, every layer weighted equally;
    the last layer's logged as loss_*, the others as d{i}.loss_*. With
    `assign` (L, B, Q), the losses follow those matches (another run's,
    judged here), and `match_gap` logs how far their cost lies above
    this function's own matches' on its own costs; `assign` logs the
    matches the losses followed, `cost` and `n_valid` what this function's
    own matches were chosen from. With `points`, each layer's uncertain
    points (B * Q, P, 2) of another run, the mask losses are read there
    and `point_gap` logs the worst layer's share of them this function
    would not have chosen."""
    gt_labels, gt_valid = present_classes(label_map, num_classes,
                                          max_instances)
    own, cost, n_valid = _assign_all_layers(
        sampler, torch.stack([c.detach() for c in cls_list]),
        torch.stack([m.detach() for m in mask_list]),
        label_map, gt_labels, gt_valid,
        num_points=kwargs.get("num_points", 12544),
        cost_cls=kwargs.get("loss_cls_weight", 2.0),
        cost_mask=kwargs.get("loss_mask_weight", 5.0),
        cost_dice=kwargs.get("loss_dice_weight", 5.0))
    gap = torch.zeros(())
    assign_all = own
    if assign is not None and assign.numel() != own.numel():
        gap = torch.tensor(float("inf"))
    elif assign is not None:
        L, B, Q = own.shape
        assign_all = assign.to(own.device).reshape(L, B, Q)
        gap = matching_gap(cost, n_valid, assign_all.reshape(L * B, Q),
                           own.reshape(L * B, Q))
    total = 0.0
    logs: Dict[str, torch.Tensor] = {"match_gap": gap, "assign": assign_all,
                                     "cost": cost, "n_valid": n_valid}
    n = len(cls_list)
    for i, (cls_p, mask_p) in enumerate(zip(cls_list, mask_list)):
        out = loss_single_layer(sampler, cls_p, mask_p, label_map, gt_labels,
                                gt_valid, num_classes, assign=assign_all[i],
                                points=None if points is None else points[i],
                                **kwargs)
        logs["point_gap"] = torch.maximum(
            logs.get("point_gap", torch.zeros(())).to(out["point_gap"]),
            out.pop("point_gap"))
        logs.setdefault("points", []).append(out.pop("points"))
        total = total + out["loss_cls"] + out["loss_mask"] + out["loss_dice"]
        if i == n - 1:
            logs.update(out)
        else:
            logs.update({f"d{i}.{k}": v for k, v in out.items()})
    return total, logs
