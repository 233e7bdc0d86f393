"""Bipartite matching for the set-prediction losses in plain PyTorch: the
costs of the reference `MaskHungarianAssigner` and the epsilon auction
(Bertsekas; the gts bid for the queries, eps = span / 2000), all matrices
in lockstep."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

EPS_DIV = 2000.0
MAX_ITERS = 5000
NEG = -1e30


def auction_assign_plain(cost: torch.Tensor, n_valid: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The auction of `auction_pallas._auction_kernel`, all matrices in
    lockstep: cost (B, Q, G) fp32, n_valid (B,) -> (owner (B, Q) int64, the
    matched gt of each query or -1; rounds run per matrix (B,) int64)."""
    B, Q, G = cost.shape
    dev = cost.device
    owner = torch.full((B, Q), -1, dtype=torch.int64, device=dev)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)
    if G == 0 or Q == 0:
        return owner, iters
    ig = torch.arange(G, device=dev)
    iq = torch.arange(Q, device=dev)
    gt_ok = ig[None] < n_valid.to(dev)[:, None]                  # (B, G)
    ben = torch.where(gt_ok[:, :, None], -cost.float().transpose(1, 2),
                      NEG)                                         # (B, G, Q)
    span = torch.where(ben > NEG / 2, ben.abs(), 0.0).amax(
        dim=(1, 2)).clamp(min=1e-6)[:, None]                       # (B, 1)
    # a tensor divisor: on CUDA a scalar one is applied as a product with
    # its reciprocal, one ulp off the division the kernel and JAX make, and
    # on contested costs one ulp of eps changes the matches
    eps = span / torch.full_like(span, EPS_DIV)
    price = torch.zeros((B, Q), dtype=torch.float32, device=dev)
    for _ in range(MAX_ITERS):
        assigned = (owner[:, None, :] == ig[None, :, None]).any(-1)
        free = gt_ok & ~assigned                                   # (B, G)
        active = free.any(-1)
        if not bool(active.any()):
            break
        iters += active
        values = ben - price[:, None, :]
        best_v = values.amax(-1)
        best_q = torch.where(values >= best_v[..., None], iq, Q).amin(-1)
        is_best = iq == best_q[..., None]                          # (B, G, Q)
        second_v = torch.where(is_best, NEG, values).amax(-1)
        second_v = torch.where(second_v > NEG / 2, second_v, best_v - span)
        bid = price.gather(1, best_q) + (best_v - second_v) + eps  # (B, G)
        bids = is_best & free[..., None]
        bid_mat = torch.where(bids, bid[..., None], float("-inf"))
        item_bid = bid_mat.amax(1)                                 # (B, Q)
        has_bid = item_bid > float("-inf")
        win = torch.where(bids & (bid_mat >= item_bid[:, None]),
                          ig[None, :, None], G).amin(1)
        owner = torch.where(has_bid, win, owner)
        price = torch.where(has_bid, item_bid, price)
    return owner, iters


def hungarian_assign(cost: torch.Tensor, n_valid: torch.Tensor
                     ) -> torch.Tensor:
    """cost (B, Q, G) fp32, n_valid (B,) -> (B, Q) int64, the matched gt of
    each query or -1."""
    return auction_assign_plain(cost, n_valid)[0]


def classification_cost(cls_logits: torch.Tensor, gt_labels: torch.Tensor,
                        weight: float = 1.0) -> torch.Tensor:
    """-softmax prob of each gt class. cls_logits (..., Q, K+1), gt_labels
    (..., G) -> (..., Q, G)."""
    prob = torch.softmax(cls_logits.float(), dim=-1)
    Q = prob.shape[-2]
    idx = gt_labels[..., None, :].expand(*gt_labels.shape[:-1], Q,
                                         gt_labels.shape[-1])
    return -prob.gather(-1, idx) * weight


def bce_mask_cost(pred_pts: torch.Tensor, gt_pts: torch.Tensor,
                  weight: float = 1.0) -> torch.Tensor:
    """Pairwise binary CE between mask logits and binary gt masks at the
    sampled points. pred_pts (..., Q, P), gt_pts (..., G, P) -> (..., Q,
    G)."""
    P = pred_pts.shape[-1]
    pred = pred_pts.float()
    gt = gt_pts.float().transpose(-1, -2)
    pos = F.softplus(-pred)          # -log sigmoid(x)
    neg = F.softplus(pred)           # -log (1 - sigmoid(x))
    cost = pos @ gt + neg @ (1 - gt)
    return cost / P * weight


def dice_cost(pred_pts: torch.Tensor, gt_pts: torch.Tensor,
              weight: float = 1.0, eps: float = 1.0) -> torch.Tensor:
    """Pairwise naive-dice cost at the sampled points. (..., Q, P),
    (..., G, P) -> (..., Q, G)."""
    p = torch.sigmoid(pred_pts.float())
    g = gt_pts.float()
    numer = 2 * (p @ g.transpose(-1, -2))
    denom = p.sum(-1)[..., :, None] + g.sum(-1)[..., None, :]
    return (1 - (numer + eps) / (denom + eps)) * weight
