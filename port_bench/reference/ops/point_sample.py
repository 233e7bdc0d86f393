"""Bilinear point sampling for the mask losses (PointRend style) in plain
PyTorch, as `F.grid_sample` (bilinear, zero padding, align_corners=False)
on (x, y) points in [0, 1], and the uncertainty point selection."""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

# a callable (shape) -> uniform [0, 1) fp32 tensor: the loss's random draws
Sampler = Callable[[Sequence[int]], torch.Tensor]


def uniform_sampler(generator: torch.Generator) -> Sampler:
    """A sampler drawing from `generator`, on the generator's device."""
    return lambda shape: torch.rand(tuple(shape), generator=generator,
                                    device=generator.device)


def point_sample(masks: torch.Tensor, points: torch.Tensor,
                 sorted_by_y: bool = False) -> torch.Tensor:
    """Sample masks (N, H, W) at points (N / S, P, 2), the S consecutive
    masks of a group at one point set, -> (N, P) fp32, differentiable in
    the masks; the points get no gradient. `sorted_by_y` is ignored."""
    del sorted_by_y
    N, H, W = masks.shape
    sets, P = points.shape[:2]
    if sets == 0 or N % sets:
        raise ValueError(f"{sets} point sets for {N} masks")
    grid = 2 * points.detach().float()[:, None] - 1          # (sets, 1, P, 2)
    out = F.grid_sample(masks.float().reshape(sets, N // sets, H, W), grid,
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False)                  # (sets, S, 1, P)
    return out.reshape(N, P)


def uncertainty(logits: torch.Tensor) -> torch.Tensor:
    """-|logit|: highest near the decision boundary."""
    return -logits.abs()


def get_uncertain_point_coords(sampler: Sampler, mask_logits: torch.Tensor,
                               num_points: int,
                               oversample_ratio: float = 3.0,
                               importance_sample_ratio: float = 0.75
                               ) -> torch.Tensor:
    """(N, num_points, 2) coords: the most uncertain of
    `num_points * oversample_ratio` uniform points of each mask (N, H, W),
    then fresh uniform points (reference `point_sample.py:32`). The exact
    top-k, as the JAX package takes off the TPU; `sampler` makes the draws
    (oversampled pool first, then the fresh points)."""
    N = mask_logits.shape[0]
    n_sampled = int(num_points * oversample_ratio)
    n_important = int(importance_sample_ratio * num_points)
    n_random = num_points - n_important
    dev = mask_logits.device
    coords = sampler((N, n_sampled, 2)).to(dev)
    unc = uncertainty(point_sample(mask_logits, coords))
    top_idx = torch.topk(unc, n_important, dim=1).indices
    important = coords.gather(1, top_idx[..., None].expand(-1, -1, 2))
    if n_random > 0:
        rand = sampler((N, n_random, 2)).to(dev)
        return torch.cat([important, rand], dim=1)
    return important


def sort_points_by_y(points: torch.Tensor) -> torch.Tensor:
    """Sort each row of points (..., P, 2) by y, carrying x: the losses
    reduce over points, so the order is free, and it fixes the order the
    tests compare (`point_sample_pallas.sort_points_by_y`)."""
    y, order = torch.sort(points[..., 1], dim=-1, stable=True)
    x = points[..., 0].gather(-1, order)
    return torch.stack([x, y], dim=-1)
