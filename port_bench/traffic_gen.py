"""The one generator of the benchmark's inputs, driven by a traffic mix's
parameters and the seed: images with label maps of irregular regions.

An image of k classes: k seeds spread uniformly over it, each pixel taking
the class of the nearest seed after a smooth random warp of the pixel
grid (so the regions are irregular), a share of pixels labelled 255
(ignore) where a smooth random field is highest, and colours by class with
pixel noise, in raw 0-255 units. The counts k of a pool of n images are
spread evenly over the mix's [least, most] and shuffled by the seed, so
every seed draws the same multiset of counts."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

IGNORE = 255
WARP = 0.08        # the warp's scale, a share of the image's side
WARP_GRID = 8      # the warp field's control points a side
IGNORE_GRID = 6
PIXEL_NOISE = 20.0


def class_counts(n: int, least: int, most: int,
                 g: torch.Generator) -> List[int]:
    """n counts spread evenly over [least, most], in an order drawn from
    `g`."""
    span = most - least + 1
    counts = [least + (i * span) // n for i in range(n)]
    order = torch.randperm(n, generator=g, device=g.device).tolist()
    return [counts[i] for i in order]


def _smooth(n: int, c: int, grid: int, hw: Tuple[int, int],
            g: torch.Generator) -> torch.Tensor:
    low = torch.randn((n, c, grid, grid), generator=g, device=g.device)
    return F.interpolate(low, size=hw, mode="bicubic", align_corners=False)


def scenes(n: int, hw: Tuple[int, int], counts: Sequence[int],
           num_classes: int, ignore_share: float, g: torch.Generator
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """n images (n, H, W, 3) fp32 in 0-255 and their labels (n, H, W)
    int64, on `g`'s device."""
    H, W = hw
    dev = g.device
    ys = (torch.arange(H, device=dev, dtype=torch.float32) + 0.5) / H
    xs = (torch.arange(W, device=dev, dtype=torch.float32) + 0.5) / W
    warp = _smooth(n, 2, WARP_GRID, hw, g) * WARP
    ign = _smooth(n, 1, IGNORE_GRID, hw, g)[:, 0]
    colours = torch.rand((n, num_classes, 3), generator=g, device=dev) * 255
    images, labels = [], []
    for i, k in enumerate(counts):
        cls = torch.randperm(num_classes, generator=g, device=dev)[:k]
        seeds = torch.rand((k, 2), generator=g, device=dev)
        py = ys[:, None] + warp[i, 0]
        px = xs[None, :] + warp[i, 1]
        d = (py[None] - seeds[:, 0, None, None]).square() \
            + (px[None] - seeds[:, 1, None, None]).square()
        lab = cls[d.argmin(0)]
        img = colours[i, lab] + PIXEL_NOISE * torch.randn(
            (H, W, 3), generator=g, device=dev)
        if ignore_share > 0:
            cut = torch.quantile(ign[i].reshape(-1)[::7], 1 - ignore_share)
            lab = torch.where(ign[i] > cut, IGNORE, lab)
        images.append(img.clamp_(0, 255))
        labels.append(lab)
    return torch.stack(images), torch.stack(labels).long()


def sub_seed(seed: int, k: int) -> int:
    """A distinct 63-bit seed for stream k of a run."""
    return (int(seed) * 1_000_003 + 7919 * k) % (2 ** 63 - 1)
