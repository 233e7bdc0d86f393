"""RoIAlign as batched bilinear gathers (counterpart of
`vitadapter/det/roi_align.py`; mmcv RoIAlign with `aligned=True` and 2 x 2
samples a bin), the mask-target crops and the FPN level assignment.

Plain PyTorch: no Pallas kernel computes these. The JAX package samples
every roi from every FPN level and selects each one's level by a one-hot
product; the port samples each roi from its own level only, through one
gather from the levels laid end to end. The selected values are the same
(the one-hot product adds exact zeros), and the work and memory are a
quarter.
"""

from typing import Sequence

import torch


def _sample(flat: torch.Tensor, base: torch.Tensor, H: torch.Tensor,
            W: torch.Tensor, rois: torch.Tensor, scale: torch.Tensor,
            out_size: int, S: int) -> torch.Tensor:
    """RoIAlign of rois (R, 4) from maps laid end to end in `flat`
    (rows, C): roi r reads the (H[r], W[r]) map at row base[r], with
    coordinates times scale[r]. Returns (R, out, out, C) fp32."""
    R, C = rois.shape[0], flat.shape[-1]
    n = out_size * S
    boxes = rois * scale[:, None]
    x1, y1, x2, y2 = boxes.unbind(-1)
    idx = torch.arange(n, dtype=torch.float32, device=rois.device) + 0.5

    def centers(lo, extent):
        # (R, n) sample positions, aligned=True: shifted by -0.5
        step = extent[:, None] / n
        return lo[:, None] + idx * step - 0.5

    xs = centers(x1, (x2 - x1).clamp(min=1e-6))
    ys = centers(y1, (y2 - y1).clamp(min=1e-6))
    x0, y0 = torch.floor(xs), torch.floor(ys)
    lx, ly = xs - x0, ys - y0
    x0i, y0i = x0.long(), y0.long()
    Wc, Hc = W[:, None], H[:, None]
    out = torch.zeros((R, n, n, C), dtype=torch.float32, device=rois.device)
    for dy, wy in ((0, 1 - ly), (1, ly)):
        for dx, wx in ((0, 1 - lx), (1, lx)):
            xi, yi = x0i + dx, y0i + dy
            vx = (xi >= 0) & (xi < Wc)
            vy = (yi >= 0) & (yi < Hc)
            xi = torch.minimum(xi.clamp(min=0), Wc - 1)
            yi = torch.minimum(yi.clamp(min=0), Hc - 1)
            rows = (base[:, None, None] + yi[:, :, None] * Wc[:, :, None]
                    + xi[:, None, :])                     # (R, n, n)
            g = flat[rows.reshape(-1)].reshape(R, n, n, C)
            w = (wy * vy)[:, :, None] * (wx * vx)[:, None, :]
            out = out + g * w[..., None]
    return out.reshape(R, out_size, S, out_size, S, C).mean(dim=(2, 4))


def roi_align(feat: torch.Tensor, rois: torch.Tensor, out_size: int,
              spatial_scale: float, sampling_ratio: int = 2) -> torch.Tensor:
    """feat (H, W, C); rois (R, 4) xyxy in image coordinates -> (R, out,
    out, C) fp32, S x S samples a bin averaged (S = sampling_ratio)."""
    H, W, C = feat.shape
    R, dev = rois.shape[0], rois.device
    full = torch.full((R,), 1, dtype=torch.long, device=dev)
    return _sample(feat.reshape(H * W, C), 0 * full, H * full, W * full,
                   rois, torch.full((R,), spatial_scale, device=dev),
                   out_size, max(sampling_ratio, 1))


def crop_resize_masks(gt_masks: torch.Tensor, rois: torch.Tensor,
                      gt_idx: torch.Tensor, out_size: int = 28
                      ) -> torch.Tensor:
    """Mask targets: each roi's assigned gt mask (gt_masks (G, H, W), 0/1
    of any dtype, bool on the train path) bilinearly cropped to out x out
    (one sample a bin, aligned) and thresholded at 0.5: (R, out, out) fp32.
    One flat gather: no per-roi (H, W) mask is made, and a bool mask is
    read as it is (0 and 1 gather the same in any dtype)."""
    G, H, W = gt_masks.shape
    R = rois.shape[0]
    x1, y1, x2, y2 = rois.unbind(-1)
    idxs = torch.arange(out_size, dtype=torch.float32,
                        device=rois.device) + 0.5
    xs = x1[:, None] + idxs * ((x2 - x1)[:, None] / out_size) - 0.5
    ys = y1[:, None] + idxs * ((y2 - y1)[:, None] / out_size) - 0.5
    x0, y0 = torch.floor(xs), torch.floor(ys)
    lx, ly = xs - x0, ys - y0
    x0i, y0i = x0.long(), y0.long()
    flat = gt_masks.reshape(G * H * W)
    base = (gt_idx * (H * W))[:, None, None]
    out = torch.zeros((R, out_size, out_size), dtype=torch.float32,
                      device=rois.device)
    for dy, wy in ((0, 1 - ly), (1, ly)):
        for dx, wx in ((0, 1 - lx), (1, lx)):
            xi = (x0i + dx).clamp(0, W - 1)
            yi = (y0i + dy).clamp(0, H - 1)
            vx = ((x0i + dx) >= 0) & ((x0i + dx) < W)
            vy = ((y0i + dy) >= 0) & ((y0i + dy) < H)
            idx = base + yi[:, :, None] * W + xi[:, None, :]
            g = flat[idx.reshape(-1)].reshape(R, out_size, out_size).float()
            w = (wy * vy)[:, :, None] * (wx * vx)[:, None, :]
            out = out + g * w
    return (out >= 0.5).float()


def assign_fpn_levels(rois: torch.Tensor, num_levels: int,
                      finest_scale: int = 56) -> torch.Tensor:
    """mmdet SingleRoIExtractor.map_roi_levels: (R,) int64 levels."""
    scale = torch.sqrt(((rois[:, 2] - rois[:, 0])
                        * (rois[:, 3] - rois[:, 1])).clamp(min=0))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def multi_level_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                          out_size: int, strides: Sequence[int],
                          sampling_ratio: int = 2) -> torch.Tensor:
    """(R, out, out, C) fp32 from each roi's FPN level (feats: (H_l, W_l,
    C) maps of one image, strides: theirs)."""
    lvl = assign_fpn_levels(rois, len(feats))
    dev = rois.device
    C = feats[0].shape[-1]
    flat = torch.cat([f.reshape(-1, C) for f in feats])
    sizes = [f.shape[0] * f.shape[1] for f in feats]
    starts = [sum(sizes[:i]) for i in range(len(sizes))]

    def per_level(values, dtype=torch.long):
        return torch.tensor(values, dtype=dtype, device=dev)[lvl]

    return _sample(flat, per_level(starts), per_level([f.shape[0]
                                                       for f in feats]),
                   per_level([f.shape[1] for f in feats]), rois,
                   per_level([1.0 / s for s in strides], torch.float32),
                   out_size, max(sampling_ratio, 1))
