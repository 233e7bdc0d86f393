"""Bilinear point sampling for the mask losses (PointRend style): the Hopper
kernels' wrapper, with its gradient, its plain version, and the uncertainty
point selection.

Counterpart of `vitadapter/ops/point_sample.py` and
`vitadapter/ops/point_sample_pallas.py`. The kernels are
`csrc/point_sample_fwd.cu` (it replaces `point_sample_pallas._fwd_kernel`)
and `csrc/point_sample_bwd.cu` (it replaces `point_sample_pallas._bwd_kernel`).
The backward kernel sums each mask's gradient in the shared memory of a
thread-block cluster, each CTA owning a band of rows (`bwd_plan` picks the
cluster size and the rows from H x W), and writes every cell once in the
mask dtype: no fp32 scratch, no global atomics. Semantics are
`F.grid_sample(mode='bilinear', padding_mode='zeros', align_corners=False)`
on (x, y) points in [0, 1]: a point maps to pixel (x * W - 0.5, y * H -
0.5); corners off the map contribute zero, and so does a NaN point. As in
the Pallas kernel, the gradient of the points is zero by definition (every
caller detaches them), so the autograd function returns none for them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from vitadapter_torch.ops import cuda_ext

# a callable (shape) -> uniform [0, 1) fp32 tensor: the loss's random draws
Sampler = Callable[[Sequence[int]], torch.Tensor]

# the backward kernel's launch plan (`bwd_plan`)
BWD_MAX_CLUSTER = 8            # CTAs in a cluster: the portable limit
BWD_MAX_CTA_BYTES = 232448     # shared memory a CTA may take (227 KB)
# the band a CTA is given when a cluster of at most BWD_MAX_CLUSTER can
# cut the map that fine: small enough that several CTAs share an SM
BWD_CTA_BYTES = 32 * 1024


class BwdPlan(NamedTuple):
    """How `point_sample_bwd.cu` covers an (H, W) map: `groups` row groups,
    one cluster of `cluster` CTAs each per mask; CTA r of group k owns the
    rows [(k * cluster + r) * rows, + rows) clipped to H, an fp32 band of
    `smem_bytes` in its shared memory."""
    cluster: int
    rows: int
    groups: int
    smem_bytes: int


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def bwd_plan(H: int, W: int) -> BwdPlan:
    """The smallest cluster (1, 2, 4 or 8 CTAs) whose bands hold at most
    BWD_CTA_BYTES; else 8 CTAs with the largest bands a CTA holds, the map
    cut into as few row groups as that needs and the rows spread evenly
    over them. Raises ValueError when one row does not fit a CTA."""
    row_bytes = 4 * W
    if H < 1 or W < 1 or row_bytes > BWD_MAX_CTA_BYTES:
        raise ValueError(f"point_sample_bwd takes maps of 1 to "
                         f"{BWD_MAX_CTA_BYTES // 4} columns, got {H}x{W}")
    cluster = 1
    while cluster < BWD_MAX_CLUSTER and \
            _ceil_div(H, cluster) * row_bytes > BWD_CTA_BYTES:
        cluster *= 2
    rows = _ceil_div(H, cluster)
    if rows * row_bytes > BWD_MAX_CTA_BYTES:
        groups = _ceil_div(H, cluster * (BWD_MAX_CTA_BYTES // row_bytes))
        rows = _ceil_div(H, cluster * groups)
    return BwdPlan(cluster, rows, _ceil_div(H, cluster * rows),
                   rows * row_bytes)


def uniform_sampler(generator: torch.Generator) -> Sampler:
    """A sampler drawing from `generator`, on the generator's device."""
    return lambda shape: torch.rand(tuple(shape), generator=generator,
                                    device=generator.device)


def _corners(points: torch.Tensor, H: int, W: int):
    """The four bilinear corners of every point, in the order of the JAX
    package's XLA path: [(flat index, valid, weight)]."""
    x = points[..., 0].float() * W - 0.5
    y = points[..., 1].float() * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    lx = x - x0
    ly = y - y0
    out = []
    for dx, dy, w in ((0, 0, (1 - lx) * (1 - ly)), (1, 0, lx * (1 - ly)),
                      (0, 1, (1 - lx) * ly), (1, 1, lx * ly)):
        xi = x0 + dx
        yi = y0 + dy
        # in float, so that a NaN point is off the map on every device
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = (torch.where(valid, yi, 0.0).long() * W
               + torch.where(valid, xi, 0.0).long())
        out.append((idx, valid, w))
    return out


def point_sample_plain(masks: torch.Tensor,
                       points: torch.Tensor) -> torch.Tensor:
    """masks (N, H, W) fp32 or bf16, points (N, P, 2) -> (N, P) fp32: a
    gather of the four corners, fp32 weights and sums."""
    N, H, W = masks.shape
    flat = masks.reshape(N, H * W)
    out = torch.zeros(points.shape[:-1], dtype=torch.float32,
                      device=masks.device)
    for idx, valid, w in _corners(points, H, W):
        g = flat.gather(1, idx.reshape(N, -1)).reshape(idx.shape)
        out = out + torch.where(valid, w * g.float(), 0.0)
    return out


def point_sample_plain_backward(masks: torch.Tensor, points: torch.Tensor,
                                grad_out: torch.Tensor) -> torch.Tensor:
    """d masks of `point_sample_plain` for the output gradient `grad_out`
    (N, P): the weighted scatter of every point into its corners, summed in
    fp32 and rounded to the mask dtype."""
    N, H, W = masks.shape
    dm = torch.zeros((N, H * W), dtype=torch.float32, device=masks.device)
    g = grad_out.float()
    for idx, valid, w in _corners(points, H, W):
        dm.scatter_add_(1, idx.reshape(N, -1),
                        torch.where(valid, w * g, 0.0).reshape(N, -1))
    return dm.reshape(N, H, W).to(masks.dtype)


def check_kernel_inputs(masks: torch.Tensor, points: torch.Tensor) -> None:
    """Raise ValueError on anything the point-sampling kernels do not
    take."""
    if masks.dim() != 3 or masks.dtype not in (torch.float32,
                                               torch.bfloat16):
        raise ValueError(f"masks {tuple(masks.shape)} {masks.dtype}: the "
                         "kernel takes (N, H, W) fp32 or bf16")
    N = masks.shape[0]
    if points.dim() != 3 or points.shape[0] != N or points.shape[2] != 2 \
            or points.dtype != torch.float32:
        raise ValueError(f"points {tuple(points.shape)} {points.dtype} must "
                         f"be ({N}, P, 2) fp32")
    for name, t in (("masks", masks), ("points", points)):
        if t.device.type != "cuda" or t.device != masks.device:
            raise ValueError(f"{name} must be on the masks' CUDA device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if points.data_ptr() % 8:
        raise ValueError("points must be 8-byte aligned: the kernels read "
                         "each (x, y) as one float2")


def _kernel_forward(masks, points) -> torch.Tensor:
    N, H, W = masks.shape
    P = points.shape[1]
    out = torch.empty((N, P), dtype=torch.float32, device=masks.device)
    cuda_ext.launch("point_sample_fwd", masks.device, masks.data_ptr(),
                    points.data_ptr(), out.data_ptr(), N, H, W, P,
                    int(masks.dtype == torch.bfloat16))
    return out


def _launch_backward(points, g, dmask) -> None:
    """One launch of `point_sample_bwd.cu` on `bwd_plan`'s clusters: d
    masks into `dmask` (N, H, W) of the mask dtype, every cell written, from
    points (N, P, 2) and the fp32 output gradient g (N, P), all contiguous
    on one device."""
    N, H, W = dmask.shape
    plan = bwd_plan(H, W)
    cuda_ext.launch("point_sample_bwd", dmask.device, points.data_ptr(),
                    g.data_ptr(), dmask.data_ptr(), N, H, W, points.shape[1],
                    int(dmask.dtype == torch.bfloat16), plan.cluster,
                    plan.rows)


def _kernel_backward(masks, points, grad_out) -> torch.Tensor:
    dmask = torch.empty_like(masks)
    _launch_backward(points, grad_out.float().contiguous(), dmask)
    return dmask


class PointSampleFunction(torch.autograd.Function):
    """The kernels with the gradient of the masks only (counterpart of the
    `jax.custom_vjp` of `point_sample_pallas`)."""

    @staticmethod
    def forward(ctx, masks, points):
        ctx.save_for_backward(masks, points)
        return _kernel_forward(masks, points)

    @staticmethod
    def backward(ctx, grad_out):
        masks, points = ctx.saved_tensors
        return _kernel_backward(masks, points, grad_out), None


def point_sample(masks: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample masks (N, H, W) at points (N, P, 2) in [0, 1] ->
    (N, P) fp32, differentiable in the masks; the points get no gradient.
    CPU tensors take the plain version (autograd differentiates it); CUDA
    tensors take the kernels through `PointSampleFunction`, or raise if
    they cannot take them."""
    points = points.detach()
    if masks.device.type == "cpu":
        return point_sample_plain(masks, points)
    check_kernel_inputs(masks, points)
    return PointSampleFunction.apply(masks, points)


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
