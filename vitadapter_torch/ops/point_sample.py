"""Bilinear point sampling for the mask losses (PointRend style): the Hopper
kernels' wrapper, with its gradient, its plain version, and the uncertainty
point selection.

Counterpart of `vitadapter/ops/point_sample.py` and
`vitadapter/ops/point_sample_pallas.py`. The kernels are
`csrc/point_sample_fwd.cu` (it replaces `point_sample_pallas._fwd_kernel`)
and `csrc/point_sample_bwd.cu` (it replaces `point_sample_pallas._bwd_kernel`).
Semantics are `F.grid_sample(mode='bilinear', padding_mode='zeros',
align_corners=False)` on (x, y) points in [0, 1]: a point maps to pixel
(x * W - 0.5, y * H - 0.5) and corners off the map contribute zero. As in
the Pallas kernel, the gradient of the points is zero by definition (every
caller detaches them), so the autograd function returns none for them.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from vitadapter_torch.ops import cuda_ext

# a callable (shape) -> uniform [0, 1) fp32 tensor: the loss's random draws
Sampler = Callable[[Sequence[int]], torch.Tensor]


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
    x0i = x0.long()
    y0i = y0.long()
    out = []
    for dx, dy, w in ((0, 0, (1 - lx) * (1 - ly)), (1, 0, lx * (1 - ly)),
                      (0, 1, (1 - lx) * ly), (1, 1, lx * ly)):
        xi = x0i + dx
        yi = y0i + dy
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
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


def _kernel_backward(masks, points, grad_out) -> torch.Tensor:
    N, H, W = masks.shape
    P = points.shape[1]
    g = grad_out.float().contiguous()
    dmask = torch.empty_like(masks)
    acc = dmask if masks.dtype == torch.float32 else torch.empty(
        masks.shape, dtype=torch.float32, device=masks.device)
    cuda_ext.launch("point_sample_bwd", masks.device, points.data_ptr(),
                    g.data_ptr(), acc.data_ptr(), dmask.data_ptr(), N, H, W,
                    P, int(masks.dtype == torch.bfloat16))
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
