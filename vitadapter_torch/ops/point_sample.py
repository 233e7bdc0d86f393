"""Bilinear point sampling for the mask losses (PointRend style): the Hopper
kernels' wrapper, with its gradient, its plain version, and the uncertainty
point selection.

Counterpart of `vitadapter/ops/point_sample.py` and
`vitadapter/ops/point_sample_pallas.py`. The kernels are
`csrc/point_sample_fwd.cu` (it replaces `point_sample_pallas._fwd_kernel`)
and `csrc/point_sample_bwd.cu` (it replaces `point_sample_pallas._bwd_kernel`).
Points come as (N / S, P, 2) for masks (N, H, W): the S consecutive masks of
a group share one point set (S = 1 is the JAX function's form), so a caller
that samples many masks at one set passes the set once. The forward computes
each point's corners once for the masks that share it and gathers them from
the masks' maps or rows staged in shared memory, or from device memory
(`fwd_plan` picks the kernel, tiles and buffers from the shapes and from
whether the caller sorted the points by y). The backward kernel sums each mask's gradient in the
shared memory of a
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

# the forward kernels' launch plan (`fwd_plan`)
FWD_GATHER, FWD_STREAM, FWD_TILES = 0, 1, 2   # its kernel
FWD_THREADS = 256
FWD_CHUNK = 4 * FWD_THREADS          # points a staging CTA holds at a time
# dynamic shared memory of a CTA: the 227 KB a CTA may take less 1 KB for
# the static part (CUDA refuses a launch beyond what a CTA may take)
FWD_MAX_SMEM = 232448 - 1024
FWD_SM_SMEM = 233472                 # shared memory of an SM (228 KB)
FWD_BAND_ROWS = 24     # rows a tile of sorted points should span
FWD_STAGE_CTAS_PER_SM = 4            # the staging kernels' register budget
# CTAs of the streaming kernel an SM must hold for points sorted by y to be
# staged rather than gathered
FWD_SORTED_STREAM_CTAS = 3
FWD_MAX_CELLS = 2 ** 26              # H * W: corner offsets times 16 in int32


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


class FwdPlan(NamedTuple):
    """How `point_sample_fwd.cu` covers masks (N, H, W) at points (N / S,
    P, 2). `kernel` FWD_GATHER (CTAs of FWD_THREADS of the call's N * P
    points, one a thread) or FWD_STREAM (`tiles` CTAs, each taking `tile`
    of the call's points, mask by mask, `stages` buffers of `buf_bytes`
    each holding a whole map): `group` and `groups` are 1. FWD_TILES: per
    point set, `tiles` CTAs of `tile` points times `groups` of `group`
    masks, each with `stages` buffers of `buf_bytes` for a mask's band of
    rows (none, 0: every tile gathers from device memory)."""
    kernel: int
    tile: int
    tiles: int
    group: int
    groups: int
    buf_bytes: int
    stages: int


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


def whole_map_bytes(H: int, W: int, elem_bytes: int) -> int:
    """A buffer for a whole map: its bytes plus 15 for an unaligned start,
    in 16-byte units."""
    return _ceil16(H * W * elem_bytes + 15)


def gather_plan(N: int, P: int) -> FwdPlan:
    """The gather kernel: a thread per (mask, point)."""
    return FwdPlan(FWD_GATHER, FWD_THREADS,
                   max(-(-N * P // FWD_THREADS), 1), 1, 1, 0, 1)


def _stream_buffers(buf: int):
    """(buffers, CTAs an SM) of the streaming kernel with whole-map buffers
    of `buf` bytes: two (the next mask's copy in flight) where they fit a
    CTA, as many CTAs as their shared memory leaves an SM room for, at
    most FWD_STAGE_CTAS_PER_SM."""
    stages = 2 if 2 * buf <= FWD_MAX_SMEM else 1
    return stages, max(1, min(FWD_STAGE_CTAS_PER_SM,
                              FWD_SM_SMEM // (stages * buf + 1024)))


def stream_plan(N: int, H: int, W: int, P: int, elem_bytes: int,
                sms: int) -> FwdPlan:
    """The streaming kernel, for maps that fit a CTA (`_stream_buffers`),
    the call's points split evenly over the CTAs that run at once on `sms`
    SMs."""
    buf = whole_map_bytes(H, W, elem_bytes)
    stages, per_sm = _stream_buffers(buf)
    total = max(N * P, 1)
    tile = max(-(-total // (sms * per_sm)), FWD_THREADS)
    return FwdPlan(FWD_STREAM, tile, -(-total // tile), 1, 1, buf, stages)


def tile_plan(N: int, S: int, H: int, W: int, P: int, elem_bytes: int,
              sms: int) -> FwdPlan:
    """The tile kernel: a CTA holds one tile of a set's points and walks a
    group of its masks, two buffers where a group has more than one mask:
    the whole map where two fit a CTA; else the band of rows a tile
    spans, in buffers of at most a quarter of a CTA's shared memory, a
    tile of as many points as uniform points sorted by y put in
    FWD_BAND_ROWS rows (or in a quarter of a buffer), each buffer twice
    the rows such a tile is expected to span; no buffer where three rows
    do not fit one (the tiles gather). Masks are grouped so that the call
    makes about FWD_STAGE_CTAS_PER_SM CTAs on each of `sms` SMs."""
    n_sets = N // S if S else 0
    row = W * elem_bytes
    whole = whole_map_bytes(H, W, elem_bytes)
    cap = FWD_MAX_SMEM // 4 // 16 * 16
    band_rows = min(FWD_BAND_ROWS, (cap - 15) // row // 2)
    if 2 * whole <= FWD_MAX_SMEM or P == 0:
        tile, buf = FWD_CHUNK, whole
    elif band_rows < 3:
        tile, buf = FWD_CHUNK, 0
    else:
        tile, buf = min(max((band_rows - 2) * P // H, FWD_THREADS),
                        FWD_CHUNK), None
    tiles = max(-(-P // tile), 1)
    tile = max(-(-P // tiles), 1)
    if buf is None:          # the band of rows a tile is expected to span
        rows = min(2 * (-(-H * tile // P) + 2), H)
        buf = min(_ceil16(rows * row + 15), cap)
    target = FWD_STAGE_CTAS_PER_SM * sms
    groups = min(max(-(-target // max(n_sets * tiles, 1)), 1), S)
    group = -(-S // groups)
    groups = -(-S // group)
    return FwdPlan(FWD_TILES, tile, tiles, group, groups, buf,
                   2 if buf and group > 1 else 1)


def fwd_plan(N: int, S: int, H: int, W: int, P: int, elem_bytes: int,
             sms: int, sorted_by_y: bool = False) -> FwdPlan:
    """The forward kernels' plan from the shapes, the card's SM count and
    whether each set's points are sorted by y (the band a tile spans is
    found on the card):
    - Shared sets (S > 1) take the tile kernel (`tile_plan`), each tile's
      geometry kept for the masks of a group, unless the grouping leaves a
      mask a group; then the rule for a set a mask holds.
    - A set a mask, on maps that fit a CTA: the streaming kernel
      (`stream_plan`) for unsorted points, where a gather of scattered
      corners is bound by L1 wavefronts. Sorted points share sectors
      between neighbouring threads, so a gather reads little more than a
      copy would: they are staged only where an SM holds
      FWD_SORTED_STREAM_CTAS streaming CTAs, enough to hide a mask's copy
      behind the others' gathers.
    - Else the gather kernel, whose occupancy no buffer limits."""
    if S > 1:
        plan = tile_plan(N, S, H, W, P, elem_bytes, sms)
        if plan.group > 1:
            return plan
    buf = whole_map_bytes(H, W, elem_bytes)
    if buf <= FWD_MAX_SMEM and (
            not sorted_by_y
            or _stream_buffers(buf)[1] >= FWD_SORTED_STREAM_CTAS):
        return stream_plan(N, H, W, P, elem_bytes, sms)
    return gather_plan(N, P)


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


def masks_per_set(masks: torch.Tensor, points: torch.Tensor) -> int:
    """S of masks (N, H, W) at points (N / S, P, 2); raises ValueError when
    the sets do not divide the masks."""
    N, sets = masks.shape[0], points.shape[0]
    if (sets == 0 and N) or (sets and N % sets):
        raise ValueError(f"{sets} point sets for {N} masks: the masks must "
                         "be a whole number of masks a set")
    return N // sets if sets else 1


def point_sample_plain(masks: torch.Tensor,
                       points: torch.Tensor) -> torch.Tensor:
    """masks (N, H, W) fp32 or bf16, points (N / S, P, 2) -> (N, P) fp32: a
    gather of the four corners of each set's points in its S masks, fp32
    weights and sums."""
    N, H, W = masks.shape
    S = masks_per_set(masks, points)
    sets, P = points.shape[:2]
    flat = masks.reshape(sets, S, H * W)
    out = torch.zeros((sets, S, P), dtype=torch.float32, device=masks.device)
    for idx, valid, w in _corners(points, H, W):
        g = flat.gather(2, idx[:, None].expand(sets, S, P))
        out = out + torch.where(valid[:, None], w[:, None] * g.float(), 0.0)
    return out.reshape(N, P)


def point_sample_plain_backward(masks: torch.Tensor, points: torch.Tensor,
                                grad_out: torch.Tensor) -> torch.Tensor:
    """d masks of `point_sample_plain` for the output gradient `grad_out`
    (N, P): the weighted scatter of every point into its corners, summed in
    fp32 and rounded to the mask dtype."""
    N, H, W = masks.shape
    S = masks_per_set(masks, points)
    sets, P = points.shape[:2]
    dm = torch.zeros((sets, S, H * W), dtype=torch.float32,
                     device=masks.device)
    g = grad_out.float().reshape(sets, S, P)
    for idx, valid, w in _corners(points, H, W):
        dm.scatter_add_(2, idx[:, None].expand(sets, S, P),
                        torch.where(valid[:, None], w[:, None] * g, 0.0))
    return dm.reshape(N, H, W).to(masks.dtype)


def check_kernel_inputs(masks: torch.Tensor, points: torch.Tensor) -> None:
    """Raise ValueError on anything the point-sampling kernels do not
    take."""
    if masks.dim() != 3 or masks.dtype not in (torch.float32,
                                               torch.bfloat16):
        raise ValueError(f"masks {tuple(masks.shape)} {masks.dtype}: the "
                         "kernel takes (N, H, W) fp32 or bf16")
    N, H, W = masks.shape
    if points.dim() != 3 or points.shape[2] != 2 \
            or points.dtype != torch.float32:
        raise ValueError(f"points {tuple(points.shape)} {points.dtype} must "
                         f"be ({N} / S, P, 2) fp32")
    masks_per_set(masks, points)
    if H * W >= FWD_MAX_CELLS:
        raise ValueError(f"masks of {H}x{W}: the kernels take fewer than "
                         f"{FWD_MAX_CELLS} cells a mask")
    for name, t in (("masks", masks), ("points", points)):
        if t.device.type != "cuda" or t.device != masks.device:
            raise ValueError(f"{name} must be on the masks' CUDA device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if points.data_ptr() % 8:
        raise ValueError("points must be 8-byte aligned: the kernels read "
                         "each (x, y) as one float2")


def _launch_forward(masks, points, out, sorted_by_y: bool = False,
                    plan: FwdPlan | None = None) -> None:
    """One launch of `point_sample_fwd.cu` on `plan` (by default
    `fwd_plan`'s): out (N, P) fp32, every value written, from masks (N, H,
    W) and points (N / S, P, 2), all contiguous on one device."""
    N, H, W = masks.shape
    S = masks_per_set(masks, points)
    P = points.shape[1]
    if plan is None:
        plan = fwd_plan(N, S, H, W, P, masks.element_size(),
                        torch.cuda.get_device_properties(
                            masks.device).multi_processor_count,
                        sorted_by_y)
    cuda_ext.launch("point_sample_fwd", masks.device, masks.data_ptr(),
                    points.data_ptr(), out.data_ptr(), N, H, W, P, S,
                    *plan, int(masks.dtype == torch.bfloat16))


def _kernel_forward(masks, points, sorted_by_y: bool = False) -> torch.Tensor:
    out = torch.empty((masks.shape[0], points.shape[1]), dtype=torch.float32,
                      device=masks.device)
    _launch_forward(masks, points, out, sorted_by_y)
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
    """d masks by `point_sample_bwd.cu`, which takes a point set a mask:
    shared sets are repeated for it."""
    S = masks_per_set(masks, points)
    if S > 1:
        points = points.repeat_interleave(S, dim=0)
    dmask = torch.empty_like(masks)
    _launch_backward(points, grad_out.float().contiguous(), dmask)
    return dmask


class PointSampleFunction(torch.autograd.Function):
    """The kernels with the gradient of the masks only (counterpart of the
    `jax.custom_vjp` of `point_sample_pallas`)."""

    @staticmethod
    def forward(ctx, masks, points, sorted_by_y=False):
        ctx.save_for_backward(masks, points)
        return _kernel_forward(masks, points, sorted_by_y)

    @staticmethod
    def backward(ctx, grad_out):
        masks, points = ctx.saved_tensors
        return _kernel_backward(masks, points, grad_out), None, None


def point_sample(masks: torch.Tensor, points: torch.Tensor,
                 sorted_by_y: bool = False) -> torch.Tensor:
    """Bilinearly sample masks (N, H, W) at points (N / S, P, 2) in [0, 1],
    the S consecutive masks of a group at one point set, -> (N, P) fp32,
    differentiable in the masks; the points get no gradient. `sorted_by_y`
    says that each set is sorted by y (`sort_points_by_y`): only the
    forward kernel's plan reads it, the result does not depend on it.
    CPU tensors take the plain version (autograd differentiates it); CUDA
    tensors take the kernels through `PointSampleFunction`, or raise if
    they cannot take them."""
    points = points.detach()
    if masks.device.type == "cpu":
        return point_sample_plain(masks, points)
    check_kernel_inputs(masks, points)
    return PointSampleFunction.apply(masks, points, sorted_by_y)


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
