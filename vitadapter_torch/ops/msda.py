"""Multi-scale deformable attention (MSDA): the Hopper kernels' wrappers,
their plain versions, and the `MSDeformAttn` module.

Counterpart of `vitadapter/ops/msda.py` and of the dispatch of
`msda_pallas.ms_deform_attn_pallas`. Two routes, chosen by `msda_route` from
the value's shape and dtype alone, as the JAX package chooses:
- "fused", a value of at most `ML_MAX_VALUE_BYTES` per head:
  `csrc/msda_fwd.cu` (replaces `msda_pallas._fwd_ml_kernel`) and
  `csrc/msda_bwd.cu` (replaces `msda_pallas._bwd_ml_kernel`), all levels in
  one launch;
- "level", a larger value: one launch per level of `csrc/msda_level_fwd.cu`
  (replaces `_sample_kernel` and `_sample_kernel_onehot_pf`),
  `csrc/msda_level_dv.cu` (replaces `_dv_kernel`) and
  `csrc/msda_level_dgrid.cu` (replaces `_dgrid_kernel`).
Layouts follow JAX: value (B, S, M, D), sampling locations
(B, Lq, M, L, P, 2) as (x, y) in [0, 1], attention weights (B, Lq, M, L, P);
the result is (B, Lq, M * D). Sampling matches `F.grid_sample(mode=
'bilinear', padding_mode='zeros', align_corners=False)`: location `loc` maps
to pixel `loc * size - 0.5` and corners off the map contribute zero.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from vitadapter_torch.layers.linear import Linear
from vitadapter_torch.ops import cuda_ext

SpatialShapes = Tuple[Tuple[int, int], ...]
MAX_LEVELS = 8   # csrc/msda_level.cuh kMaxLevels
MAX_HEAD_DIM = 64
# one head's value (S * D * itemsize) above this takes the per-level route
# (`msda_pallas.ML_MAX_VALUE_BYTES`)
ML_MAX_VALUE_BYTES = 8 * 1024 * 1024


def msda_route(value_shape: Sequence[int], dtype: torch.dtype) -> str:
    """"fused" or "level": which kernels a CUDA value of this (B, S, M, D)
    shape and dtype takes (`msda_pallas._forward` / `_bwd`)."""
    S, D = value_shape[1], value_shape[3]
    return "fused" if S * D * dtype.itemsize <= ML_MAX_VALUE_BYTES \
        else "level"


def level_sizes(spatial_shapes: SpatialShapes) -> Tuple[int, ...]:
    return tuple(h * w for h, w in spatial_shapes)


def level_start_index(spatial_shapes: SpatialShapes) -> Tuple[int, ...]:
    starts = [0]
    for h, w in spatial_shapes[:-1]:
        starts.append(starts[-1] + h * w)
    return tuple(starts)


def _sample_one_level(value_l: torch.Tensor, loc: torch.Tensor,
                      attn_w: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """value_l (B, HW, M, D); loc (B, Lq, M, P, 2); attn_w (B, Lq, M, P) ->
    (B, Lq, M, D) fp32: one gather of the four corners of every point."""
    B, Lq, M, P, _ = loc.shape
    D = value_l.shape[-1]
    loc = loc.float()
    x = loc[..., 0] * W - 0.5
    y = loc[..., 1] * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    lx = x - x0
    ly = y - y0
    x0i = x0.long()
    y0i = y0.long()
    xs = torch.stack([x0i, x0i + 1, x0i, x0i + 1], dim=-1)    # (B,Lq,M,P,4)
    ys = torch.stack([y0i, y0i, y0i + 1, y0i + 1], dim=-1)
    w = torch.stack([(1 - lx) * (1 - ly), lx * (1 - ly), (1 - lx) * ly,
                     lx * ly], dim=-1)
    valid = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    w = torch.where(valid, w, torch.zeros((), dtype=w.dtype, device=w.device))
    w = w * attn_w.float()[..., None]
    idx = ys.clamp(0, H - 1) * W + xs.clamp(0, W - 1)
    # rows of the (B * M * HW, D) value table, one per (point, corner)
    bm = (torch.arange(B, device=idx.device)[:, None] * M
          + torch.arange(M, device=idx.device)[None, :])       # (B, M)
    rows = bm[:, None, :, None, None] * (H * W) + idx
    table = value_l.permute(0, 2, 1, 3).reshape(B * M * H * W, D)
    g = table.index_select(0, rows.reshape(-1)).reshape(B, Lq, M, P * 4, D)
    return torch.einsum("bqmsd,bqms->bqmd", g.float(),
                        w.reshape(B, Lq, M, P * 4))


def ms_deform_attn_plain(value: torch.Tensor, spatial_shapes: SpatialShapes,
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """Gather formulation equal to `vitadapter.ops.msda.ms_deform_attn_core`:
    fp32 weights and sums, result in the value dtype."""
    B, S, M, D = value.shape
    Lq, L = sampling_locations.shape[1], sampling_locations.shape[3]
    if L != len(spatial_shapes) or S != sum(level_sizes(spatial_shapes)):
        raise ValueError(f"value rows {S} / levels {L} do not match "
                         f"spatial shapes {spatial_shapes}")
    out = torch.zeros((B, Lq, M, D), dtype=torch.float32, device=value.device)
    for lvl, (start, (H, W)) in enumerate(
            zip(level_start_index(spatial_shapes), spatial_shapes)):
        out = out + _sample_one_level(
            value[:, start:start + H * W], sampling_locations[:, :, :, lvl],
            attention_weights[:, :, :, lvl], H, W)
    return out.reshape(B, Lq, M * D).to(value.dtype)


def check_kernel_inputs(value: torch.Tensor, spatial_shapes: SpatialShapes,
                        loc: torch.Tensor, attn: torch.Tensor) -> None:
    """Raise ValueError on anything `msda_fwd.cu` does not take."""
    if value.dim() != 4:
        raise ValueError(f"value must be (B, S, M, D), got "
                         f"{tuple(value.shape)}")
    B, S, M, D = value.shape
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"value dtype {value.dtype}: the kernel takes fp32 "
                         "or bf16")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D}: the kernel takes 1..{MAX_HEAD_DIM}")
    L = len(spatial_shapes)
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"{L} levels: the kernel takes 1..{MAX_LEVELS}")
    if S != sum(level_sizes(spatial_shapes)):
        raise ValueError(f"value rows {S} != sum of level sizes of "
                         f"{spatial_shapes}")
    if loc.dim() != 6 or loc.shape[0] != B or loc.shape[2] != M \
            or loc.shape[3] != L or loc.shape[5] != 2:
        raise ValueError(f"sampling locations {tuple(loc.shape)} must be "
                         f"({B}, Lq, {M}, {L}, P, 2)")
    if tuple(attn.shape) != tuple(loc.shape[:5]):
        raise ValueError(f"attention weights {tuple(attn.shape)} must be "
                         f"{tuple(loc.shape[:5])}")
    for name, t in (("value", value), ("sampling locations", loc),
                    ("attention weights", attn)):
        if t.device.type != "cuda" or t.device != value.device:
            raise ValueError(f"{name} must be on the value's CUDA device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("sampling locations", loc), ("attention weights", attn)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32, got {t.dtype}")


def ms_deform_attn_plain_backward(value: torch.Tensor,
                                  spatial_shapes: SpatialShapes,
                                  sampling_locations: torch.Tensor,
                                  attention_weights: torch.Tensor,
                                  grad_out: torch.Tensor):
    """(d value, d locations, d weights) of `ms_deform_attn_plain` for the
    output gradient `grad_out` (B, Lq, M * D): autograd of the plain version
    run on an fp32 copy of the value, so d value is summed in fp32 and then
    rounded to the value dtype, as the kernel does."""
    with torch.enable_grad():
        v = value.detach().float().requires_grad_()
        loc = sampling_locations.detach().requires_grad_()
        attn = attention_weights.detach().requires_grad_()
        out = ms_deform_attn_plain(v, spatial_shapes, loc, attn)
        dv, dloc, dattn = torch.autograd.grad(out, (v, loc, attn),
                                              grad_out.float())
    return dv.to(value.dtype), dloc, dattn


def level_dv_plain(loc_l: torch.Tensor, attn_l: torch.Tensor,
                   g: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """d value of `_sample_one_level` for the output gradient g
    (B, Lq, M, D): (B, H * W, M, D) fp32. The sampling is linear in the
    value, so the value itself is not needed."""
    B, Lq, M, D = g.shape
    with torch.enable_grad():
        v = torch.zeros((B, H * W, M, D), dtype=torch.float32,
                        device=g.device, requires_grad=True)
        out = _sample_one_level(v, loc_l, attn_l, H, W)
        (dv,) = torch.autograd.grad(out, (v,), g.float())
    return dv


def level_dgrid_plain(value_l: torch.Tensor, loc_l: torch.Tensor,
                      attn_l: torch.Tensor, g: torch.Tensor, H: int, W: int):
    """(d loc (B, Lq, M, P, 2), d attn (B, Lq, M, P)) of `_sample_one_level`
    for the output gradient g (B, Lq, M, D), fp32."""
    with torch.enable_grad():
        loc = loc_l.detach().float().requires_grad_()
        attn = attn_l.detach().float().requires_grad_()
        out = _sample_one_level(value_l.detach(), loc, attn, H, W)
        dloc, dattn = torch.autograd.grad(out, (loc, attn), g.float())
    return dloc, dattn


def _level_arrays(spatial_shapes: SpatialShapes):
    L = len(spatial_shapes)
    shapes = (ctypes.c_int * (2 * L))(*[n for hw in spatial_shapes
                                        for n in hw])
    starts = (ctypes.c_int * L)(*level_start_index(spatial_shapes))
    return (ctypes.cast(shapes, ctypes.c_void_p),
            ctypes.cast(starts, ctypes.c_void_p), (shapes, starts))


def _kernel_forward(value, spatial_shapes, loc, attn) -> torch.Tensor:
    B, S, M, D = value.shape
    Lq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    out = torch.empty((B, Lq, M * D), dtype=value.dtype, device=value.device)
    shapes, starts, _keep = _level_arrays(spatial_shapes)
    cuda_ext.launch("msda_fwd", value.device, value.data_ptr(),
                    loc.data_ptr(), attn.data_ptr(), out.data_ptr(), B, S, M,
                    D, Lq, L, P, shapes, starts,
                    int(value.dtype == torch.bfloat16))
    return out


def _kernel_backward(value, spatial_shapes, loc, attn, grad_out):
    """`msda_bwd.cu`: d value in the value dtype (summed in an fp32
    buffer), d locations and d weights in fp32."""
    B, S, M, D = value.shape
    Lq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    if tuple(grad_out.shape) != (B, Lq, M * D) \
            or grad_out.dtype != value.dtype:
        raise ValueError(f"output gradient {tuple(grad_out.shape)} "
                         f"{grad_out.dtype} must be ({B}, {Lq}, {M * D}) "
                         f"{value.dtype}")
    grad_out = grad_out.contiguous()
    dvalue = torch.empty_like(value)
    acc = dvalue if value.dtype == torch.float32 else torch.empty(
        value.shape, dtype=torch.float32, device=value.device)
    dloc = torch.empty_like(loc)
    dattn = torch.empty_like(attn)
    shapes, starts, _keep = _level_arrays(spatial_shapes)
    cuda_ext.launch("msda_bwd", value.device, value.data_ptr(),
                    loc.data_ptr(), attn.data_ptr(), grad_out.data_ptr(),
                    acc.data_ptr(), dvalue.data_ptr(), dloc.data_ptr(),
                    dattn.data_ptr(), B, S, M, D, Lq, L, P, shapes, starts,
                    int(value.dtype == torch.bfloat16))
    return dvalue, dloc, dattn


class MSDeformAttnFunction(torch.autograd.Function):
    """The kernels with their gradient: `msda_fwd.cu` forward, `msda_bwd.cu`
    backward (counterpart of the `jax.custom_vjp` of
    `msda_pallas.ms_deform_attn_pallas`)."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, loc, attn):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, loc, attn)
        return _kernel_forward(value, spatial_shapes, loc, attn)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        dvalue, dloc, dattn = _kernel_backward(value, ctx.spatial_shapes,
                                               loc, attn, grad_out)
        return dvalue, None, dloc, dattn


def _level_geometry(value, spatial_shapes, level, loc):
    """The ints that the per-level kernels take after their pointers:
    B, S, M, D, Lq, L, P, level, the level's first value row, H, W."""
    B, S, M, D = value.shape
    H, W = spatial_shapes[level]
    return (B, S, M, D, loc.shape[1], loc.shape[3], loc.shape[4], level,
            level_start_index(spatial_shapes)[level], H, W)


def _level_slices(value, spatial_shapes, level, loc, attn):
    H, W = spatial_shapes[level]
    start = level_start_index(spatial_shapes)[level]
    return (value[:, start:start + H * W], loc[:, :, :, level],
            attn[:, :, :, level], H, W)


def level_forward(value, spatial_shapes: SpatialShapes, level: int, loc,
                  attn, out: torch.Tensor) -> None:
    """Add level `level`'s sampling into `out` (B, Lq, M, D) fp32 in place:
    `msda_level_fwd.cu`, or `_sample_one_level` for CPU tensors."""
    if value.device.type == "cpu":
        out += _sample_one_level(*_level_slices(value, spatial_shapes, level,
                                                loc, attn))
        return
    cuda_ext.launch("msda_level_fwd", value.device, value.data_ptr(),
                    loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
                    *_level_geometry(value, spatial_shapes, level, loc),
                    int(value.dtype == torch.bfloat16))


def level_grad_value(value, spatial_shapes: SpatialShapes, level: int, loc,
                     attn, g, dvalue: torch.Tensor) -> None:
    """Add level `level`'s d value into its rows of `dvalue` (B, S, M, D)
    fp32 in place, for the output gradient g (B, Lq, M * D) in the value
    dtype: `msda_level_dv.cu`, or `level_dv_plain` for CPU tensors."""
    if value.device.type == "cpu":
        _, loc_l, attn_l, H, W = _level_slices(value, spatial_shapes, level,
                                               loc, attn)
        start = level_start_index(spatial_shapes)[level]
        dvalue[:, start:start + H * W] += level_dv_plain(
            loc_l, attn_l, g.reshape(*loc.shape[:3], -1), H, W)
        return
    cuda_ext.launch("msda_level_dv", value.device, loc.data_ptr(),
                    attn.data_ptr(), g.data_ptr(), dvalue.data_ptr(),
                    *_level_geometry(value, spatial_shapes, level, loc),
                    int(g.dtype == torch.bfloat16))


def level_grad_grid(value, spatial_shapes: SpatialShapes, level: int, loc,
                    attn, g, dloc: torch.Tensor, dattn: torch.Tensor) -> None:
    """Write level `level`'s slices of `dloc` (B, Lq, M, L, P, 2) and `dattn`
    (B, Lq, M, L, P), fp32, for the output gradient g (B, Lq, M * D) in the
    value dtype: `msda_level_dgrid.cu`, or `level_dgrid_plain` for CPU
    tensors."""
    if value.device.type == "cpu":
        value_l, loc_l, attn_l, H, W = _level_slices(value, spatial_shapes,
                                                     level, loc, attn)
        dl, da = level_dgrid_plain(value_l, loc_l, attn_l,
                                   g.reshape(*loc.shape[:3], -1), H, W)
        dloc[:, :, :, level] = dl
        dattn[:, :, :, level] = da
        return
    cuda_ext.launch("msda_level_dgrid", value.device, value.data_ptr(),
                    loc.data_ptr(), attn.data_ptr(), g.data_ptr(),
                    dloc.data_ptr(), dattn.data_ptr(),
                    *_level_geometry(value, spatial_shapes, level, loc),
                    int(value.dtype == torch.bfloat16))


class MSDeformAttnLevelFunction(torch.autograd.Function):
    """The per-level kernels with their gradient, for values over
    `ML_MAX_VALUE_BYTES` (counterpart of `msda_pallas._forward`'s and
    `_bwd`'s per-level branches): one `msda_level_fwd` launch per level,
    summed into an fp32 (B, Lq, M, D) and cast to the value dtype once; one
    `msda_level_dv` and one `msda_level_dgrid` launch per level backward."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, loc, attn):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, loc, attn)
        B, _, M, D = value.shape
        Lq = loc.shape[1]
        out = torch.zeros((B, Lq, M, D), dtype=torch.float32,
                          device=value.device)
        for level in range(len(spatial_shapes)):
            level_forward(value, spatial_shapes, level, loc, attn, out)
        return out.reshape(B, Lq, M * D).to(value.dtype)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        shapes = ctx.spatial_shapes
        B, _, M, D = value.shape
        if tuple(grad_out.shape) != (B, loc.shape[1], M * D) \
                or grad_out.dtype != value.dtype:
            raise ValueError(f"output gradient {tuple(grad_out.shape)} "
                             f"{grad_out.dtype} must be ({B}, {loc.shape[1]}"
                             f", {M * D}) {value.dtype}")
        g = grad_out.contiguous()
        dvalue = torch.zeros(value.shape, dtype=torch.float32,
                             device=value.device)
        dloc = torch.empty_like(loc)
        dattn = torch.empty_like(attn)
        for level in range(len(shapes)):
            level_grad_value(value, shapes, level, loc, attn, g, dvalue)
            level_grad_grid(value, shapes, level, loc, attn, g, dloc, dattn)
        return dvalue.to(value.dtype), None, dloc, dattn


def ms_deform_attn(value: torch.Tensor, spatial_shapes: SpatialShapes,
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor,
                   query_segments: Optional[Tuple[int, ...]] = None
                   ) -> torch.Tensor:
    """MSDA sampling, (B, Lq, M * D) in the value dtype, differentiable in
    the value, the locations and the weights. CPU tensors take the plain
    version (autograd differentiates it); CUDA tensors take the kernels of
    `msda_route`'s route, through `MSDeformAttnFunction` or
    `MSDeformAttnLevelFunction`, or raise if they cannot take them.
    `query_segments` is the TPU kernel's tiling hint and is ignored."""
    del query_segments
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                    attention_weights)
    check_kernel_inputs(value, spatial_shapes, sampling_locations,
                        attention_weights)
    fn = (MSDeformAttnFunction
          if msda_route(value.shape, value.dtype) == "fused"
          else MSDeformAttnLevelFunction)
    return fn.apply(value, tuple(spatial_shapes), sampling_locations,
                    attention_weights)


def msda_grid_init(n_heads: int, n_levels: int, n_points: int) -> torch.Tensor:
    """Directional bias of the sampling-offset head (reference
    `MSDeformAttn._reset_parameters`): head h points along angle
    2*pi*h/n_heads, scaled to the unit Linf ball and by (point index + 1)."""
    thetas = torch.arange(n_heads, dtype=torch.float32) * (2.0 * math.pi
                                                           / n_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], dim=-1)      # (M, 2)
    grid = grid / grid.abs().max(dim=-1, keepdim=True).values
    grid = grid[:, None, None, :].repeat(1, n_levels, n_points, 1)
    scale = torch.arange(1, n_points + 1, dtype=torch.float32)
    return (grid * scale[None, None, :, None]).reshape(-1)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention module (counterpart of
    `vitadapter.ops.msda.MSDeformAttn`; parameter names are the reference's).

    forward(query (B, Lq, C), reference_points (B|1, Lq, L|1, 2 or 4),
    input_flatten (B, S, C), spatial_shapes, input_padding_mask (B, S)
    True-for-pad) -> (B, Lq, C).
    """

    def __init__(self, d_model: int = 256, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4, ratio: float = 1.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if d_model % n_heads != 0:
            raise ValueError(f"d_model ({d_model}) must be divisible by "
                             f"n_heads ({n_heads})")
        d_value = int(d_model * ratio)
        if d_value % n_heads != 0:
            raise ValueError(f"value dim ({d_value}) must be divisible by "
                             f"n_heads ({n_heads})")
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        M, L, P = n_heads, n_levels, n_points
        lin = dict(dtype=dtype, device=device)
        self.sampling_offsets = Linear(d_model, M * L * P * 2, **lin)
        self.attention_weights = Linear(d_model, M * L * P, **lin)
        self.value_proj = Linear(d_model, d_value, **lin)
        self.output_proj = Linear(d_value, d_model, **lin)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The reference init: zero offset/weight kernels, directional offset
        bias, xavier-uniform value/output projections, zero biases."""
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(msda_grid_init(
            self.n_heads, self.n_levels, self.n_points))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()
        for lin in (self.value_proj, self.output_proj):
            fan_out, fan_in = lin.weight.shape
            a = math.sqrt(6.0 / (fan_in + fan_out))
            lin.weight.uniform_(-a, a, generator=generator)
            lin.bias.zero_()

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                input_flatten: torch.Tensor, spatial_shapes: SpatialShapes,
                input_padding_mask: Optional[torch.Tensor] = None,
                query_segments: Optional[Sequence[int]] = None
                ) -> torch.Tensor:
        B, Lq, _ = query.shape
        S = input_flatten.shape[1]
        M, L, P = self.n_heads, self.n_levels, self.n_points
        if S != sum(level_sizes(spatial_shapes)) or L != len(spatial_shapes):
            raise ValueError(f"input of {S} rows / {L} levels does not match "
                             f"spatial shapes {spatial_shapes}")

        value = self.value_proj(input_flatten)
        if input_padding_mask is not None:
            value = value.masked_fill(input_padding_mask[..., None], 0.0)
        value = value.reshape(B, S, M, -1)

        offsets = self.sampling_offsets(query).reshape(B, Lq, M, L, P, 2)
        attn = self.attention_weights(query).reshape(B, Lq, M, L * P)
        attn = torch.softmax(attn.float(), dim=-1).reshape(B, Lq, M, L, P)

        ref = reference_points.float()
        if ref.shape[-1] == 2:
            # normalizer is (W, H) per level: x offsets scale by width
            normalizer = torch.tensor([(w, h) for h, w in spatial_shapes],
                                      dtype=torch.float32, device=query.device)
            locations = (ref[:, :, None, :, None, :]
                         + offsets.float()
                         / normalizer[None, None, None, :, None, :])
        elif ref.shape[-1] == 4:
            locations = (ref[:, :, None, :, None, :2]
                         + offsets.float() / P
                         * ref[:, :, None, :, None, 2:] * 0.5)
        else:
            raise ValueError("reference_points last dim must be 2 or 4, got "
                             f"{ref.shape[-1]}")

        out = ms_deform_attn(value.contiguous(), tuple(spatial_shapes),
                             locations.contiguous(), attn.contiguous(),
                             query_segments=query_segments)
        return self.output_proj(out)
