"""Multi-scale deformable attention (MSDA) in plain PyTorch: the sampling
as `F.grid_sample` (bilinear, zero padding, align_corners=False), as the
reference's `ms_deform_attn_core_pytorch`, and the `MSDeformAttn` module.

Layouts: value (B, S, M, D), sampling locations (B, Lq, M, L, P, 2) as
(x, y) in [0, 1], attention weights (B, Lq, M, L, P); the result is
(B, Lq, M * D) in the value dtype, sums in fp32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.layers.linear import Linear

SpatialShapes = Tuple[Tuple[int, int], ...]
# a list that, when set, receives the shapes of every call (the
# benchmark's bound arithmetic reads them)
RECORD = None


def level_sizes(spatial_shapes: SpatialShapes) -> Tuple[int, ...]:
    return tuple(h * w for h, w in spatial_shapes)


def level_start_index(spatial_shapes: SpatialShapes) -> Tuple[int, ...]:
    starts = [0]
    for h, w in spatial_shapes[:-1]:
        starts.append(starts[-1] + h * w)
    return tuple(starts)


def ms_deform_attn(value: torch.Tensor, spatial_shapes: SpatialShapes,
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """MSDA sampling by `F.grid_sample`, level by level, in fp32."""
    B, S, M, D = value.shape
    Lq, L, P = sampling_locations.shape[1], sampling_locations.shape[3], \
        sampling_locations.shape[4]
    if L != len(spatial_shapes) or S != sum(level_sizes(spatial_shapes)):
        raise ValueError(f"value rows {S} / levels {L} do not match "
                         f"spatial shapes {spatial_shapes}")
    if RECORD is not None:
        RECORD.append(dict(B=B, S=S, M=M, D=D, Lq=Lq, L=L, P=P,
                           es=value.element_size()))
    grids = 2 * sampling_locations.float() - 1
    out = torch.zeros((B * M, D, Lq), dtype=torch.float32,
                      device=value.device)
    for lvl, (start, (H, W)) in enumerate(
            zip(level_start_index(spatial_shapes), spatial_shapes)):
        v = value[:, start:start + H * W].float().permute(0, 2, 3, 1)
        v = v.reshape(B * M, D, H, W)
        g = grids[:, :, :, lvl].transpose(1, 2).reshape(B * M, Lq, P, 2)
        s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                          align_corners=False)               # (BM, D, Lq, P)
        a = attention_weights[:, :, :, lvl].float().transpose(1, 2)
        out = out + (s * a.reshape(B * M, 1, Lq, P)).sum(-1)
    out = out.reshape(B, M, D, Lq).permute(0, 3, 1, 2)
    return out.reshape(B, Lq, M * D).to(value.dtype)

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
                             locations.contiguous(), attn.contiguous())
        return self.output_proj(out)
