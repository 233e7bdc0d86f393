"""Sine positional encoding (counterpart of
`vitadapter/layers/positional.py::sine_positional_encoding`)."""

import math
from typing import Tuple

import torch


def sine_positional_encoding(hw: Tuple[int, int], num_feats: int,
                             device=None, temperature: float = 10000.0,
                             normalize: bool = True,
                             scale: float = 2 * math.pi,
                             eps: float = 1e-6) -> torch.Tensor:
    """(H, W, 2 * num_feats) fp32 sine/cosine embedding, channels
    [pos_y, pos_x] (mmcv `SinePositionalEncoding` with no padding)."""
    H, W = hw
    f32 = dict(dtype=torch.float32, device=device)
    y = torch.arange(1, H + 1, **f32)[:, None] * torch.ones((1, W), **f32)
    x = torch.arange(1, W + 1, **f32)[None, :] * torch.ones((H, 1), **f32)
    if normalize:
        y = y / (H + eps) * scale
        x = x / (W + eps) * scale
    dim_t = torch.arange(num_feats, **f32)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_feats)
    pos_y = y[..., None] / dim_t
    pos_x = x[..., None] / dim_t
    # sin on even dims, cos on odd dims, interleaved
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=-1).reshape(H, W, num_feats)
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=-1).reshape(H, W, num_feats)
    return torch.cat([pos_y, pos_x], dim=-1)
