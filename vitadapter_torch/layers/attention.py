"""Self-attention for the ViT backbone (counterpart of
`vitadapter/layers/attention.py`): `mha`, the global `Attention` and the
non-overlapping window `WindowedAttention` with `window_partition` /
`window_reverse`."""

import math

import torch
import torch.nn.functional as F
from torch import nn

from vitadapter_torch.layers.linear import Linear
from vitadapter_torch.ops.attention import fused_attention


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nWindows, ws*ws, C). H, W divisible by ws."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // ws) * (W // ws), ws * ws, C)


def window_reverse(x: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """(B, nWindows, ws*ws, C) -> (B, H, W, C)."""
    B, C = x.shape[0], x.shape[-1]
    x = x.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        scale: float) -> torch.Tensor:
    """Attention core over (B, heads, N, Dh) with fp32 scores: the fused
    kernel on CUDA tensors, its plain version on CPU tensors."""
    return fused_attention(q, k, v, scale)


class Attention(nn.Module):
    """Global MHSA over tokens (B, N, C)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias, dtype=dtype,
                          device=device)
        self.proj = Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        Dh = C // self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, Dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
        out = mha(q, k, v, Dh ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class WindowedAttention(Attention):
    """MHSA inside non-overlapping `window_size` windows. The qkv
    projection's output, bias included, is zero-padded at the bottom and
    right to a window multiple, so padded keys enter each softmax with
    logit 0 and value 0 (the reference's semantics). The windows go to
    `mha`, and so to the fused kernel, as one batch of B * windows."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 window_size: int = 14, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__(dim, num_heads, qkv_bias, dtype, device)
        self.window_size = window_size

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, N, C = x.shape
        if N != H * W:
            raise ValueError(f"{N} tokens for a {H}x{W} grid")
        ws, heads = self.window_size, self.num_heads
        Dh = C // heads
        Hp, Wp = math.ceil(H / ws) * ws, math.ceil(W / ws) * ws
        qkv = F.pad(self.qkv(x).reshape(B, H, W, 3 * C),
                    (0, 0, 0, Wp - W, 0, Hp - H))
        qkv = window_partition(qkv, ws)                 # (B, L, ws*ws, 3C)
        L, Nw = qkv.shape[1], ws * ws
        qkv = qkv.reshape(B * L, Nw, 3, heads, Dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
        out = mha(q, k, v, Dh ** -0.5)                  # (B*L, heads, Nw, Dh)
        out = out.transpose(1, 2).reshape(B, L, Nw, C)
        out = window_reverse(out, ws, Hp, Wp)[:, :H, :W].reshape(B, N, C)
        return self.proj(out)
