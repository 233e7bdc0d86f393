"""Global self-attention for the ViT backbone (counterpart of
`vitadapter/layers/attention.py`: `mha` and `Attention`; the windowed
variant is not ported yet)."""

import torch
from torch import nn

from vitadapter_torch.layers.linear import Linear
from vitadapter_torch.ops.attention import fused_attention


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
