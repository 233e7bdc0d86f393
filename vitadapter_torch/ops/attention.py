"""Fused multi-head attention: the Hopper kernel's wrapper and its plain
version.

Counterpart of `vitadapter/ops/attention_pallas.py::fused_mha` (forward).
The kernel is `csrc/attention_fwd.cu`. Layout (B, H, N, D), as in JAX.

Numerics: scores, softmax and the output sum are fp32 in both versions, as in
the TPU kernel (which also rounds the probabilities to the value dtype before
P.V; neither version here does). The XLA path of `layers.attention.mha`
rounds the logits to the value dtype before its softmax, so bf16 results of
the two differ by bf16 rounding.
"""

from __future__ import annotations

from typing import Optional

import torch

from vitadapter_torch.ops import cuda_ext

HEAD_DIMS = (32, 64, 128)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q @ k^T * scale) @ v with fp32 scores, in the input dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """Raise ValueError on anything `attention_fwd.cu` does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got "
                             f"{t.device}")
        if t.dtype != q.dtype or t.dtype not in (torch.float32,
                                                 torch.bfloat16):
            raise ValueError(f"{name}: dtype {t.dtype}; the kernel takes "
                             "q, k, v all fp32 or all bf16")
        if t.shape != q.shape or t.dim() != 4:
            raise ValueError(f"{name}: shape {tuple(t.shape)}; the kernel "
                             "takes q, k, v of one (B, H, N, D) shape")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, H, N, D). CPU tensors take the plain version; CUDA
    tensors take the kernel, or raise if it cannot take them."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    check_kernel_inputs(q, k, v)
    B, H, N, D = q.shape
    out = torch.empty_like(q)
    cuda_ext.launch("attention_fwd", q.device, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(), B * H, N, D, float(scale),
                    int(q.dtype == torch.bfloat16))
    return out
