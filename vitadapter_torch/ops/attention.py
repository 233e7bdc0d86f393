"""Fused multi-head attention: the Hopper kernels' wrapper, with its
gradient, and its plain version.

Counterpart of `vitadapter/ops/attention_pallas.py::fused_mha`. The kernels
are `csrc/attention_fwd.cu` (forward) and `csrc/attention_bwd.cu` (dq, dk,
dv; it recomputes the softmax from q, k, v as the TPU kernel does, so the
forward saves nothing but its inputs). Layout (B, H, N, D), as in JAX.

Numerics: scores, softmax and the output sum are fp32 in both versions, as in
the TPU kernel (which also rounds the probabilities to the value dtype before
P.V, and P and dS before its backward products; neither version here does).
The XLA path of `layers.attention.mha` rounds the logits to the value dtype
before its softmax, so bf16 results of the two differ by bf16 rounding.
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


def attention_plain_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, grad_out: torch.Tensor,
                             scale: Optional[float] = None):
    """(dq, dk, dv) of `attention_plain` for the output gradient `grad_out`:
    autograd of the plain version, fp32 throughout, rounded to the input
    dtype at the end."""
    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out = attention_plain(q, k, v, scale)
        return torch.autograd.grad(out, (q, k, v), grad_out)


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """Raise ValueError on anything the attention kernels do not take."""
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


def _kernel_forward(q, k, v, scale: float) -> torch.Tensor:
    B, H, N, D = q.shape
    out = torch.empty_like(q)
    cuda_ext.launch("attention_fwd", q.device, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(), B * H, N, D, float(scale),
                    int(q.dtype == torch.bfloat16))
    return out


def _kernel_backward(q, k, v, grad_out, scale: float):
    """`attention_bwd.cu`: (dq, dk, dv) in the input dtype."""
    if grad_out.shape != q.shape or grad_out.dtype != q.dtype:
        raise ValueError(f"output gradient {tuple(grad_out.shape)} "
                         f"{grad_out.dtype} must match q {tuple(q.shape)} "
                         f"{q.dtype}")
    grad_out = grad_out.contiguous()
    B, H, N, D = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # row log-sum-exp and rowsum(dO * O), fp32
    stats = torch.empty((B * H, N, 2), dtype=torch.float32, device=q.device)
    cuda_ext.launch("attention_bwd", q.device, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), grad_out.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), B * H, N,
                    D, float(scale), int(q.dtype == torch.bfloat16))
    return dq, dk, dv


class FusedAttentionFunction(torch.autograd.Function):
    """The kernels with their gradient (counterpart of `fused_mha`'s
    `jax.custom_vjp`)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        return _kernel_forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        return (*_kernel_backward(q, k, v, grad_out, ctx.scale), None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, H, N, D), differentiable in q, k and v. CPU
    tensors take the plain version (autograd differentiates it); CUDA
    tensors take the kernels through `FusedAttentionFunction`, or raise if
    they cannot take them."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    check_kernel_inputs(q, k, v)
    return FusedAttentionFunction.apply(q, k, v, float(scale))
