"""Fused multi-head attention: the Hopper kernels' wrapper, with its
gradient, and its plain versions.

Counterpart of `vitadapter/ops/attention_pallas.py::fused_mha`. The kernels
are `csrc/attention_fwd.cu` (the output, the row log-sum-exp and, for a
backward, the output in fp32) and `csrc/attention_bwd.cu` (dq, dk, dv from
q, k, v, the saved fp32 output and log-sum-exp, and the output gradient; the
TPU kernel saves only q, k, v and recomputes the rest, which gives the same
gradient). Layout (B, H, N, D), as in JAX.

Numerics: scores, softmax and every sum are fp32 in all versions, as in the
TPU kernel. The bf16 kernels run their products on the tensor cores and
feed the probabilities P (forward and backward) and dS (backward) to them
as bf16 hi/lo pairs, about 2^-17 relative, where the TPU kernel rounds them
to bf16; a forward that saves for a backward also keeps its fp32 output,
from which the backward's rowsum(dO * O) is taken. The fp32 kernels run
every product on the tensor cores in split TF32: each fp32 operand x as hi
(x with its 13 low mantissa bits cleared, exactly TF32) and lo = x - hi,
each product as A_lo B_hi + A_hi B_lo + A_hi B_hi, about 2^-20 relative
(one TF32 product, about 2^-11, would miss fp32's tolerances); a pre-pass
writes the operands' hi/lo copies into a scratch this module allocates
(`split_scratch_floats`), and P and dS are split in registers. The plain
versions keep everything in fp32. The XLA path of
`layers.attention.mha` rounds the logits to the value dtype before its
softmax, so bf16 results of the two differ by bf16 rounding. The JAX
package's windowed attention always takes that path (its 5-D
(B, windows, heads, ws*ws, Dh) calls are not `fusable`); the port sends
the windows here as (B * windows, heads, ws*ws, Dh), N = 196 for the
detection configs' 14x14 windows, a length the kernels cover with a
masked tail tile.
"""

from __future__ import annotations

from typing import Optional

import torch

from vitadapter_torch.ops import cuda_ext

HEAD_DIMS = (32, 64, 128)


def _scores(q, k, scale):
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def attention_plain_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None):
    """The forward kernel's function: softmax(q @ k^T * scale) @ v with fp32
    scores, in the input dtype; the fp32 row log-sum-exp of the scaled
    scores (B, H, N); and the output in fp32 (the same tensor for fp32
    inputs)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _scores(q, k, scale)
    out32 = torch.matmul(torch.softmax(s, dim=-1), v.float())
    return out32.to(q.dtype), torch.logsumexp(s, dim=-1), out32


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q @ k^T * scale) @ v with fp32 scores, in the input dtype."""
    return attention_plain_lse(q, k, v, scale)[0]


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


def attention_plain_backward_lse(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, out: torch.Tensor,
                                 lse: torch.Tensor, grad_out: torch.Tensor,
                                 scale: Optional[float] = None):
    """The backward kernel's function: (dq, dk, dv) from the forward's fp32
    output `out` and log-sum-exp `lse`, in fp32, rounded to the input dtype:
    P = exp(S - lse), delta = rowsum(dO * out), dS = P (dP - delta)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    g = grad_out.float()
    p = torch.exp(_scores(q, k, scale) - lse[..., None])
    dv = torch.matmul(p.transpose(-1, -2), g)
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    delta = (g * out.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


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
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the bf16 kernels load it by TMA)")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")


def split_scratch_floats(BH: int, N: int, D: int, rows: int,
                         cols: int) -> int:
    """fp32 scratch of the split TF32 kernels' hi/lo copies: `rows`
    operands as laid out, (BH, N, D) each, and `cols` transposed to (BH, D,
    Np), N padded to whole 64-row tiles (`sm90.cuh::padded_rows`)."""
    n_pad = -(-N // 64) * 64
    return 2 * (rows * BH * N * D + cols * BH * D * n_pad)


def _kernel_forward(q, k, v, scale: float, for_backward: bool = False):
    """`attention_fwd.cu`: (the output in the input dtype, the fp32 row
    log-sum-exp (B, H, N), the output in fp32 or None). The fp32 output is
    the output itself for fp32 inputs; for bf16 ones the kernel writes it
    only `for_backward`."""
    B, H, N, D = q.shape
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    if bf16:  # the kernel's `aux`: the fp32 output, or none
        aux = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
               if for_backward else None)
    else:  # the split copies of q, k (rows) and v (columns)
        aux = torch.empty(split_scratch_floats(B * H, N, D, 2, 1),
                          dtype=torch.float32, device=q.device)
    cuda_ext.launch("attention_fwd", q.device, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(),
                    None if aux is None else aux.data_ptr(),
                    lse.data_ptr(), B * H, N, D, float(scale), int(bf16))
    return out, lse, (aux if bf16 else out)


def _kernel_backward(q, k, v, out32, lse, grad_out, scale: float):
    """`attention_bwd.cu`: (dq, dk, dv) in the input dtype, from the
    forward's fp32 output and log-sum-exp."""
    if grad_out.shape != q.shape or grad_out.dtype != q.dtype:
        raise ValueError(f"output gradient {tuple(grad_out.shape)} "
                         f"{grad_out.dtype} must match q {tuple(q.shape)} "
                         f"{q.dtype}")
    if (out32.shape != q.shape or lse.shape != q.shape[:3]
            or out32.dtype != torch.float32 or lse.dtype != torch.float32):
        raise ValueError("the saved output and log-sum-exp must be fp32 of "
                         "shapes (B, H, N, D) and (B, H, N)")
    grad_out = grad_out.contiguous()
    check_kernel_inputs(q, grad_out, grad_out)
    B, H, N, D = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # delta = rowsum(dO * out); for fp32, then the split copies of q, k, v,
    # dO (rows) and k, q, dO (columns), delta padded to 64 floats
    n_delta = B * H * N
    if q.dtype == torch.float32:
        n_delta = -(-n_delta // 64) * 64 + split_scratch_floats(
            B * H, N, D, 4, 3)
    delta = torch.empty(n_delta, dtype=torch.float32, device=q.device)
    cuda_ext.launch("attention_bwd", q.device, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out32.data_ptr(), lse.data_ptr(),
                    grad_out.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), delta.data_ptr(), B * H, N, D,
                    float(scale), int(q.dtype == torch.bfloat16))
    return dq, dk, dv


class FusedAttentionFunction(torch.autograd.Function):
    """The kernels with their gradient (counterpart of `fused_mha`'s
    `jax.custom_vjp`). `for_backward`: a backward may follow, so the
    forward saves q, k, v, its fp32 output and its log-sum-exp. For fp32
    inputs the saved fp32 output is a copy of the output, so the caller
    may modify the output in place."""

    @staticmethod
    def forward(ctx, q, k, v, scale, for_backward):
        ctx.scale = scale
        out, lse, out32 = _kernel_forward(q, k, v, scale, for_backward)
        if for_backward:
            if out32 is out:
                out32 = out.clone()
            ctx.save_for_backward(q, k, v, out32, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out32, lse = ctx.saved_tensors
        return (*_kernel_backward(q, k, v, out32, lse, grad_out, ctx.scale),
                None, None)


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
    for_backward = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return FusedAttentionFunction.apply(q, k, v, float(scale), for_backward)
