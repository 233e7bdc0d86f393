"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the
700 W limit) and the least time a piece of work can take on it: the larger
of its bytes over the HBM rate and its operations over the peak of the
units that can run them. Each input byte is counted read once and each
output byte written once."""

from __future__ import annotations

from typing import Dict

import torch

HBM_BYTES_PER_S = 3.35e12
# tensor-core peaks: bf16 and fp16; fp32 products at the TF32 peak, the
# highest any fp32 implementation can reach, so that no share passes 100%
MATMUL_PEAK = {torch.bfloat16: 989e12, torch.float16: 989e12,
               torch.float32: 495e12}
# the CUDA cores' fp32 rate: multi-scale deformable attention's sampling
# arithmetic is fp32 whatever the value's dtype
FP32_SIMT_PEAK = 67e12
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def bound_s(nbytes: float, flops: float, peak: float) -> float:
    """Least time of the work: bytes over HBM rate or operations over
    `peak`, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def msda_bound_s(call: Dict, backward: bool = True) -> float:
    """Least time of one multi-scale deformable attention call, forward and
    (with `backward`) backward, from its shapes alone: B, S (value rows),
    M (heads), D (head width), Lq (queries), L (levels), P (points) and
    the value's bytes an element `es`. Locations (2 fp32 a point) and
    weights (1 fp32 a point) are read; the forward reads the value and
    writes (B, Lq, M * D); every point's four corners are taken as in the
    map, 2 operations a channel a corner forward and 4 backward (the
    gradient dot and the scaled scatter). The backward reads the value,
    the locations, the weights and the output gradient, and writes the
    value's, the locations' and the weights' gradients."""
    B, S, M, D = call["B"], call["S"], call["M"], call["D"]
    Lq, L, P, es = call["Lq"], call["L"], call["P"], call["es"]
    points = B * Lq * M * L * P
    value = B * S * M * D * es
    out = B * Lq * M * D * es
    loc, attn = points * 2 * 4, points * 4
    corners = 4 * points
    t = bound_s(value + loc + attn + out, 2 * D * corners, FP32_SIMT_PEAK)
    if backward:
        t += bound_s(value + loc + attn + out + value + loc + attn,
                     4 * D * corners, FP32_SIMT_PEAK)
    return t


def attention_bound_s(call: Dict, backward: bool = True) -> float:
    """Least time of one attention call softmax(q k^T) v over (B, H, N, D)
    in the call's dtype, forward and (with `backward`) backward. Forward:
    q, k, v read, the output and the fp32 row log-sum-exp written, 2
    products of 2 B H N^2 D operations. Backward: q, k, v, the output, its
    gradient and the log-sum-exp read, dq, dk, dv written, 4 products
    (dP, dV, dQ, dK; the scores' recomputation is not counted)."""
    B, H, N, D, es = call["B"], call["H"], call["N"], call["D"], call["es"]
    peak = MATMUL_PEAK[torch.float32 if es == 4 else torch.bfloat16]
    x = B * H * N * D * es
    lse = B * H * N * 4
    t = bound_s(4 * x + lse, 4 * B * H * N * N * D, peak)
    if backward:
        t += bound_s(8 * x + lse, 8 * B * H * N * N * D, peak)
    return t
