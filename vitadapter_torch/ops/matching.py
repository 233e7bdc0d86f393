"""Hungarian (bipartite) matching for the set-prediction losses
(counterpart of `vitadapter/ops/matching.py`).

The costs are those of the reference `MaskHungarianAssigner`
(`segmentation/mmseg_custom/models/utils/assigner.py:41`), batched over
leading dimensions. `hungarian_assign` solves the assignment by default on
the device with the epsilon auction of the JAX package's `auction_pallas`
(Bertsekas; the gts bid for the queries, one round of eps = span / 2000):
the Hopper kernel `csrc/auction.cu` for CUDA tensors, `auction_assign_plain`
for CPU tensors. Both make the Pallas kernel's fp32 additions in its order
and break ties as it does, so they give the same matches on the same costs;
the total matched cost is within n_valid * eps of scipy's optimum. Its
`impl` argument also offers the JAX package's host solvers: scipy's exact
solve (`"callback"`) and the native LAPJV (`"native"`, `ops/native.py`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vitadapter_torch.ops import cuda_ext, native

EPS_DIV = 2000.0
MAX_ITERS = 5000
NEG = -1e30
# dynamic shared memory a Hopper block may opt into, bytes
SMEM_OPTIN = 227 * 1024


def auction_assign_plain(cost: torch.Tensor, n_valid: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The auction of `auction_pallas._auction_kernel`, all matrices in
    lockstep: cost (B, Q, G) fp32, n_valid (B,) -> (owner (B, Q) int64, the
    matched gt of each query or -1; rounds run per matrix (B,) int64)."""
    B, Q, G = cost.shape
    dev = cost.device
    owner = torch.full((B, Q), -1, dtype=torch.int64, device=dev)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)
    if G == 0 or Q == 0:
        return owner, iters
    ig = torch.arange(G, device=dev)
    iq = torch.arange(Q, device=dev)
    gt_ok = ig[None] < n_valid.to(dev)[:, None]                  # (B, G)
    ben = torch.where(gt_ok[:, :, None], -cost.float().transpose(1, 2),
                      NEG)                                         # (B, G, Q)
    span = torch.where(ben > NEG / 2, ben.abs(), 0.0).amax(
        dim=(1, 2)).clamp(min=1e-6)[:, None]                       # (B, 1)
    # a tensor divisor: on CUDA a scalar one is applied as a product with
    # its reciprocal, one ulp off the division the kernel and JAX make, and
    # on contested costs one ulp of eps changes the matches
    eps = span / torch.full_like(span, EPS_DIV)
    price = torch.zeros((B, Q), dtype=torch.float32, device=dev)
    for _ in range(MAX_ITERS):
        assigned = (owner[:, None, :] == ig[None, :, None]).any(-1)
        free = gt_ok & ~assigned                                   # (B, G)
        active = free.any(-1)
        if not bool(active.any()):
            break
        iters += active
        values = ben - price[:, None, :]
        best_v = values.amax(-1)
        best_q = torch.where(values >= best_v[..., None], iq, Q).amin(-1)
        is_best = iq == best_q[..., None]                          # (B, G, Q)
        second_v = torch.where(is_best, NEG, values).amax(-1)
        second_v = torch.where(second_v > NEG / 2, second_v, best_v - span)
        bid = price.gather(1, best_q) + (best_v - second_v) + eps  # (B, G)
        bids = is_best & free[..., None]
        bid_mat = torch.where(bids, bid[..., None], float("-inf"))
        item_bid = bid_mat.amax(1)                                 # (B, Q)
        has_bid = item_bid > float("-inf")
        win = torch.where(bids & (bid_mat >= item_bid[:, None]),
                          ig[None, :, None], G).amin(1)
        owner = torch.where(has_bid, win, owner)
        price = torch.where(has_bid, item_bid, price)
    return owner, iters


def auction_smem_bytes(Q: int, G: int) -> int:
    """Shared memory, bytes, one block of `csrc/auction.cu` takes for a
    (Q, G) cost matrix: its `smem_bytes` (an 8-byte bid key, the price and
    the owner of each query, the (G, Q) fp32 benefit matrix, two free lists
    and the bid slots of G ints) plus its static `kStaticSmem` (a float
    for each of its 16 warps, 3 ints)."""
    return 8 * Q + 4 * (G * Q + 2 * Q + 3 * G) + 4 * 16 + 4 * 3


def check_kernel_inputs(cost: torch.Tensor, n_valid: torch.Tensor) -> None:
    """Raise ValueError on anything the auction kernel does not take."""
    if cost.dim() != 3 or cost.dtype != torch.float32:
        raise ValueError(f"cost {tuple(cost.shape)} {cost.dtype}: the kernel "
                         "takes (B, Q, G) fp32")
    B, Q, G = cost.shape
    if n_valid.shape != (B,):
        raise ValueError(f"n_valid {tuple(n_valid.shape)} must be ({B},)")
    for name, t in (("cost", cost), ("n_valid", n_valid)):
        if t.device.type != "cuda" or t.device != cost.device:
            raise ValueError(f"{name} must be on the cost's CUDA device, got "
                             f"{t.device}")
    if not cost.is_contiguous():
        raise ValueError("cost must be contiguous")
    smem = auction_smem_bytes(Q, G)
    if smem > SMEM_OPTIN:
        raise ValueError(f"a ({Q}, {G}) cost matrix needs {smem} bytes of "
                         f"shared memory; one block has {SMEM_OPTIN}")


def _kernel_auction(cost: torch.Tensor, n_valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`csrc/auction.cu`: (owner (B, Q) int32, rounds run (B,) int32)."""
    B, Q, G = cost.shape
    nv = n_valid.to(torch.int32).contiguous()
    owner = torch.empty((B, Q), dtype=torch.int32, device=cost.device)
    iters = torch.empty(B, dtype=torch.int32, device=cost.device)
    cuda_ext.launch("auction", cost.device, cost.data_ptr(), nv.data_ptr(),
                    owner.data_ptr(), iters.data_ptr(), B, Q, G, EPS_DIV,
                    MAX_ITERS)
    return owner, iters


def solve_batch(cost: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """scipy's exact solve (a copy of the JAX package's `_solve_batch`):
    cost (B, Q, G), n_valid (B,) -> the assigned gt of each query (B, Q)
    int32, -1 for unassigned."""
    from scipy.optimize import linear_sum_assignment

    B, Q, G = cost.shape
    out = np.full((B, Q), -1, np.int32)
    for b in range(B):
        n = int(n_valid[b])
        if n <= 0:
            continue
        c = np.nan_to_num(np.asarray(cost[b, :, :n], np.float64),
                          nan=1e8, posinf=1e8, neginf=-1e8)
        rows, cols = linear_sum_assignment(c)
        out[b, rows] = cols
    return out


HOST_SOLVERS = {"callback": solve_batch, "native": native.lap_solve_batch}
IMPLS = ("auto", "auction", "auction_kernel", *HOST_SOLVERS)


def hungarian_assign(cost: torch.Tensor, n_valid: torch.Tensor,
                     impl: str = "auto") -> torch.Tensor:
    """Batched assignment. cost (B, Q, G) fp32, n_valid (B,): the first
    n_valid[b] gt columns of matrix b are real. Returns (B, Q) int64 on the
    cost's device: the matched gt index of each query, or -1.

    impl (the JAX package's, with `auction_kernel` for its `auction_pallas`):
      'auto'           — `auction_assign_plain` on CPU tensors, the kernel on
                         CUDA tensors (or raise if it cannot take them).
      'auction'        — `auction_assign_plain` on the cost's device.
      'auction_kernel' — `csrc/auction.cu`; CUDA tensors only.
      'callback'       — scipy's exact solve on the host (`solve_batch`).
      'native'         — the native LAPJV on the host (`ops/native.py`).
    The host solvers copy the cost to the host and the result back, as the
    JAX package's `pure_callback` does. On one CPU device JAX's 'auto' is
    'callback'; here it stays the auction (ROADMAP.md §3)."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r}: one of {IMPLS}")
    if impl == "auto":
        impl = "auction" if cost.device.type == "cpu" else "auction_kernel"
    if impl in HOST_SOLVERS:
        host = HOST_SOLVERS[impl](
            cost.detach().float().cpu().numpy(),
            n_valid.detach().to(torch.int32).cpu().numpy())
        return torch.from_numpy(np.asarray(host, np.int64)).to(cost.device)
    if impl == "auction":
        return auction_assign_plain(cost, n_valid)[0]
    B, Q, G = cost.shape
    if G == 0 or Q == 0:
        return torch.full((B, Q), -1, dtype=torch.int64, device=cost.device)
    check_kernel_inputs(cost, n_valid)
    return _kernel_auction(cost, n_valid)[0].long()


def classification_cost(cls_logits: torch.Tensor, gt_labels: torch.Tensor,
                        weight: float = 1.0) -> torch.Tensor:
    """-softmax prob of each gt class. cls_logits (..., Q, K+1), gt_labels
    (..., G) -> (..., Q, G)."""
    prob = torch.softmax(cls_logits.float(), dim=-1)
    Q = prob.shape[-2]
    idx = gt_labels[..., None, :].expand(*gt_labels.shape[:-1], Q,
                                         gt_labels.shape[-1])
    return -prob.gather(-1, idx) * weight


def bce_mask_cost(pred_pts: torch.Tensor, gt_pts: torch.Tensor,
                  weight: float = 1.0) -> torch.Tensor:
    """Pairwise binary CE between mask logits and binary gt masks at the
    sampled points. pred_pts (..., Q, P), gt_pts (..., G, P) -> (..., Q,
    G)."""
    P = pred_pts.shape[-1]
    pred = pred_pts.float()
    gt = gt_pts.float().transpose(-1, -2)
    pos = F.softplus(-pred)          # -log sigmoid(x)
    neg = F.softplus(pred)           # -log (1 - sigmoid(x))
    cost = pos @ gt + neg @ (1 - gt)
    return cost / P * weight


def dice_cost(pred_pts: torch.Tensor, gt_pts: torch.Tensor,
              weight: float = 1.0, eps: float = 1.0) -> torch.Tensor:
    """Pairwise naive-dice cost at the sampled points. (..., Q, P),
    (..., G, P) -> (..., Q, G)."""
    p = torch.sigmoid(pred_pts.float())
    g = gt_pts.float()
    numer = 2 * (p @ g.transpose(-1, -2))
    denom = p.sum(-1)[..., :, None] + g.sum(-1)[..., None, :]
    return (1 - (numer + eps) / (denom + eps)) * weight
