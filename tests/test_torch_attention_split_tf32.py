"""The split-TF32 arithmetic of the fp32 attention kernels, emulated on the
CPU.

`attention_fwd.cu` and `attention_bwd.cu` run every fp32 product on the
tensor cores in TF32 as three products: each operand x as hi = x with its
13 low mantissa bits cleared (exactly TF32) and lo = x - hi, each product
as A_lo B_hi + A_hi B_lo + A_hi B_hi (`sm90.cuh`). Here the same split goes
through plain fp32 matmuls, lo truncated to TF32 by the same mask (the
tensor cores read TF32 operands), for S = q k^T, P v, dP = dO v^T, dS k,
P^T dO and dS^T q, and the forward, log-sum-exp and gradients are held
against the fp64 plain version at the card's fp32 criterion. One TF32
product per product misses that criterion: that is why the kernels take
three. What the emulation leaves out is the tensor cores' own
accumulation (the kernels bound its drift by summing each tile's product
in a fresh accumulator); `chip_smoke.py` holds the kernels themselves to
the same criterion on the card.
"""

import numpy as np
import pytest
import torch

# chip_smoke.py's TOL[float32] (outputs and the log-sum-exp: 1e-5 + 1e-5 of
# |reference|) and GRAD_TOL (gradients: 1e-5 of the reference's largest
# |value| + 1e-5 of |reference|)
ATOL, RTOL = 1e-5, 1e-5
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make the small eager ops here many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf32(x):
    """x with its 13 low mantissa bits cleared: exactly TF32."""
    return (x.view(torch.int32) & -(1 << 13)).view(torch.float32)


def _matmul(a, b, passes):
    """a @ b in fp32 from TF32 operands: three products of the hi/lo split
    (small first, as the kernels issue them) or one of the truncated
    operands."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _emulated(q, k, v, g, passes):
    """(out, lse, dq, dk, dv) as the kernels compute them: the forward's
    online softmax equals this one up to fp32 rounding; the backward takes
    P = exp(S - lse) and delta = rowsum(dO * out)."""
    scale = q.shape[-1] ** -0.5
    kt = k.transpose(-1, -2)
    s = _matmul(q, kt, passes) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = _matmul(p, v, passes) / l
    lse = (m + torch.log(l))[..., 0]
    p = torch.exp(_matmul(q, kt, passes) * scale - lse[..., None])
    dp = _matmul(g, v.transpose(-1, -2), passes)
    ds = p * (dp - (g * out).sum(-1, keepdim=True))
    dq = _matmul(ds, k, passes) * scale
    dk = _matmul(ds.transpose(-1, -2), q, passes) * scale
    dv = _matmul(p.transpose(-1, -2), g, passes)
    return out, lse, dq, dk, dv


def _reference(q, k, v, g):
    """The same five in fp64 through autograd of softmax(q k^T s) v."""
    q, k, v = (t.double().requires_grad_() for t in (q, k, v))
    s = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    out = torch.softmax(s, -1) @ v
    grads = torch.autograd.grad(out, (q, k, v), g.double())
    return (out.detach(), torch.logsumexp(s, -1).detach(), *grads)


def _inputs(N, D, seed=0, B=1, H=1):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal((B, H, N, D))
                             .astype(np.float32)) for _ in range(4)]


def _within(got, ref, grad):
    """chip_smoke's `close` (grad False) or `close_grad` criterion."""
    err = (got.double() - ref).abs()
    floor = GRAD_TOL * float(ref.abs().max()) if grad else ATOL
    return bool((err <= floor + RTOL * ref.abs()).all()), float(err.max())


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("N", [1024, 77])
def test_split_tf32_meets_fp32_tolerance(N, D):
    q, k, v, g = _inputs(N, D)
    got = _emulated(q, k, v, g, passes=3)
    ref = _reference(q, k, v, g)
    for i, name in enumerate(("out", "lse", "dq", "dk", "dv")):
        ok, err = _within(got[i], ref[i], grad=i >= 2)
        assert ok, f"{name}: max abs error {err:.3e}"


def test_single_tf32_product_misses_fp32_tolerance():
    q, k, v, g = _inputs(1024, 64)
    got = _emulated(q, k, v, g, passes=1)
    ref = _reference(q, k, v, g)
    ok, err = _within(got[0], ref[0], grad=False)
    assert not ok and err > 1e-4, err
    assert not all(_within(got[i], ref[i], grad=True)[0] for i in (2, 3, 4))
