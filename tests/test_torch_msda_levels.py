"""The port's per-level MSDA route against the JAX package's, on the CPU.

`MSDeformAttnLevelFunction` on CPU tensors runs the per-level plain
versions (`_sample_one_level`, `level_dv_plain`, `level_dgrid_plain`) that
`chip_smoke.py` holds the kernels `msda_level_{fwd,dv,dgrid}.cu` against.
The JAX side is `msda_pallas.ms_deform_attn_pallas` in TPU interpret mode
with its 8 MiB line lowered to 0, so its forward takes `_sample_kernel`
(the 40 x 30 level, HW 1200) and `_sample_kernel_onehot_pf` (the 8 x 6
level, HW 48) and its gradient `_grad_value_pallas` and `_grad_grid_pallas`.
fp32 to 1e-5 of each tensor's largest entry. bf16: the TPU kernels round Wy, tmp * Wx, the folded one-hot
rows and their per-level outputs to bf16 where the port keeps fp32
(`msda_pallas.py:135, :165, :208-212, :243, :1057-1059`); the differences
measured on these inputs stay under the tolerances stated below.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vitadapter.ops import msda as jmsda
from vitadapter.ops import msda_pallas
from vitadapter_torch.models.adapter import deform_inputs
from vitadapter_torch.ops import msda as tmsda

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((40, 30), (8, 6))
# bf16: relative to the largest magnitude of each reference tensor, about
# twice the largest difference seen over seeds 0-2 of `_inputs` (out 7.4e-3,
# d value 0, d loc 3.4e-3, d attn 1.6e-3); d value gets one bf16 ulp
BF16_TOL = {"out": 1.5e-2, "value": 2.0 ** -8, "loc": 7e-3, "attn": 4e-3}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make the small eager ops here many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B=1, Lq=50, M=2, D=32, P=4):
    rng = np.random.RandomState(seed)
    L = len(SHAPES)
    S = sum(h * w for h, w in SHAPES)
    value = rng.randn(B, S, M, D).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (B, Lq, M, L, P, 2))
    size = np.array([[w, h] for h, w in SHAPES], np.float64)[
        None, None, None, :, None, :]
    # integer pixel coordinates (loc * size - 0.5 integer) and points far
    # off the map
    snap = rng.rand(B, Lq, M, L, P, 1) < 0.15
    loc = np.where(snap, (np.floor(loc * size) + 0.5) / size, loc)
    far = rng.rand(B, Lq, M, L, P, 1) < 0.05
    loc = np.where(far, rng.uniform(-3.0, 4.0, loc.shape), loc)
    attn = rng.rand(B, Lq, M, L, P).astype(np.float32)
    g = rng.randn(B, Lq, M * D).astype(np.float32)
    return value, loc.astype(np.float32), attn, g


def _jax_level_path(monkeypatch, value, loc, attn, g, dtype):
    monkeypatch.setattr(msda_pallas, "ML_MAX_VALUE_BYTES", 0)

    def f(v, lc, a):
        return msda_pallas.ms_deform_attn_pallas(v, SHAPES, lc, a)

    args = (jnp.asarray(value, dtype), jnp.asarray(loc), jnp.asarray(attn))
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(f, *args)
        grads = vjp(jnp.asarray(g, dtype))
    return [np.asarray(jnp.asarray(t, jnp.float32)) for t in (out, *grads)]


def _port_level_path(value, loc, attn, g, dtype):
    ins = [torch.from_numpy(value).to(dtype).requires_grad_(),
           torch.from_numpy(loc).requires_grad_(),
           torch.from_numpy(attn).requires_grad_()]
    out = tmsda.MSDeformAttnLevelFunction.apply(ins[0], SHAPES, ins[1],
                                                ins[2])
    out.backward(torch.from_numpy(g).to(dtype))
    assert out.dtype == dtype and ins[0].grad.dtype == dtype
    return [t.detach().float().numpy()
            for t in (out, *(x.grad for x in ins))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_level_route_matches_jax_per_level_kernels(monkeypatch, dtype):
    value, loc, attn, g = _inputs(0)
    want = _jax_level_path(monkeypatch, value, loc, attn, g,
                           getattr(jnp, dtype))
    got = _port_level_path(value, loc, attn, g, getattr(torch, dtype))
    for name, x, w in zip(("out", "value", "loc", "attn"), got, want):
        assert x.shape == w.shape, name
        if dtype == "float32":
            # d loc carries attn * W and attn * H (entries up to ~600 here),
            # so each tensor is held to 1e-5 of its largest entry
            np.testing.assert_allclose(
                x, w, rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(w).max())),
                err_msg=name)
        else:
            err = float(np.abs(x - w).max())
            assert err <= BF16_TOL[name] * float(np.abs(w).max()), (name, err)


def test_level_route_equals_fused_plain_version():
    """On the CPU the per-level route and `ms_deform_attn_plain` (with its
    autograd) compute one function: output and all three gradients."""
    value, loc, attn, g = _inputs(1, B=2, Lq=30, M=3)
    got = _port_level_path(value, loc, attn, g, torch.float32)
    ins = [torch.from_numpy(a).requires_grad_() for a in (value, loc, attn)]
    out = tmsda.ms_deform_attn_plain(ins[0], SHAPES, ins[1], ins[2])
    out.backward(torch.from_numpy(g))
    want = [t.detach().numpy() for t in (out, *(x.grad for x in ins))]
    for x, w in zip(got, want):
        np.testing.assert_allclose(
            x, w, rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(w).max())))


# (image H, W, value dtype): the flagship's MSDA calls there. Injector and
# pixel decoder: levels at strides 8/16/32, D 32; extractors: the stride-16
# grid, D 32.
ROUTE_CASES = [
    ((512, 512), "bfloat16", "fused"),
    ((1024, 2048), "float32", "fused"),
    ((1536, 3072), "float32", "level"),
    ((1792, 1792), "float32", "level"),
    ((1760, 1760), "float32", "fused"),
]


@pytest.mark.parametrize("hw,dtype,want", ROUTE_CASES)
def test_route_follows_the_jax_rule(hw, dtype, want):
    assert tmsda.ML_MAX_VALUE_BYTES == msda_pallas.ML_MAX_VALUE_BYTES
    (_, pyramid), (_, grid16) = deform_inputs(*hw)
    tdt = getattr(torch, dtype)
    itemsize = jnp.dtype(dtype).itemsize
    for shapes in (pyramid, pyramid[::-1], grid16):
        S, D = sum(h * w for h, w in shapes), 32
        jax_fused = S * D * itemsize <= msda_pallas.ML_MAX_VALUE_BYTES
        route = tmsda.msda_route((1, S, 16, D), tdt)
        assert route == ("fused" if jax_fused else "level"), (shapes, route)
    # the multi-level calls take the expected route; the extractors' value
    # stays under the line at every size here
    assert tmsda.msda_route((1, sum(h * w for h, w in pyramid), 16, 32),
                            tdt) == want
    assert tmsda.msda_route((1, grid16[0][0] * grid16[0][1], 16, 32),
                            tdt) == "fused"


def test_wrapper_takes_the_level_function_for_large_values(monkeypatch):
    """Off the CPU a value over the line goes through
    `MSDeformAttnLevelFunction`, a smaller one through `MSDeformAttnFunction`
    (on the meta device, with the input checks stubbed)."""
    seen = []
    monkeypatch.setattr(tmsda, "check_kernel_inputs", lambda *a: None)
    for fn in ("MSDeformAttnFunction", "MSDeformAttnLevelFunction"):
        monkeypatch.setattr(getattr(tmsda, fn), "apply",
                            staticmethod(lambda *a, _n=fn: seen.append(_n)))
    meta = dict(device="meta")
    for S in (65536, 65537):      # 65536 rows x 32 x 4 bytes = 8 MiB
        tmsda.ms_deform_attn(torch.zeros(1, S, 2, 32, **meta), ((S, 1),),
                             torch.zeros(1, 3, 2, 1, 4, 2, **meta),
                             torch.zeros(1, 3, 2, 1, 4, **meta))
    assert seen == ["MSDeformAttnFunction", "MSDeformAttnLevelFunction"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("P", [4, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_level_plain_versions_match_jax_on_model_shaped_locations(dtype, P):
    """The plain versions that `chip_smoke.py` holds `msda_level_fwd.cu`
    and `msda_level_dgrid.cu` to (`_sample_one_level`, `level_dgrid_plain`)
    against the JAX package's XLA `_sample_one_level` and its `jax.vjp`, on
    the model-shaped locations of `chip_smoke.msda_model_locations`: one
    8 x 12 level, 24 queries on a 4 x 6 grid, 4 heads, D 8. fp32 sums in
    both, so 1e-5 of each tensor's largest entry in fp32 and with bf16
    values alike."""
    H, W, M, D, grid = 8, 12, 4, 8, (4, 6)
    Lq = grid[0] * grid[1]
    loc = _chip_smoke().msda_model_locations(
        ((H, W),), grid, M, P, torch.Generator().manual_seed(P),
        device="cpu")[:, :, :, 0]
    # the set holds integer pixel coordinates and points with corners off
    # the map
    px = loc * torch.tensor([W, H]) - 0.5
    assert bool((px == torch.floor(px)).any())
    assert bool(((px < 0) | (px > torch.tensor([W - 1, H - 1]))).any())
    rng = np.random.RandomState(P)
    tdt = getattr(torch, dtype)
    value = torch.from_numpy(rng.randn(1, H * W, M, D).astype(np.float32)
                             ).to(tdt)
    attn = torch.from_numpy(rng.rand(1, Lq, M, P).astype(np.float32))
    g = torch.from_numpy(rng.randn(1, Lq, M, D).astype(np.float32)).to(tdt)

    value_j = jnp.asarray(value.float().numpy(), getattr(jnp, dtype))
    out_j, vjp = jax.vjp(
        lambda lc, a: jmsda._sample_one_level(value_j, lc, a, H, W),
        jnp.asarray(loc.numpy()), jnp.asarray(attn.numpy()))
    want = [out_j, *vjp(jnp.asarray(g.float().numpy()))]
    got = [tmsda._sample_one_level(value, loc, attn, H, W),
           *tmsda.level_dgrid_plain(value, loc, attn, g, H, W)]
    for name, x, w in zip(("out", "loc", "attn"), got, want):
        w = np.asarray(w, np.float32)
        assert x.dtype == torch.float32 and x.shape == w.shape, name
        np.testing.assert_allclose(
            x.numpy(), w, rtol=1e-5,
            atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=name)
