"""The port's fused MSDA plain versions against the JAX package's fused
kernels, on model-shaped sampling locations, on the CPU.

`ms_deform_attn_plain` and `ms_deform_attn_plain_backward` are what
`chip_smoke.py` holds `csrc/msda_fwd.cu` and `csrc/msda_bwd.cu` to. Here they
run against `msda_pallas.ms_deform_attn_pallas` in TPU interpret mode
(forward, and `jax.vjp` for d value, d loc and d attn) on the locations of
`chip_smoke.msda_model_locations` with its query sets other than the
value's own cells: an injector-like case (a 4 x 6 query grid over a
three-level value pyramid) and an extractor-like one (the cells of a
three-level query pyramid over a one-level value), 4 heads, D 8, batch 2.

Tolerances are those of the fused tests in `test_torch_train_ops.py`
(`MSDA_TOLS`): rtol = atol = 1e-5 for the output, d value and d attn, and
1e-4 for d loc, whose entries carry the factors attn * W and attn * H.
bf16 values: the TPU kernel rounds its interpolation weights to a bf16
value's dtype, the port sums in fp32 and rounds once. So the JAX side takes
the same bf16 numbers as fp32, the port's fp32 sums (the plain version on
the value upcast) are held to it within the same tolerances, and the
port's bf16 output and d value must be exactly those sums rounded to bf16.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vitadapter.ops import msda_pallas
from vitadapter_torch.ops import msda as tmsda

ROOT = Path(__file__).resolve().parents[1]
PYRAMID = ((8, 12), (4, 6), (2, 3))
# name: (value levels, query grid as `msda_model_locations` takes it)
CASES = {"injector": (PYRAMID, (4, 6)), "extractor": (((4, 6),), PYRAMID)}
MSDA_TOLS = {"out": dict(rtol=1e-5, atol=1e-5),
             "value": dict(rtol=1e-5, atol=1e-5),
             "loc": dict(rtol=1e-4, atol=1e-4),
             "attn": dict(rtol=1e-5, atol=1e-5)}


def _model_locations(shapes, grid, M, P, seed):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.msda_model_locations(shapes, grid, M, P,
                                      torch.Generator().manual_seed(seed),
                                      device="cpu", B=2)


@functools.lru_cache(maxsize=None)
def _pallas_with_vjp(shapes):
    """The JAX fused kernels' output and gradients for an output gradient,
    jitted once per case (the bf16 case feeds the same fp32 shapes)."""
    def run(v, lc, a, g):
        out, vjp = jax.vjp(
            lambda *t: msda_pallas.ms_deform_attn_pallas(t[0], shapes,
                                                         t[1], t[2]),
            v, lc, a)
        return (out, *vjp(g.reshape(out.shape)))
    return jax.jit(run)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_plain_versions_match_pallas_on_model_shaped_locations(
        case, dtype):
    shapes, grid = CASES[case]
    M, D, P = 4, 8, 4
    loc = _model_locations(shapes, grid, M, P, seed=len(case))
    B, Lq = loc.shape[:2]
    assert Lq == (grid[0] * grid[1] if isinstance(grid[0], int)
                  else sum(h * w for h, w in grid))
    # integer pixel coordinates and points with corners off the map
    size = torch.tensor([[w, h] for h, w in shapes])[:, None, :]
    px = loc * size - 0.5
    assert bool((px == torch.floor(px)).any())
    assert bool(((px < 0) | (px > size - 1)).any())
    rng = np.random.RandomState(len(case))
    S = sum(h * w for h, w in shapes)
    tdt = getattr(torch, dtype)
    value = torch.from_numpy(rng.randn(B, S, M, D).astype(np.float32)).to(tdt)
    attn = torch.from_numpy(
        rng.rand(B, Lq, M, len(shapes), P).astype(np.float32))
    g = torch.from_numpy(rng.randn(B, Lq, M * D).astype(np.float32)).to(tdt)

    with pltpu.force_tpu_interpret_mode():
        want = _pallas_with_vjp(shapes)(
            *(jnp.asarray(t.float().numpy()) for t in (value, loc, attn, g)))

    # the port's fp32 sums of the same numbers
    sums = [tmsda.ms_deform_attn_plain(value.float(), shapes, loc, attn),
            *tmsda.ms_deform_attn_plain_backward(value.float(), shapes, loc,
                                                 attn, g.float())]
    for name, x, w in zip(("out", "value", "loc", "attn"), sums, want):
        w = np.asarray(w, np.float32)
        assert x.dtype == torch.float32 and x.shape == w.shape, name
        np.testing.assert_allclose(x.numpy(), w, **MSDA_TOLS[name],
                                   err_msg=name)
    # in the value's dtype: the sums rounded once
    got = [tmsda.ms_deform_attn_plain(value, shapes, loc, attn),
           *tmsda.ms_deform_attn_plain_backward(value, shapes, loc, attn, g)]
    for name, x, s in zip(("out", "value", "loc", "attn"), got, sums):
        want_dtype = tdt if name in ("out", "value") else torch.float32
        assert x.dtype == want_dtype, name
        assert torch.equal(x, s.to(want_dtype)), name
