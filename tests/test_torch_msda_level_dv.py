"""`level_dv_plain` against the JAX package, on the CPU.

`level_dv_plain` is the plain version `chip_smoke.py` holds the kernel
`msda_level_dv.cu` against. The JAX side is the `jax.vjp` of
`vitadapter.ops.msda._sample_one_level` with respect to the value. One
8 x 12 level, 24 queries on a 4 x 6 grid, 4 heads, D 8, P 4, on three sets
of locations: shaped as the model makes them
(`chip_smoke.msda_model_locations`), every point inside one cell (every
corner's adds on four rows a head), and points whose corners fall off the
map (partly or wholly, far off, on integer pixels). g is fp32 or holds
bf16 values; both sides sum in fp32, so each result is held to 1e-5 of its
largest entry.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitadapter.ops import msda as jmsda
from vitadapter_torch.ops import msda as tmsda

ROOT = Path(__file__).resolve().parents[1]
H, W, M, D, P, GRID = 8, 12, 4, 8, 4, (4, 6)
LQ = GRID[0] * GRID[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _locations(kind, rng):
    """(1, LQ, M, P, 2) fp32 sampling locations of one set."""
    shape = (1, LQ, M, P)
    size = np.array([W, H], np.float64)
    if kind == "model_shaped":
        loc = _chip_smoke().msda_model_locations(
            ((H, W),), GRID, M, P, torch.Generator().manual_seed(0),
            device="cpu")[:, :, :, 0].numpy()
    elif kind == "one_cell":
        # pixel coordinates in (5, 6) x (3, 4): top-left corner (5, 3)
        px = np.array([5.0, 3.0]) + rng.uniform(0.0, 1.0, shape + (2,))
        loc = (px + 0.5) / size
    else:
        loc = rng.uniform(-0.3, 1.3, shape + (2,))
        # integer pixel coordinates (corners on the map's edges too) and
        # points far off the map
        snap = rng.rand(*shape, 1) < 0.2
        loc = np.where(snap, (np.floor(loc * size) + 0.5) / size, loc)
        far = rng.rand(*shape, 1) < 0.1
        loc = np.where(far, rng.uniform(-3.0, 4.0, loc.shape), loc)
    return torch.from_numpy(np.ascontiguousarray(loc, np.float32))


@pytest.mark.parametrize("kind", ["model_shaped", "one_cell", "off_map"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_level_dv_plain_matches_jax_vjp(dtype, kind):
    rng = np.random.RandomState(7)
    loc = _locations(kind, rng)
    px = loc.numpy() * np.array([W, H]) - 0.5
    corner_off = (px < 0) | (px > np.array([W - 1, H - 1]))
    if kind == "off_map":
        # points with some and with all corners off the map
        assert corner_off.any() and (np.floor(px) < -1).any()
    else:
        assert kind == "model_shaped" or not corner_off.any()
    attn = torch.from_numpy(rng.rand(1, LQ, M, P).astype(np.float32))
    g = torch.from_numpy(rng.randn(1, LQ, M, D).astype(np.float32)).to(
        getattr(torch, dtype))

    value0 = jnp.zeros((1, H * W, M, D), jnp.float32)
    _, vjp = jax.vjp(
        lambda v: jmsda._sample_one_level(v, jnp.asarray(loc.numpy()),
                                          jnp.asarray(attn.numpy()), H, W),
        value0)
    (want,) = vjp(jnp.asarray(g.float().numpy()))
    want = np.asarray(want)
    got = tmsda.level_dv_plain(loc, attn, g, H, W)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
