"""The launch plan of the point sampling backward kernel
(`ops.point_sample.bwd_plan`, `csrc/point_sample_bwd.cu`) and the
band-owned accumulation it sets up, on the CPU.

The kernel gives each mask one thread-block cluster per row group; each
CTA of a cluster owns a band of rows of the mask's fp32 accumulator in its
shared memory, the cluster's CTAs split the mask's points, and every
in-map corner is added into the band that owns its row. Here the plan is
swept over map sizes (every row exactly one owner, a CTA's shared memory
and the cluster size within their limits), and the accumulation is
emulated in plain torch, band by band, and held against
`point_sample_plain_backward` and, through it, against `jax.vjp` of the
Pallas kernel in TPU interpret mode (fp32, unsorted points, some off the
map).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vitadapter.ops.point_sample_pallas import point_sample_pallas
from vitadapter_torch.ops import point_sample as tps

SIDES = (1, 2, 3, 7, 16, 31, 64, 100, 127, 128, 130, 255, 448, 512, 1000,
         1023, 1024)
TOL = dict(rtol=1e-6, atol=1e-6)


def _ceil_div(a, b):
    return -(-a // b)


@pytest.mark.parametrize("H", SIDES)
def test_bwd_plan_gives_every_row_one_owner_within_the_limits(H):
    for W in SIDES:
        plan = tps.bwd_plan(H, W)
        assert 1 <= plan.cluster <= tps.BWD_MAX_CLUSTER
        assert plan.rows >= 1
        assert plan.smem_bytes == 4 * plan.rows * W
        assert plan.smem_bytes <= tps.BWD_MAX_CTA_BYTES
        # the kernel's entry point derives the groups the same way
        assert plan.groups == _ceil_div(H, plan.cluster * plan.rows)
        owners = np.zeros(plan.groups * plan.cluster * plan.rows, int)
        for grp in range(plan.groups):
            for rank in range(plan.cluster):
                r0 = (grp * plan.cluster + rank) * plan.rows
                owners[r0:r0 + plan.rows] += 1
        assert (owners[:H] == 1).all(), (H, W, plan)
        # bands past the last row are no more than the last group's
        assert (plan.groups - 1) * plan.cluster * plan.rows < H


def test_bwd_plan_at_the_paths_shapes():
    # the flagship's loss (128x128): clusters of 2 CTAs of 32 KB
    assert tps.bwd_plan(128, 128) == (2, 64, 1, 32768)
    # the over-line step's (448x448): 8 CTAs of 98 KB
    assert tps.bwd_plan(448, 448) == (8, 56, 1, 100352)
    # more than a cluster holds: row groups, rows spread evenly
    assert tps.bwd_plan(1024, 1024) == (8, 43, 3, 176128)
    with pytest.raises(ValueError):
        tps.bwd_plan(4, tps.BWD_MAX_CTA_BYTES // 4 + 1)


def band_backward(masks, points, g, plan):
    """d masks by the kernel's scheme: per row group, the cluster's CTAs
    take contiguous shares of each mask's points, and every in-map corner
    in the group's rows is scattered into the fp32 band of the CTA that
    owns its row; the bands, concatenated in row order, are rounded once
    to the mask dtype."""
    N, H, W = masks.shape
    P = points.shape[1]
    g = g.float()
    out = []
    for grp in range(plan.groups):
        g0 = grp * plan.cluster * plan.rows
        g1 = min(H, g0 + plan.cluster * plan.rows)
        bands = [torch.zeros(N, plan.rows * W) for _ in range(plan.cluster)]
        for rank in range(plan.cluster):
            lo, hi = P * rank // plan.cluster, P * (rank + 1) // plan.cluster
            for idx, valid, w in tps._corners(points[:, lo:hi], H, W):
                row = idx // W
                keep = valid & (row >= g0) & (row < g1)
                owner = torch.where(keep, (row - g0) // plan.rows, -1)
                local = (row - g0 - owner * plan.rows) * W + idx % W
                for r, band in enumerate(bands):
                    mine = keep & (owner == r)
                    band.scatter_add_(1, torch.where(mine, local, 0),
                                      torch.where(mine, w * g[:, lo:hi], 0.0))
        for r, band in enumerate(bands):
            r0 = g0 + r * plan.rows
            rows = max(0, min(plan.rows, H - r0))
            out.append(band[:, :rows * W].reshape(N, rows, W))
    return torch.cat(out, dim=1).to(masks.dtype)


def _inputs(seed, N, H, W, P):
    """Masks, unsorted points (a fifth off the map or far off it) and an
    output gradient."""
    rng = np.random.RandomState(seed)
    masks = rng.randn(N, H, W).astype(np.float32)
    pts = rng.rand(N, P, 2) * 1.2 - 0.1
    far = rng.rand(N, P, 1) < 0.05
    pts = np.where(far, rng.uniform(-2.0, 3.0, pts.shape), pts)
    g = rng.randn(N, P).astype(np.float32)
    return masks, pts.astype(np.float32), g


# (H, W, plan): the plans of the paths' shapes and of a map larger than a
# cluster holds, and hand-made ones with ragged and empty bands
BAND_CASES = {
    "flagship_128": (128, 128, tps.bwd_plan(128, 128)),
    "overline_448": (448, 448, tps.bwd_plan(448, 448)),
    "row_groups_1024": (1024, 1024, tps.bwd_plan(1024, 1024)),
    "ragged_3x5_rows_2_groups": (24, 40, tps.BwdPlan(3, 5, 2, 800)),
    "one_row_a_cta": (7, 40, tps.BwdPlan(8, 1, 1, 160)),
    "one_row": (1, 40, tps.bwd_plan(1, 40)),
    "one_column": (24, 1, tps.BwdPlan(2, 12, 1, 48)),
}
# the cases also held against the Pallas kernel (small enough for its
# interpret mode)
PALLAS_CASES = ("flagship_128", "ragged_3x5_rows_2_groups")


@pytest.mark.parametrize("case", sorted(BAND_CASES))
def test_band_owned_accumulation_matches_plain_and_pallas(case):
    H, W, plan = BAND_CASES[case]
    masks, pts, g = _inputs(31, 2, H, W, 300)
    mt, pt, gt = (torch.from_numpy(a) for a in (masks, pts, g))
    got = band_backward(mt, pt, gt, plan)
    plain = tps.point_sample_plain_backward(mt, pt, gt)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    if case in PALLAS_CASES:
        with pltpu.force_tpu_interpret_mode():
            _, vjp = jax.vjp(point_sample_pallas, jnp.asarray(masks),
                             jnp.asarray(pts))
            dm, _ = vjp(jnp.asarray(g))
        np.testing.assert_allclose(plain.numpy(), np.asarray(dm), **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(dm), **TOL)


def test_nan_points_add_nothing():
    """A point with a NaN coordinate adds nothing, in the plain version and
    in the band-owned accumulation: as if its gradient were 0."""
    masks, pts, g = _inputs(32, 2, 24, 40, 300)
    pts[0, :40, 0] = np.nan
    pts[1, 10:30, 1] = np.nan
    mt, pt, gt = (torch.from_numpy(a) for a in (masks, pts, g))
    nan = torch.isnan(pt).any(-1)
    want = tps.point_sample_plain_backward(
        mt, torch.nan_to_num(pt), torch.where(nan, 0.0, gt))
    plain = tps.point_sample_plain_backward(mt, pt, gt)
    assert torch.isfinite(plain).all()
    np.testing.assert_allclose(plain.numpy(), want.numpy(), **TOL)
    got = band_backward(mt, pt, gt, tps.BwdPlan(3, 5, 2, 800))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
