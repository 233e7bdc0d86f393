"""The point sampling forward in the shared form (`ops.point_sample`:
masks (N, H, W) at points (N / S, P, 2), the S consecutive masks of a group
at one point set) and the launch plan of `csrc/point_sample_fwd.cu`
(`fwd_plan`), on the CPU.

The plain version is held against the JAX package's `point_sample_pallas`
in TPU interpret mode and its XLA path, on the sets repeated to one a
mask, at S = 1 and 3, on points sorted by y and not, some off the map and
some NaN (fp32, 1e-5). The kernels' rule for a CTA (the tile kernel: the rows
between the tile's first and last corner row staged in shared memory when
they fit the buffer, else every corner gathered from the mask; the
streaming and gather kernels: a run of the call's points, mask by mask,
from whole maps staged or from the masks) is emulated in plain torch, CTA
by CTA, at plans that take each path, with every corner row asserted
inside the staged band, and held against `point_sample_plain` bitwise.
The plan is swept over the paths' shapes and held to the kernels' limits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vitadapter.ops import point_sample as jps
from vitadapter.ops.point_sample_pallas import point_sample_pallas
from vitadapter_torch.ops import point_sample as tps

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make the small eager ops here many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sets(seed, sets, P, H, W, sort, nan=True):
    """Point sets (sets, P, 2) in [-0.1, 1.1), a few far off the map, a few
    on pixel centres and, with `nan`, a few NaN coordinates; sorted by y
    as the loss sorts them, or not."""
    rng = np.random.RandomState(seed)
    pts = rng.rand(sets, P, 2) * 1.2 - 0.1
    far = rng.rand(sets, P, 1) < 0.05
    pts = np.where(far, rng.uniform(-2.0, 3.0, pts.shape), pts)
    size = np.array([W, H], np.float64)
    centre = rng.rand(sets, P, 1) < 0.05
    pts = np.where(centre, (np.floor(np.clip(pts, 0, 1) * size) + 0.5) / size,
                   pts)
    if nan:
        pts[rng.rand(sets, P) < 0.02, rng.randint(0, 2)] = np.nan
    pts = torch.from_numpy(pts.astype(np.float32))
    return tps.sort_points_by_y(pts) if sort else pts


@pytest.mark.parametrize("S,sort", [(1, True), (1, False), (3, True),
                                    (3, False)])
def test_shared_form_matches_jax_pallas_and_xla(S, sort):
    """JAX takes a point set a mask: the sets repeated S times. A NaN point
    gives 0 in the port (`point_sample_plain`'s contract) and NaN there
    (0 where its other coordinate is off the map); every other point
    agrees."""
    N, H, W, P = 6, 9, 11, 300
    masks = torch.from_numpy(
        np.random.RandomState(40 + S).randn(N, H, W).astype(np.float32))
    sets = _sets(41 + S, N // S, P, H, W, sort)
    got = tps.point_sample_plain(masks, sets).numpy()
    expanded = sets.repeat_interleave(S, 0)
    assert np.array_equal(got, tps.point_sample_plain(masks, expanded).numpy())
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(point_sample_pallas(jnp.asarray(masks.numpy()),
                                             jnp.asarray(expanded.numpy())))
    xla = np.asarray(jps.point_sample(jnp.asarray(masks.numpy()),
                                      jnp.asarray(expanded.numpy())))
    nan = torch.isnan(expanded).any(-1).numpy()
    assert nan.any() and (~nan).any()
    for want in (pal, xla):
        assert (np.isnan(want[nan]) | (want[nan] == 0)).all()
        np.testing.assert_allclose(got[~nan], want[~nan], **TOL)
    assert (got[nan] == 0).all()


def test_shared_form_gradient_is_the_expanded_ones():
    """On the CPU autograd differentiates the plain version: d masks of the
    shared form equal those of the sets repeated to one a mask."""
    masks = torch.randn(6, 7, 5, generator=torch.Generator().manual_seed(3))
    sets = _sets(44, 2, 80, 7, 5, True, nan=False)
    g = torch.randn(6, 80, generator=torch.Generator().manual_seed(4))
    grads = []
    for pts in (sets, sets.repeat_interleave(3, 0)):
        m = masks.clone().requires_grad_()
        tps.point_sample(m, pts).backward(g)
        grads.append(m.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="whole number"):
        tps.point_sample_plain(masks, sets[:1].repeat(4, 1, 1))


def _band(pts, H, W):
    """The kernel's band of a tile: the first and last row of its points'
    in-map corners, (None, None) when it has none."""
    x = pts[:, 0] * W - 0.5
    y = pts[:, 1] * H - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    on = (x0 >= -1) & (x0 <= W - 1) & (y0 >= -1) & (y0 <= H - 1)
    if not on.any():
        return None, None
    rows = y0[on].long()
    return int(rows.clamp(min=0).min()), int((rows + 1).clamp(max=H - 1).max())


def _emulate(masks, sets, plan):
    """point_sample_fwd.cu CTA by CTA in plain torch: -> (N, P), and the
    number of tiles that took each path."""
    N, H, W = masks.shape
    S = tps.masks_per_set(masks, sets)
    P = sets.shape[1]
    es = masks.element_size()
    out = torch.full((N, P), float("nan"))
    paths = dict(stream=0, staged=0, gather=0)
    if plan.kernel != tps.FWD_TILES:
        assert plan.group == plan.groups == 1
        # CTA b takes points [b * tile, (b + 1) * tile) of the call's N * P,
        # mask by mask
        for b in range(plan.tiles):
            b0, b1 = b * plan.tile, min((b + 1) * plan.tile, N * P)
            assert b0 < b1
            while b0 < b1:
                m, p0 = divmod(b0, P)
                np_ = min(b1 - b0, P - p0)
                out[m, p0:p0 + np_] = tps.point_sample_plain(
                    masks[m:m + 1], sets[m // S, p0:p0 + np_][None])[0]
                paths["stream"] += 1
                b0 += np_
        return out, paths
    for s in range(N // S):
        for gi in range(plan.groups):
            ms = range(s * S + gi * plan.group,
                       min(s * S + (gi + 1) * plan.group, (s + 1) * S))
            for ti in range(plan.tiles):
                p0 = ti * plan.tile
                pts = sets[s, p0:min(p0 + plan.tile, P)]
                assert len(pts) and len(ms)
                assert len(pts) <= tps.FWD_CHUNK
                lo, hi = _band(pts, H, W)
                if lo is None or (hi - lo + 1) * W * es + 15 > plan.buf_bytes:
                    paths["gather"] += 1
                    for m in ms:
                        out[m, p0:p0 + len(pts)] = tps.point_sample_plain(
                            masks[m:m + 1], pts[None])[0]
                    continue
                paths["staged"] += 1
                # the corners gathered from the band alone, at offsets
                # shifted by its first row as the kernel shifts them
                band = masks[list(ms), lo:hi + 1].reshape(len(ms), -1)
                acc = torch.zeros(len(ms), len(pts))
                for idx, valid, w in tps._corners(pts, H, W):
                    rows = idx[valid] // W
                    assert ((rows >= lo) & (rows <= hi)).all()
                    g = band[:, torch.where(valid, idx - lo * W, 0)]
                    acc = acc + torch.where(valid, w * g.float(), 0.0)
                out[list(ms), p0:p0 + len(pts)] = acc
    return out, paths


@pytest.mark.parametrize("case", ["stream_whole", "stream_gather",
                                  "staged_bands", "shared_bands",
                                  "bands_too_small", "grouped_gather",
                                  "single_set_bands"])
def test_kernel_tile_rule_emulated_against_the_plain_version(case):
    """Plans at tiny shapes that take each of the kernels' paths: the
    emulation writes every output once and equals `point_sample_plain`
    bitwise; a staged tile's corners all lie in its band."""
    H, W, P = 40, 24, 700
    N, S, sort = {"stream_whole": (3, 1, False), "stream_gather": (3, 1, True),
                  "staged_bands": (4, 2, True), "shared_bands": (6, 3, True),
                  "bands_too_small": (4, 2, False),
                  "grouped_gather": (6, 3, False),
                  "single_set_bands": (3, 1, True)}[case]
    masks = torch.randn(N, H, W, generator=torch.Generator().manual_seed(5))
    sets = _sets(45, N // S, P, H, W, sort)
    whole = tps.whole_map_bytes(H, W, 4)
    T = tps.FWD_TILES
    plan = {"stream_whole": tps.FwdPlan(tps.FWD_STREAM, 500, 5, 1, 1, whole,
                                        1),
            "stream_gather": tps.gather_plan(N, P),
            "staged_bands": tps.FwdPlan(T, 64, 11, 2, 1, 16 * W * 4 + 16, 2),
            "shared_bands": tps.FwdPlan(T, 100, 7, 2, 2, 12 * W * 4 + 16, 2),
            "bands_too_small": tps.FwdPlan(T, 128, 6, 2, 1, 8 * W * 4 + 16,
                                           2),
            "grouped_gather": tps.FwdPlan(T, 256, 3, 3, 1, 0, 1),
            "single_set_bands": tps.FwdPlan(T, 64, 11, 1, 1, 16 * W * 4 + 16,
                                            1),
            }[case]
    out, paths = _emulate(masks, sets, plan)
    assert not torch.isnan(out).any()
    assert torch.equal(out, tps.point_sample_plain(masks, sets))
    if case.startswith("stream"):
        assert paths["stream"] > plan.tiles   # CTAs that span two masks
    elif case in ("bands_too_small", "grouped_gather"):
        assert paths["gather"] and not paths["staged"]
    else:
        assert paths["staged"] and not paths["stream"]


# (masks N, H, W, points, masks a set): the loss's calls on the flagship,
# the 640 px config and the panoptic step, the over-line step and edges
PLAN_SHAPES = [
    (4000, 128, 128, 12544, 200), (120, 512, 512, 125440, 60),
    (400, 128, 128, 37632, 1), (400, 128, 128, 12544, 1),
    (400, 512, 512, 12544, 1), (1000, 160, 160, 12544, 100),
    (60, 640, 640, 125440, 60), (100, 640, 640, 12544, 1),
    (2000, 256, 256, 12544, 200), (60, 1024, 1024, 125440, 60),
    (200, 256, 256, 37632, 1), (200, 1024, 1024, 12544, 1),
    (200, 448, 448, 12544, 1), (1, 128, 128, 12544, 1), (16, 128, 128, 0, 4),
    (8, 1, 1, 500, 2), (64, 300, 1, 2000, 1), (64, 127, 127, 4000, 8),
    (2, 4, 60000, 1000, 1), (3, 2, 30000, 999, 3),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_fwd_plan_stays_within_the_kernels_limits(shape):
    """Every point and mask has one CTA; a CTA of the tile kernel holds at
    most FWD_CHUNK points; the buffers fit a CTA's shared memory in
    16-byte units; the streaming kernel stages whole maps, sorted points
    only where an SM holds FWD_SORTED_STREAM_CTAS of its CTAs; shared sets
    keep their geometry for groups of masks unless a group would hold one
    mask."""
    N, H, W, P, S = shape
    sms = 132                          # an H100's
    for es in (2, 4):
        whole = tps.whole_map_bytes(H, W, es)
        for sort in (False, True):
            p = tps.fwd_plan(N, S, H, W, P, es, sms, sort)
            assert p.tile >= 1 and p.tiles >= 1 and p.group >= 1
            tiled = p.kernel == tps.FWD_TILES
            span = max(P if tiled else N * P, 1)
            assert p.tile * p.tiles >= span > p.tile * (p.tiles - 1)
            masks_of = S if tiled else 1
            assert p.group * p.groups >= masks_of > p.group * (p.groups - 1)
            assert p.stages in (1, 2) and (p.stages == 1 or p.group > 1
                                           or not tiled)
            assert p.buf_bytes % 16 == 0 and p.buf_bytes >= 0
            assert p.stages * p.buf_bytes <= tps.FWD_MAX_SMEM
            if tiled:
                assert S > 1 and p.group > 1 and p.tile <= tps.FWD_CHUNK
            elif p.kernel == tps.FWD_STREAM:
                assert p.buf_bytes == whole
                assert p.tiles <= sms * tps.FWD_STAGE_CTAS_PER_SM
            else:
                assert p.kernel == tps.FWD_GATHER and not p.buf_bytes
                assert p == tps.gather_plan(N, P)
            if S == 1:
                # two buffers and a KB a CTA
                per_sm = tps.FWD_SM_SMEM // (2 * whole + 1024)
                assert (p.kernel == tps.FWD_STREAM) == (
                    whole <= tps.FWD_MAX_SMEM and (
                        not sort or per_sm >= tps.FWD_SORTED_STREAM_CTAS))
