"""The port's detection primitives (`vitadapter_torch/det/{boxes,anchors,
assign,roi_align}.py`, `ops/nms.py`) and windowed attention
(`layers/attention.py`) against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both sides. NMS, the anchors, the
assigner, the sampler's picks and the mask crops are held equal (kept
indices exactly, JAX's `argsort` and `top_k` order on ties); continuous
outputs within 2e-4 of each one's scale (fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitadapter.det import anchors as janchors
from vitadapter.det import assign as jassign
from vitadapter.det import boxes as jboxes
from vitadapter.det import roi_align as jroi
from vitadapter.layers import attention as jattn
from vitadapter_torch.det import anchors as tanchors
from vitadapter_torch.det import assign as tassign
from vitadapter_torch.det import boxes as tboxes
from vitadapter_torch.det import roi_align as troi
from vitadapter_torch.layers import attention as tattn
from vitadapter_torch.ops import nms as tnms
from vitadapter_torch.utils.init import init_weights
from vitadapter_torch.utils.weights import _linear, _prefixed

from torch_port_util import to_np

TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores (see test_torch_upernet)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(got, want, tol=TOL, msg=""):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (msg, err, scale)


def clustered_boxes(rs, n, size=200.0, spread=6.0, clusters=None):
    """n xyxy boxes around a few centers, so that many pairs overlap near
    any threshold."""
    clusters = clusters or max(n // 12, 1)
    c = rs.rand(clusters, 2) * size
    pts = c[rs.randint(0, clusters, n)] + spread * rs.randn(n, 2)
    wh = 8 + rs.rand(n, 2) * size / 4
    return np.concatenate([pts - wh / 2, pts + wh / 2], 1).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------- windows


@pytest.mark.parametrize("shape,ws", [((2, 6, 9, 5), 3), ((1, 8, 4, 3), 4)])
def test_window_partition_and_reverse_match_jax(shape, ws):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    got = tattn.window_partition(t(x), ws)
    np.testing.assert_array_equal(
        to_np(got), np.asarray(jattn.window_partition(jnp.asarray(x), ws)))
    back = tattn.window_reverse(got, ws, shape[1], shape[2])
    np.testing.assert_array_equal(to_np(back), x)


@pytest.mark.parametrize("hw,ws", [((4, 6), 3), ((6, 6), 3), ((5, 7), 4),
                                   ((3, 3), 14)])
def test_windowed_attention_matches_jax(hw, ws):
    """Zero-padded qkv (bias included) to a window multiple, padded keys in
    the softmax: with padding ((4, 6), (5, 7) and one window larger than
    the grid) and without ((6, 6))."""
    H, W = hw
    dim, heads = 24, 4
    x = np.random.RandomState(2).randn(2, H * W, dim).astype(np.float32)
    jm = jattn.WindowedAttention(num_heads=heads, qkv_bias=True,
                                 window_size=ws)
    v = jax.jit(jm.init, static_argnums=(2, 3))(jax.random.PRNGKey(0), x,
                                                H, W)
    rs = np.random.RandomState(3)
    p = jax.tree_util.tree_map(
        lambda a: (0.3 * rs.randn(*a.shape)).astype(np.float32), v["params"])
    port = tattn.WindowedAttention(dim, heads, qkv_bias=True, window_size=ws,
                                   device="meta")
    port = init_weights(port.to_empty(device="cpu"),
                        torch.Generator().manual_seed(0))
    port.load_state_dict({**_prefixed("qkv", _linear(p["qkv"])),
                          **_prefixed("proj", _linear(p["proj"]))})
    with torch.no_grad():
        got = port(t(x), H, W)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jm.apply, static_argnums=(2, 3))({"params": p}, x,
                                                       H, W)
    assert_close(got, want)


# ----------------------------------------------------------------- boxes


def test_box_ops_match_jax():
    """IoU, deltas with both target stds, and the decode with its
    wh-ratio clamp (large deltas) and clipping."""
    rs = np.random.RandomState(4)
    a, b = clustered_boxes(rs, 40), clustered_boxes(rs, 30)
    assert_close(tboxes.bbox_overlaps(t(a), t(b)),
                 jax.jit(jboxes.bbox_overlaps)(a, b))
    np.testing.assert_array_equal(to_np(tnms.bbox_area(t(a))),
                                  np.asarray(jboxes.bbox_area(a)))
    for stds in (tboxes.RPN_STDS, tboxes.RCNN_STDS):
        assert_close(tboxes.bbox2delta(t(a), t(a[::-1].copy()), stds),
                     jax.jit(jboxes.bbox2delta, static_argnums=2)(
                         a, a[::-1].copy(), stds))
    d = (rs.randn(40, 4) * 3).astype(np.float32)
    for max_shape in (None, (150, 180)):
        assert_close(tboxes.delta2bbox(t(a), t(d), tboxes.RCNN_STDS,
                                       max_shape),
                     jax.jit(jboxes.delta2bbox, static_argnums=(2, 3))(
                         a, d, jboxes.RCNN_STDS, max_shape))


def test_stable_top_k_keeps_jax_order_on_ties():
    x = np.array([1.0, 3.0, 3.0, -np.inf, 2.0, 3.0, -np.inf, 1.0],
                 np.float32)
    s, i = tboxes.stable_top_k(t(x), 6)
    js, ji = jax.lax.top_k(x, 6)
    np.testing.assert_array_equal(to_np(s), np.asarray(js))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


NMS_CASES = {
    # name: (boxes, IoU threshold, with valid flags, score threshold, ties)
    "proposals": (300, 0.7, True, -np.inf, False),
    "detections": (200, 0.5, False, 0.05, False),
    "tied_scores": (150, 0.6, True, -np.inf, True),
}


def _nms_inputs(case, seed):
    n, thr, with_valid, score_thr, ties = NMS_CASES[case]
    rs = np.random.RandomState(seed)
    boxes = clustered_boxes(rs, n)
    scores = rs.rand(n).astype(np.float32)
    if ties:
        scores = np.round(scores * 8) / 8       # many equal scores
    scores[rs.rand(n) < 0.05] = -np.inf
    valid = rs.rand(n) > 0.1 if with_valid else None
    return boxes, scores, valid, thr, score_thr


@pytest.mark.parametrize("case", list(NMS_CASES))
def test_nms_keeps_exactly_jax_indices(case):
    boxes, scores, valid, thr, score_thr = _nms_inputs(case, 5)
    got = tboxes.nms(t(boxes), t(scores), thr, 120,
                     None if valid is None else t(valid), score_thr)
    want = jax.jit(jboxes.nms, static_argnums=(2, 3, 5))(
        boxes, scores, thr, 120, valid, score_thr)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert (got[2] >= 0).sum() > 10
    np.testing.assert_array_equal(to_np(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(to_np(got[1]), np.asarray(want[1]))


def test_batched_nms_keeps_exactly_jax_indices():
    boxes, scores, valid, thr, _ = _nms_inputs("proposals", 6)
    labels = np.random.RandomState(7).randint(0, 5, len(boxes)).astype(
        np.int32)
    got = tboxes.batched_nms(t(boxes), t(scores), t(labels), 0.5, 150,
                             t(valid))
    want = jax.jit(jboxes.batched_nms, static_argnums=(3, 4))(
        boxes, scores, labels, 0.5, 150, valid)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w, np.float32))


def test_nms_keep_plain_is_the_greedy_walk():
    """`nms_keep` on CPU tensors takes the plain version; its kept flags
    are those of the greedy definition written out pair by pair."""
    rs = np.random.RandomState(8)
    boxes = t(clustered_boxes(rs, 80))
    finite = t(rs.rand(80) > 0.1)
    keep = tnms.nms_keep(boxes, finite, 0.6)
    iou = tnms.bbox_overlaps(boxes, boxes).numpy()
    want = []
    for i in range(80):
        if finite[i] and not any(iou[j, i] > 0.6 for j in want):
            want.append(i)
    assert torch.nonzero(keep)[:, 0].tolist() == want


def _walk_emulation(boxes, finite, thr, chunk=None):
    """`csrc/nms.cu` in Python ints: `nms_mask`'s bit matrix (row i holds
    the words from its own tile on, rows `pitch` words apart, a bit for
    each later box it overlaps), the removed bits of non-finite boxes set
    first, then chunk by chunk of a tile's rows (`walk_plan`'s chunks, or
    `chunk` words), each staged from its even word on with zeros past the
    last box and the pitch: on the tile's first chunk the 64-step chain on
    its diagonal words, then the kept rows ORed into the chunk's later
    words."""
    n = len(boxes)
    words, pitch, plan_chunk, _ = tnms.walk_plan(n)
    chunk = chunk or plan_chunk
    full = (1 << 64) - 1
    over = (tnms.bbox_overlaps(boxes, boxes) > thr).numpy()
    mask = [[0] * pitch for _ in range(n)]
    for i in range(n):
        for c in range(i // 64, words):
            mask[i][c] = sum(1 << (j - 64 * c)
                             for j in range(64 * c, min(64 * c + 64, n))
                             if j > i and over[i, j])
    live = finite.numpy()
    removed = [full & ~sum(1 << k for k in range(64)
                           if 64 * w + k < n and live[64 * w + k])
               for w in range(words)]
    keep = np.zeros(n, bool)
    stride = (chunk + 3) & ~1
    g, w0, kb = 0, 0, 0
    while words:
        nw = min(chunk, words - w0)
        i0, a = 64 * g, w0 & ~1
        rows = [[(mask[i0 + r][a + q] if i0 + r < n and a + q < pitch else 0)
                 for q in range(w0 & 1, stride)] for r in range(64)]
        first = w0 == g
        if first:
            rem = removed[g]
            for k in range(64):
                if not (rem >> k) & 1:
                    rem |= rows[k][0]
            kb = ~rem & ((1 << min(64, n - i0)) - 1)
            keep[i0:i0 + 64] = [(kb >> t) & 1 for t in range(min(64, n - i0))]
        for w in range(1 if first else 0, nw):
            for r in range(64):
                if (kb >> r) & 1:
                    removed[w0 + w] |= rows[r][w]
        if w0 + chunk < words:
            w0 += chunk
        elif g + 1 < words:
            g, w0 = g + 1, g + 1
        else:
            break
    return keep


def _walk_boxes(kind, n, seed):
    rs = np.random.RandomState(seed)
    if kind == "same":
        boxes = np.tile(np.float32([[10, 20, 110, 90]]), (n, 1))
    elif kind == "disjoint":
        i = np.arange(n, dtype=np.float32)
        x, y = (i % 20) * 50, (i // 20) * 50
        boxes = np.stack([x, y, x + 40, y + 40], 1).astype(np.float32)
    else:
        boxes = clustered_boxes(rs, n)
    finite = rs.rand(n) > (0.3 if kind == "non_finite" else 0.0)
    return t(boxes), t(finite)


@pytest.mark.parametrize("kind,n,chunk", [
    ("clustered", 0, None), ("clustered", 1, None), ("clustered", 63, None),
    ("clustered", 64, None), ("clustered", 65, None),
    ("same", 130, None), ("disjoint", 130, None), ("non_finite", 150, None),
    ("clustered", 200, 1), ("clustered", 260, 2)])
def test_nms_tile_walk_emulation_keeps_the_plain_walks_boxes(kind, n, chunk):
    """The kernel's walk (`_walk_emulation`) keeps exactly the boxes of
    `nms_keep_plain`: at 0, 1, 63, 64 and 65 boxes, with every box after
    the first suppressed, none suppressed, non-finite scores, and with a
    tile's rows staged in several chunks."""
    boxes, finite = _walk_boxes(kind, n, 9 + n)
    got = _walk_emulation(boxes, finite, 0.5, chunk)
    want = tnms.nms_keep_plain(boxes, finite, 0.5).numpy()
    np.testing.assert_array_equal(got, want)
    if kind == "same":
        assert want.sum() == 1
    if kind == "disjoint":
        assert want.all()
    if kind == "non_finite":
        assert not want[~finite.numpy()].any() and want.any()


def test_nms_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    b = torch.zeros(5, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="fp32"):
        tnms._kernel_keep(b, torch.ones(5, dtype=torch.bool), 0.5)
    with pytest.raises(ValueError, match="at most"):
        tnms._kernel_keep(torch.zeros(tnms.MAX_BOXES + 1, 4),
                          torch.ones(tnms.MAX_BOXES + 1, dtype=torch.bool),
                          0.5)


# ------------------------------------------------- anchors and assignment


def test_anchors_match_jax():
    shapes, strides = ((16, 24), (8, 12), (4, 6), (2, 3), (1, 2)), \
        (4, 8, 16, 32, 64)
    for g, w in zip(tanchors.multi_level_anchors(shapes, strides),
                    janchors.multi_level_anchors(shapes, strides)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("low_quality", [True, False])
def test_max_iou_assign_matches_jax(low_quality):
    """With an invalid gt, a duplicated gt (the later claims its boxes)
    and duplicated boxes (ties of IoU)."""
    rs = np.random.RandomState(9)
    boxes = clustered_boxes(rs, 120)
    boxes[10:20] = boxes[0]
    gts = clustered_boxes(rs, 8)
    gts[5] = gts[2]
    valid = np.ones(8, bool)
    valid[6] = False
    got = tassign.max_iou_assign(t(boxes), t(gts), t(valid), 0.5, 0.3, 0.3,
                                 low_quality)
    want = jax.jit(jassign.max_iou_assign, static_argnums=(3, 4, 5, 6))(
        boxes, gts, valid, 0.5, 0.3, 0.3, low_quality)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert_close(got[1], want[1])


@pytest.mark.parametrize("num,frac,n_pos", [(64, 0.5, 10), (64, 0.25, 60),
                                            (32, 0.5, 0), (128, 0.5, 300)])
def test_random_sample_matches_jax_on_the_same_draws(num, frac, n_pos):
    """JAX's uniform draws of `rng` fed to the port: the same picks, flags
    and gts, with few, many, no positives, and fewer negatives than the
    budget."""
    rs = np.random.RandomState(10 + n_pos)
    N = 400
    assigned = np.full(N, -2, np.int32)
    assigned[rs.permutation(N)[:n_pos]] = rs.randint(0, 7, n_pos)
    free = np.where(assigned == -2)[0]
    assigned[free[:min(len(free), 90)]] = -1
    rng = jax.random.PRNGKey(n_pos)
    draws = np.asarray(jax.random.uniform(rng, (N,)))
    got = tassign.random_sample(t(draws), t(assigned).long(), num, frac)
    want = jax.jit(jassign.random_sample, static_argnums=(2, 3))(
        rng, jnp.asarray(assigned), num, frac)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------- RoIAlign


def _rois(rs, n, size):
    """Rois of every FPN level, and some partly or wholly off the map."""
    xy = rs.rand(n, 2) * size - size * 0.1
    wh = np.exp(rs.uniform(np.log(4.0), np.log(size * 1.5), (n, 1)))
    wh = wh * rs.uniform(0.5, 1.5, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("out,ratio", [(7, 2), (14, 2), (5, 1)])
def test_roi_align_matches_jax(out, ratio):
    rs = np.random.RandomState(11)
    feat = rs.randn(20, 26, 6).astype(np.float32)
    rois = _rois(rs, 30, 100.0)
    got = troi.roi_align(t(feat), t(rois), out, 0.25, ratio)
    assert_close(got, jax.jit(jroi.roi_align, static_argnums=(2, 3, 4))(
        feat, rois, out, 0.25, ratio))


def test_multi_level_roi_align_matches_jax():
    rs = np.random.RandomState(12)
    feats = [rs.randn(64 // s, 96 // s, 5).astype(np.float32)
             for s in (4, 8, 16, 32)]
    rois = _rois(rs, 60, 300.0)
    levels = troi.assign_fpn_levels(t(rois), 4)
    np.testing.assert_array_equal(levels.numpy(), np.asarray(
        jroi.assign_fpn_levels(rois, 4)))
    assert len(set(levels.tolist())) == 4
    for out in (7, 14):
        got = troi.multi_level_roi_align([t(f) for f in feats], t(rois),
                                         out, (4, 8, 16, 32))
        with jax.default_matmul_precision("highest"):
            want = jax.jit(jroi.multi_level_roi_align,
                           static_argnums=(2, 3))(feats, rois, out,
                                                  (4, 8, 16, 32))
        assert_close(got, want)


def test_crop_resize_masks_matches_jax_from_bool_masks():
    """The targets from bool masks (as the train path ships them) equal
    JAX's from the same masks in fp32."""
    rs = np.random.RandomState(13)
    masks = rs.rand(6, 40, 56) > 0.5
    rois = _rois(rs, 25, 50.0)
    gt_idx = rs.randint(0, 6, 25)
    got = troi.crop_resize_masks(t(masks), t(rois), t(gt_idx).long(), 28)
    want = jax.jit(jroi.crop_resize_masks, static_argnums=3)(
        masks.astype(np.float32), rois, gt_idx, 28)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < float(got.mean()) < 1
