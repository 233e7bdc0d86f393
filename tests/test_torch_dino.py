"""The port's DINO modules (`det/necks.py::ChannelMapper`, `det/dino.py`,
`det/dino_detector.py::DINO`, `det/grounding_dino.py`) against the JAX
package on the CPU at a tiny size, in fp32 within 2e-4 of each output's
scale: the ChannelMapper's learned extra levels; the DINO transformer's
per-layer class and box outputs and encoder proposals with denoising
queries; `cdn_queries` on the JAX package's draws; the matching and
denoising losses, an image without a valid gt among them (`n_valid` 0:
every query unmatched); the DINO and GroundingDINO eval decodes (the same
top box, its score and the boxes); `aug_test_vote`; and the SNIP area
tables."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitadapter.builder import build_model as jbuild_model
from vitadapter.det import dino as jd
from vitadapter.det import grounding_dino as jgd
from vitadapter.det import mask_utils as jmu
from vitadapter.det.dino_detector import DINO as JDINO
from vitadapter.det.necks import ChannelMapper as JChannelMapper
from vitadapter.models.uniperceiver_adapter import \
    UniPerceiverAdapter as JUniPerceiverAdapter
from vitadapter_torch.builder import build, build_model
from vitadapter_torch.det import dino as td
from vitadapter_torch.det import mask_utils as tmu
from vitadapter_torch.det.grounding_dino import GroundingDINO, aug_test_vote
from vitadapter_torch.det.necks import ChannelMapper
from vitadapter_torch.models.uniperceiver_adapter import UniPerceiverAdapter
from vitadapter_torch.ops.matching import (auction_assign_plain,
                                           hungarian_assign)
from vitadapter_torch.utils.weights import (channel_mapper_from_flax,
                                            dino_transformer_from_flax)

from torch_port_util import (assert_close, flax_variables, port_like,
                             randomize_flax, to_np)

TOL = 2e-4
C, K, Q = 32, 3, 12
TRANSFORMER = dict(embed_dim=C, num_heads=4, num_encoder_layers=1,
                   num_decoder_layers=2, ffn_dim=64, num_queries=Q,
                   num_classes=K)
DET_HEAD = dict(num_queries=Q, embed_dim=C, num_heads=4, ffn_dim=64,
                num_encoder_layers=1, num_decoder_layers=2, dn_groups=1,
                max_dets=5)
BASELINE = dict(patch_size=16, embed_dim=48, depth=2, num_heads=4)
UNIPERCEIVER = dict(patch_size=16, embed_dim=48, depth=2, num_heads=4,
                    vocab_size=100, deform_num_heads=4, conv_inplane=16,
                    interaction_indexes=((0, 1),), num_grounding_blocks=1,
                    out_indices=(1, 2, 3))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores (see test_torch_upernet)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def maps(seed, shapes, c, b=2):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, w, c).astype(np.float32) for h, w in shapes]


def flax_params(module, seed, *args):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    return randomize_flax(shapes["params"], seed)


def test_channel_mapper_matches_jax():
    """1x1 conv + GN per input, the extra level a learned 3x3 stride-2
    conv + GN of the last INPUT map (six cells: a GroupNorm of one channel
    over two cells only gives signs)."""
    feats = maps(1, ((16, 24), (8, 12), (4, 6)), 48)
    jm = JChannelMapper(out_channels=C, num_outs=4)
    p = flax_params(jm, 2, feats)
    want = jm.apply({"params": p}, feats)
    port = ChannelMapper([48] * 3, C)
    port.load_state_dict(channel_mapper_from_flax(p))
    got = port([torch.from_numpy(f) for f in feats])
    assert [tuple(g.shape[1:3]) for g in got] == [(16, 24), (8, 12),
                                                  (4, 6), (2, 3)]
    for g, w in zip(got, want):
        assert_close(g, w, TOL)


def cdn_jit(rng, labels, boxes, valid, embed, groups):
    """The JAX `cdn_queries` with K classes and Q matching queries."""
    return jax.jit(jd.cdn_queries, static_argnums=(5, 6, 7))(
        rng, labels, boxes, valid, embed, groups, K, Q)


def jax_draws(rng, B, n_dn, num_classes):
    r_lbl, r_sign, r_box = jax.random.split(rng, 3)
    flip = jax.random.uniform(r_lbl, (B, n_dn)) < 0.25
    label = jax.random.randint(r_lbl, (B, n_dn), 0, num_classes)
    sign = jnp.where(jax.random.uniform(r_sign, (B, n_dn, 4)) > 0.5, 1.0,
                     -1.0)
    u = jax.random.uniform(r_box, (B, n_dn, 4))
    return td.DnDraws(*(torch.from_numpy(np.array(a))
                        for a in (flip, label, sign, u)))


def gts(seed, B=2, G=3):
    """Normalized cxcywh gts; image 1's last gt invalid."""
    rs = np.random.RandomState(seed)
    cxcy = 0.2 + 0.6 * rs.rand(B, G, 2)
    wh = 0.05 + 0.3 * rs.rand(B, G, 2)
    valid = np.ones((B, G), bool)
    valid[1, -1] = False
    return (np.concatenate([cxcy, wh], -1).astype(np.float32),
            rs.randint(0, K, (B, G)).astype(np.int32), valid)


def test_cdn_queries_on_jax_draws_match_jax():
    """Queries (label embeddings of the flipped labels), jittered refs,
    the block attention mask, target labels and boxes, validity."""
    boxes, labels, valid = gts(3)
    embed = np.random.RandomState(4).randn(K, C).astype(np.float32)
    rng = jax.random.PRNGKey(6)
    want = cdn_jit(rng, labels, boxes, valid, embed, 2)
    got = td.cdn_queries(jax_draws(rng, 2, 12, K), torch.from_numpy(labels),
                         torch.from_numpy(boxes), torch.from_numpy(valid),
                         torch.from_numpy(embed), 2, K, Q)
    for name in td.DnQueries._fields:
        w, g = np.asarray(getattr(want, name)), to_np(getattr(got, name))
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


@pytest.fixture(scope="module")
def transformer_side():
    """JAX's transformer on 4 random maps with denoising queries."""
    feats = maps(7, ((8, 12), (4, 6), (2, 3), (1, 2)), C)
    boxes, labels, valid = gts(8)
    embed = np.random.RandomState(9).randn(K, C).astype(np.float32)
    rng = jax.random.PRNGKey(10)
    dn = cdn_jit(rng, labels, boxes, valid, embed, 1)
    jm = jd.DinoTransformer(**TRANSFORMER)
    p = flax_params(jm, 11, feats, dn.queries, dn.refs, dn.attn_mask)
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda p: jm.apply({"params": p}, feats, dn.queries,
                                         dn.refs, dn.attn_mask))(p)
    return dict(feats=feats, dn=dn, p=p,
                out=jax.tree_util.tree_map(np.asarray, out))


def test_dino_transformer_matches_jax(transformer_side):
    s = transformer_side
    port = td.DinoTransformer(**TRANSFORMER)
    sd = dino_transformer_from_flax(s["p"])
    sd["label_embedding.weight"] = port.label_embedding.weight.detach()
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port([torch.from_numpy(f) for f in s["feats"]],
                   torch.from_numpy(np.asarray(s["dn"].queries)),
                   torch.from_numpy(np.asarray(s["dn"].refs)),
                   torch.from_numpy(np.asarray(s["dn"].attn_mask)))
    want = s["out"]
    for key in ("cls", "boxes"):
        assert len(got[key]) == 2
        for g, w in zip(got[key], want[key]):
            assert g.shape == (2, 6 + Q, K if key == "cls" else 4)
            assert_close(g, w, TOL, key)
    assert_close(got["enc_cls"], want["enc_cls"], TOL)
    assert_close(got["enc_boxes"], want["enc_boxes"], TOL)


def predictions(seed, B=2, n=Q):
    rs = np.random.RandomState(seed)
    cxcy = 0.1 + 0.8 * rs.rand(B, n, 2)
    wh = 0.05 + 0.4 * rs.rand(B, n, 2)
    return (rs.randn(B, n, K).astype(np.float32),
            np.concatenate([cxcy, wh], -1).astype(np.float32))


def test_matching_and_dn_losses_match_jax():
    """Focal + L1 + GIoU on the auction's matches (image 0 without a valid
    gt, so none of its queries is matched; image 1's last gt invalid; image
    2's all valid), and the denoising losses."""
    boxes, labels, valid = gts(12, B=3)
    valid[0] = False
    cls, pred = predictions(13, B=3)
    want = jax.jit(jd.dino_matching_loss, static_argnums=5)(
        cls, pred, labels, boxes, valid, K)
    got = td.dino_matching_loss(torch.from_numpy(cls),
                                torch.from_numpy(pred),
                                torch.from_numpy(labels).long(),
                                torch.from_numpy(boxes),
                                torch.from_numpy(valid), K)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= TOL * abs(
            float(want[k])), (k, float(got[k]), float(want[k]))
    embed = np.random.RandomState(14).randn(K, C).astype(np.float32)
    rng = jax.random.PRNGKey(15)
    dn_j = cdn_jit(rng, labels, boxes, valid, embed, 2)
    dn_t = td.cdn_queries(jax_draws(rng, 3, 12, K), torch.from_numpy(labels),
                          torch.from_numpy(boxes), torch.from_numpy(valid),
                          torch.from_numpy(embed), 2, K, Q)
    cls_dn, pred_dn = predictions(16, B=3, n=12)
    want = jax.jit(jd.dino_dn_loss, static_argnums=3)(cls_dn, pred_dn, dn_j,
                                                      K)
    got = td.dino_dn_loss(torch.from_numpy(cls_dn), torch.from_numpy(pred_dn),
                          dn_t, K)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= TOL * abs(
            float(want[k])), (k, float(got[k]), float(want[k]))


def test_n_valid_zero_assigns_nothing():
    """A matrix whose gts are all invalid (the crop removed an image's one
    box) leaves every query unmatched, in the plain auction and through
    `hungarian_assign`, beside a matrix with its one gt."""
    cost = torch.from_numpy(np.random.RandomState(17).rand(2, 100, 1)
                            .astype(np.float32))
    n_valid = torch.tensor([0, 1], dtype=torch.int32)
    owner, rounds = auction_assign_plain(cost, n_valid)
    assert (owner[0] == -1).all() and int(rounds[0]) == 0
    assert int((owner[1] >= 0).sum()) == 1
    assert int(owner[1].argmax()) == int(cost[1, :, 0].argmin())
    assert torch.equal(hungarian_assign(cost, n_valid), owner)


def test_dino_decode_matches_jax(transformer_side):
    """DINO's flat top-k over the 3 classes' sigmoid scores (the JAX
    `DINO._decode`) on the transformer's outputs."""
    out = transformer_side["out"]
    want = JDINO._decode(JDINO(backbone=None, max_dets=5), out, (64, 96))
    got = td.decode_top_k({k: [torch.from_numpy(x) for x in out[k]]
                           for k in ("cls", "boxes")}, (64, 96), 5)
    check_decode(got, want)


def test_dino_train_step_runs():
    """The DINO detector on the plain-ViT baseline: every layer's and the
    encoder's losses, finite, and a gradient for the head."""
    port = build_model(dict(type="DINO", num_classes=K, **DET_HEAD,
                            backbone=dict(type="ViTBaseline", **BASELINE)),
                       device="cpu").train()
    boxes, labels, valid = gts(24)
    scale = torch.tensor([96.0, 64.0, 96.0, 64.0])
    xyxy = torch.cat([torch.from_numpy(boxes[..., :2] - boxes[..., 2:] / 2),
                      torch.from_numpy(boxes[..., :2] + boxes[..., 2:] / 2)],
                     -1) * scale
    losses = port.forward_train(
        torch.randn(2, 64, 96, 3), xyxy, torch.from_numpy(labels).long(),
        torch.from_numpy(valid), generator=torch.Generator().manual_seed(1))
    assert {"enc.loss_cls", "d0.loss_bbox_dn", "loss_iou"} <= set(losses)
    assert all(torch.isfinite(v) for v in losses.values())
    losses["loss"].backward()
    assert port.bbox_head.label_embedding.weight.grad.abs().sum() > 0


def assignment_margin(cost, n_valid) -> float:
    """The smallest gap, over the images, between the optimal assignment's
    total cost on the valid gts and the next best assignment's: any other
    assignment leaves out a pair of the optimum, so the gap is the least
    increase when one optimal pair is forbidden."""
    from scipy.optimize import linear_sum_assignment

    gaps = []
    for c, n in zip(cost.double().numpy(), n_valid.tolist()):
        c = c[:, :n]
        if n == 0:
            continue
        r, col = linear_sum_assignment(c)
        best = c[r, col].sum()
        for i, j in zip(r, col):
            forbidden = c.copy()
            forbidden[i, j] = 1e9
            r2, c2 = linear_sum_assignment(forbidden)
            gaps.append(forbidden[r2, c2].sum() - best)
    return float(min(gaps))


def test_dino_train_losses_match_jax():
    """The DINO detector on the plain-ViT baseline in training (3 classes,
    3 gts an image, image 1's last invalid, on the JAX package's denoising
    draws): every layer's, the denoising and the encoder's losses within
    2e-4 relative of JAX's `DINO` on the same weights. Asserted first: the
    encoder's top-12 cut of its proposals and every assignment (the
    optimum against the next best) are 1e-4 clear, so that float noise
    cannot change them. On 128x192 images: the stride-64 level's 2x3
    cells keep its one-channel GroupNorms well conditioned."""
    img = np.random.RandomState(25).randn(2, 128, 192, 3).astype(np.float32)
    boxes, labels, valid = gts(26)
    scale = np.asarray([192.0, 128.0, 192.0, 128.0], np.float32)
    xyxy = np.concatenate([boxes[..., :2] - boxes[..., 2:] / 2,
                           boxes[..., :2] + boxes[..., 2:] / 2], -1) * scale
    cfg = dict(type="DINO", num_classes=K, **DET_HEAD,
               backbone=dict(type="ViTBaseline", **BASELINE))
    jm = jbuild_model(copy.deepcopy(cfg))
    v = flax_variables(jm, img, 27)
    rng = jax.random.PRNGKey(28)
    with jax.default_matmul_precision("highest"):
        want, _ = jax.jit(lambda v: jm.apply(
            v, img, train=True, gt_boxes=xyxy, gt_labels=labels,
            gt_valid=valid, rng=rng, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(29)}))(v)
    port = port_like(build(copy.deepcopy(cfg)), v).train()
    costs, enc_scores = [], []

    def assigner(cost, n_valid):
        costs.append((cost.clone(), n_valid.clone()))
        return hungarian_assign(cost, n_valid)

    n_dec = DET_HEAD["num_decoder_layers"]
    hook = port.bbox_head.cls_branches[n_dec].register_forward_hook(
        lambda m, i, o: enc_scores.append(o.detach()))
    with torch.no_grad():
        got = port.forward_train(
            torch.from_numpy(img), torch.from_numpy(xyxy),
            torch.from_numpy(labels).long(), torch.from_numpy(valid),
            dn_draws=jax_draws(rng, 2, 2 * 3 * DET_HEAD["dn_groups"], K),
            assigner=assigner)
    hook.remove()
    top = torch.sort(enc_scores[0].amax(-1), -1, descending=True).values
    assert float((top[:, Q - 1] - top[:, Q]).min()) > 1e-4
    assert len(costs) == n_dec + 1
    assert min(assignment_margin(c, n) for c, n in costs) > 1e-4
    assert set(got) == set(want)
    assert {"enc.loss_cls", "d0.loss_bbox_dn", "loss_iou"} <= set(got)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= TOL * abs(
            float(want[k])), (k, float(got[k]), float(want[k]))


def check_decode(got, want):
    """The same top box per image (its score 1e-4 clear of the next), the
    scores and the boxes in the JAX order."""
    s = np.asarray(want["scores"])
    assert float((s[:, 0] - s[:, 1]).min()) > 1e-4
    np.testing.assert_array_equal(to_np(got["labels"]),
                                  np.asarray(want["labels"]))
    assert_close(got["scores"], want["scores"], TOL)
    assert_close(got["boxes"], want["boxes"], TOL)


def test_grounding_dino_eval_decode_matches_jax():
    """GroundingDINO on the UniPerceiver-Adapter with a padded question;
    the aux-seg branch's weights load and stay out of the decode."""
    rs = np.random.RandomState(20)
    img = rs.randn(2, 64, 96, 3).astype(np.float32)
    ids = rs.randint(0, 100, (2, 5)).astype(np.int32)
    m = np.ones((2, 5), np.int32)
    m[1, 3:] = 0
    jm = jgd.GroundingDINO(backbone=JUniPerceiverAdapter(**UNIPERCEIVER),
                           num_classes=1, with_aux_seg=True, **DET_HEAD)
    v = flax_variables(jm, img, 21, refer=ids, r_mask=m)
    port = port_like(GroundingDINO(
        UniPerceiverAdapter(**UNIPERCEIVER, device="meta"), num_classes=1,
        with_aux_seg=True, device="meta", **DET_HEAD), v)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v: jm.apply(v, img, ids, m))(v)
    with torch.no_grad():
        got = port(torch.from_numpy(img), torch.from_numpy(ids),
                   torch.from_numpy(m))
    check_decode(got, want)


def test_aug_test_vote_matches_jax():
    """The pooled boxes of three augs, one with a non-finite score."""
    rs = np.random.RandomState(22)
    per = []
    for a in range(3):
        xy = rs.rand(6, 2) * 50
        r = {"boxes": np.concatenate([xy, xy + 10 + rs.rand(6, 2) * 30], -1
                                     ).astype(np.float32),
             "scores": rs.rand(6).astype(np.float32)}
        if a == 1:
            r["scores"][2] = -np.inf
        per.append(r)
    np.testing.assert_array_equal(aug_test_vote(per, top_k=4),
                                  jgd.aug_test_vote(per, top_k=4))
    np.testing.assert_array_equal(aug_test_vote(per), jgd.aug_test_vote(per))
    empty = [{"boxes": np.zeros((2, 4), np.float32),
              "scores": np.full(2, np.nan, np.float32)}]
    np.testing.assert_array_equal(aug_test_vote(empty), np.zeros(4))


@pytest.mark.parametrize("version", ["v1", "v2", "v3", "v4"])
def test_snip_tables_match_jax(version):
    rs = np.random.RandomState(23)
    boxes = np.concatenate([rs.rand(40, 2) * 500, rs.rand(40, 2) * 500
                            + 600], -1).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rs.rand(40, 2) * 300
    for short in (480, 600, 800, 1000, 1200, 1400, 1600, 2000):
        assert tmu.get_area_thr(short, version) == \
            jmu.get_area_thr(short, version)
        np.testing.assert_array_equal(
            tmu.scale_range_filter(boxes, short, version),
            jmu.scale_range_filter(boxes, short, version))
        areas = rs.rand(30) * 200 ** 2
        np.testing.assert_array_equal(
            tmu.snip_gt_weights(areas, short, version, 0.25),
            jmu.snip_gt_weights(areas, short, version, 0.25))
