"""The port's HTC++-style Cascade Mask R-CNN (`det/cascade.py::CascadeRCNN`
with `ExtraAttention`, the semantic branch and the mask information flow)
against the JAX package's at inference, on the CPU, in fp32, at the tiny
geometry of `torch_port_util.DET_*` cut to 2 blocks (one windowed, one
global); `test_torch_cascade_train.py` holds the train step.

Compared stage by stage on one image: the FPN maps, the RPN outputs, each
stage's class logits and deltas on the same proposals (each stage's rois
refined from the last on its own side), then the detections, boxes,
scores and masks within 1e-4 of each one's scale, labels equal (the
margins of the proposals and of the score threshold asserted). The
weights are random, put in the JAX tree by the JAX package's
`convert_detector_checkpoint` (whose tree is the JAX model's own,
`test_torch_beit_det.py`), which spares tracing the JAX model's init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitadapter.det import cascade as jc
from vitadapter.det import mask_rcnn as jmr
from vitadapter.det import rpn as jrpn
from vitadapter.det.boxes import batched_nms as jbatched_nms
from vitadapter.det.roi_align import roi_align as jroi_align
from vitadapter.models.vit_adapter import ViTAdapter as JViTAdapter
from vitadapter.utils.checkpoint import convert_detector_checkpoint
from vitadapter_torch.det import cascade as tc
from vitadapter_torch.det import rpn as trpn
from vitadapter_torch.det.boxes import delta2bbox
from vitadapter_torch.models.vit_adapter import ViTAdapter
from vitadapter_torch.utils.init import init_weights
from vitadapter_torch.utils.weights import load_flax

from torch_port_util import (CASCADE_HEADS, DET_BACKBONE, DET_HW,
                             assert_close, proposal_margins, randomize_flax,
                             scale_cascade_logits)

BACKBONE = dict(DET_BACKBONE, depth=2, interaction_indexes=((0, 0), (1, 1)),
                window_attn=(True, False), window_size=(3, None))
HEADS = CASCADE_HEADS
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores (see test_torch_upernet)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The tiny HTC++ on both sides with the same random weights."""
    port = tc.CascadeRCNN(ViTAdapter(**BACKBONE, device="meta"),
                          device="meta", **HEADS)
    port = init_weights(port.to_empty(device="cpu"),
                        torch.Generator().manual_seed(0)).eval()
    tree = convert_detector_checkpoint(port.state_dict())
    v = {"params": scale_cascade_logits(randomize_flax(tree["params"], 21)),
         "batch_stats": randomize_flax(tree["batch_stats"], 22, stats=True)}
    jm = jc.CascadeRCNN(backbone=JViTAdapter(**BACKBONE), **HEADS)
    return jm, v, load_flax(port, v["params"], v["batch_stats"])


def _jax_stages(jm, v, x):
    """JAX's FPN maps, RPN outputs, proposals, each stage's outputs and the
    detections of one image in one program (`simple_test` written out on
    the maps it returns, so that the trunk is traced once)."""
    def stages(m, x):
        H, W = x.shape[1:3]
        feats = m.extract_feats(x, False)
        cls_out, reg_out = m.rpn_head(feats)
        props, _, valid = jrpn.get_proposals(
            cls_out, reg_out, jmr.multi_level_anchors(
                [f.shape[1:3] for f in feats], jc.FPN_STRIDES), (H, W),
            max_per_img=m.num_proposals)
        _, sem = m.semantic_head(feats[:4])
        fb = [f[0] for f in feats[:4]]

        def roi_feats(rois, size):
            return (jc.multi_level_roi_align(fb, rois, size,
                                             jc.FPN_STRIDES[:4])
                    + jroi_align(sem[0], rois, size, 1.0 / 8))

        rois, outs, probs = props[0], [], 0.0
        for s in range(m.num_stages):
            cls, deltas = m.bbox_heads[s](roi_feats(rois, 7))
            outs.append((cls, deltas))
            probs = probs + jax.nn.softmax(cls, -1)
            rois = jc.delta2bbox(rois, deltas[:, 0], jc.STAGE_STDS[s],
                                 (H, W))
        K = m.num_classes
        flat = (probs / m.num_stages)[:, :K].reshape(-1)
        ok = (flat > 0.05) & jnp.repeat(valid[0], K)
        top_s, top_i = jax.lax.top_k(jnp.where(ok, flat, -jnp.inf),
                                     min(2048, flat.shape[0]))
        boxes, scores, labels, _ = jbatched_nms(
            jnp.repeat(rois, K, axis=0)[top_i], top_s,
            jnp.tile(jnp.arange(K), (rois.shape[0],))[top_i], 0.5,
            m.max_dets, valid=jnp.isfinite(top_s))
        logits = m._mask_logits(roi_feats(boxes, 14))
        masks = jax.nn.sigmoid(logits[jnp.arange(len(labels)), ..., jnp.clip(
            labels, 0, K - 1)])
        return feats, (cls_out, reg_out), props, outs, {
            "boxes": boxes[None], "scores": scores[None],
            "labels": labels[None], "masks": masks[None], "flat": flat}

    with jax.default_matmul_precision("highest"):
        return jax.jit(lambda v, x: jm.apply(v, x, method=stages))(v, x)


def test_cascade_inference_matches_jax(models):
    jm, v, port = models
    x = np.random.RandomState(23).randn(1, *DET_HW, 3).astype(np.float32)
    feats_w, (cls_w, reg_w), props_w, outs_w, dets_w = _jax_stages(jm, v, x)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        feats = port.extract_feats(xt)
        cls_out, reg_out = port.rpn_head(feats)
        dets = port(xt)
        # each stage on JAX's proposals, refined on the port's side
        _, sem = port.semantic_feats(feats)
        fb = [f[0] for f in feats[:4]]
        rois = torch.from_numpy(np.array(props_w[0]))
        outs = []
        for s, head in enumerate(port.roi_head.bbox_head):
            outs.append(head(port.roi_feats(fb, sem[0], rois, 7)))
            rois = delta2bbox(rois, outs[-1][1][:, 0], tc.STAGE_STDS[s],
                              DET_HW)
    for i, (g, w) in enumerate(zip(feats, feats_w)):
        assert_close(g, w, TOL, f"level {i}")
    for g, w in zip(cls_out + reg_out, list(cls_w) + list(reg_w)):
        assert_close(g, w, TOL, "rpn")
    anchors = trpn.level_anchors([f.shape[1:3] for f in feats_w],
                                 tc.FPN_STRIDES, "cpu")
    margins = proposal_margins(cls_w, reg_w, anchors, DET_HW)
    assert margins[0] > 1e-4 and min(margins[1:]) > 1e-5, margins
    for s, ((gc, gd), (wc, wd)) in enumerate(zip(outs, outs_w)):
        assert_close(gc, wc, TOL, f"stage {s} class logits")
        assert_close(gd, wd, TOL, f"stage {s} deltas")

    np.testing.assert_array_equal(dets["labels"].numpy(),
                                  np.asarray(dets_w["labels"]))
    assert int((dets["labels"] >= 0).sum()) == HEADS["max_dets"]
    for k in ("boxes", "scores", "masks"):
        assert_close(dets[k], dets_w[k], TOL, k)
    # no class score within 1e-4 of the 0.05 threshold
    assert float(np.abs(np.asarray(dets_w["flat"]) - 0.05).min()) > 1e-4


@pytest.mark.parametrize("kw", [{"num_stages": 2}, {"with_mask": False}])
def test_cascade_takes_three_stages_with_masks_only(kw):
    """`STAGE_IOUS` fixes three stages, and every config gives masks."""
    with pytest.raises(ValueError, match="3 stages with masks"):
        tc.CascadeRCNN(ViTAdapter(**BACKBONE, device="meta"),
                       device="meta", **{**HEADS, **kw})
