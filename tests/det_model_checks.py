"""The Mask R-CNN inference checks of `test_torch_det_model.py` (FPN neck)
and `test_torch_det_channel_mapper.py` (the channel mapper), one neck a
file so that each file's JAX compile stays short. The port's Mask R-CNN
(`vitadapter_torch/det/mask_rcnn.py`) against the JAX package's at
inference, on the CPU, in fp32, at the tiny geometry of
`tests/test_mask_rcnn.py` (`torch_port_util.DET_*`: 48 wide, 3-token
windows, a 64x96 image whose 4x6 token grid the windows pad to 6x6), the
trunk cut to 2 blocks (one windowed, one global).

Weights go flax -> `utils/weights.py::mask_rcnn_from_flax` (with
`vit_adapter_from_flax` for the trunk); the port's `state_dict()` ->
`convert_detector_checkpoint` round trip is held bitwise. The forward is
compared stage by stage: the FPN maps, the RPN outputs, the proposals
(from the same RPN outputs on both sides), then the detections.
Continuous outputs within 2e-4 of each one's scale; where a comparison
crosses a threshold (top-k, NMS, the score threshold) the indices must be
equal, and the check asserts the margins that make them so (as
`test_torch_modules.py::test_mask2former_head_all_outputs_parity`
does)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vitadapter.det import mask_rcnn as jmr
from vitadapter.det import rpn as jrpn
from vitadapter.models.vit_adapter import ViTAdapter as JViTAdapter
from vitadapter.utils.checkpoint import convert_detector_checkpoint
from vitadapter_torch.det import mask_rcnn as tmr
from vitadapter_torch.det import rpn as trpn
from vitadapter_torch.models.vit_adapter import ViTAdapter
from vitadapter_torch.utils.init import init_weights
from vitadapter_torch.utils.weights import state_dict_from_flax

from torch_port_util import (DET_BACKBONE, DET_HEADS, DET_HW, assert_close,
                             flax_variables, port_like, proposal_margins)


def t(x):
    return torch.from_numpy(np.array(x))


# the trunk is cut to 2 blocks (one windowed, one global), which keeps
# JAX's compile of the test path short; the windows still pad (the
# 4-block windowed trunk is held in test_torch_det_heads.py)
BACKBONE = dict(DET_BACKBONE, depth=2, interaction_indexes=((0, 0), (1, 1)),
                window_attn=(True, False), window_size=(3, None))


# images whose proposals keep every margin above 1e-5 (asserted below)
IMAGE_SEED = {"fpn": 12, "channel_mapper": 13}


def build_pair(neck: str):
    """The tiny Mask R-CNN with neck `neck` on both sides, same weights:
    (neck, the JAX module, its variables, the port's model)."""
    x = np.zeros((1, *DET_HW, 3), np.float32)
    jm = jmr.MaskRCNN(backbone=JViTAdapter(**BACKBONE), neck_type=neck,
                      **DET_HEADS)
    v = flax_variables(jm, x, 1)
    port = port_like(tmr.MaskRCNN(ViTAdapter(**BACKBONE, device="meta"),
                                  neck_type=neck, device="meta",
                                  **DET_HEADS), v)
    return neck, jm, v, port


def _jax_stages(jm, v, x):
    """JAX's FPN maps, RPN outputs and detections of x in one program:
    `MaskRCNN.simple_test` written out on the maps it returns, so that
    the trunk is traced once."""
    def stages(m, x):
        H, W = x.shape[1:3]
        feats = m.extract_feats(x, False)
        cls_out, reg_out = m.rpn_head(feats)
        props, _, valid = jrpn.get_proposals(
            cls_out, reg_out, jmr.multi_level_anchors(
                [f.shape[1:3] for f in feats], jmr.FPN_STRIDES), (H, W),
            max_per_img=m.num_proposals_test)
        fb = [f[0] for f in feats[:4]]
        cls, deltas = m.bbox_head(jmr.multi_level_roi_align(
            fb, props[0], 7, jmr.FPN_STRIDES[:4]))
        boxes, scores, labels, _ = jmr.decode_detections(
            cls, deltas, props[0], (H, W), max_per_img=m.max_dets,
            valid=valid[0])
        logits = m.mask_head(jmr.multi_level_roi_align(
            fb, boxes, 14, jmr.FPN_STRIDES[:4]))
        masks = jax.nn.sigmoid(logits[jnp.arange(len(labels)), ..., jnp.clip(
            labels, 0, m.num_classes - 1)])
        return feats, (cls_out, reg_out), {
            "boxes": boxes[None], "scores": scores[None],
            "labels": labels[None], "masks": masks[None]}

    with jax.default_matmul_precision("highest"):
        return jax.jit(lambda v, x: jm.apply(v, x, method=stages))(v, x)


def check_inference(models):
    """One 64x96 image through the test path. The FPN maps and the RPN
    outputs; the proposals from JAX's RPN outputs on both sides (valid
    flags equal, boxes and scores within TOL; the top-k cut's and the
    NMS's margins asserted); the detections (labels equal; boxes, scores
    and 28x28 masks within TOL; the score threshold's margin asserted)."""
    neck, jm, v, port = models
    x = np.random.RandomState(IMAGE_SEED[neck]).randn(1, *DET_HW, 3).astype(
        np.float32)
    feats_w, (cls_w, reg_w), dets_w = _jax_stages(jm, v, x)
    with torch.no_grad():
        feats = port.extract_feats(t(x))
        cls_out, reg_out = port.rpn_head(feats)
        dets = port(t(x))
    for i, (g, w) in enumerate(zip(feats, feats_w)):
        assert_close(g, w, msg=f"{neck} level {i}")
    for g, w in zip(cls_out + reg_out, list(cls_w) + list(reg_w)):
        assert_close(g, w, msg="rpn")

    # proposals from the same (JAX's) RPN outputs
    anchors = trpn.level_anchors([f.shape[1:3] for f in feats_w],
                                 tmr.FPN_STRIDES, "cpu")
    got = trpn.get_proposals([t(c) for c in cls_w], [t(r) for r in reg_w],
                             anchors, DET_HW, max_per_img=50)
    want = jax.jit(lambda c, r: jrpn.get_proposals(
        c, r, [a.numpy() for a in anchors], DET_HW, max_per_img=50))(
        list(cls_w), list(reg_w))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[2].sum()) == 50
    assert_close(got[0], want[0], msg="proposals")
    assert_close(got[1], want[1], msg="proposal scores")
    # the margins of each level's top-k cut and of the NMS
    margins = proposal_margins(cls_w, reg_w, anchors, DET_HW)
    assert margins[0] > 1e-4 and min(margins[1:]) > 1e-5, margins

    np.testing.assert_array_equal(dets["labels"].numpy(),
                                  np.asarray(dets_w["labels"]))
    assert int((dets["labels"] >= 0).sum()) == DET_HEADS["max_dets"]
    assert_close(dets["boxes"], dets_w["boxes"], msg="boxes")
    assert_close(dets["scores"], dets_w["scores"], msg="scores")
    assert_close(dets["masks"], dets_w["masks"], msg="masks")
    assert float(np.asarray(dets_w["scores"]).min()) > 0.05 + 1e-4


def check_round_trip(models):
    """port state_dict -> the JAX `convert_detector_checkpoint` ->
    `state_dict_from_flax` gives back every key bitwise (BatchNorm's
    num_batches_tracked aside), and the tree is the JAX model's own."""
    neck, jm, v, _ = models
    port = tmr.MaskRCNN(ViTAdapter(**BACKBONE, device="meta"),
                        neck_type=neck, device="meta", **DET_HEADS)
    port = init_weights(port.to_empty(device="cpu"),
                        torch.Generator().manual_seed(11))
    sd = port.state_dict()
    conv = convert_detector_checkpoint(sd)
    back = state_dict_from_flax(conv["params"], conv["batch_stats"])
    want = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert set(back) == want
    for k in want:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0, msg=k)
    for tree in ("params", "batch_stats"):
        assert (jax.tree_util.tree_map(np.shape, conv[tree])
                == jax.tree_util.tree_map(np.shape, v[tree]))
