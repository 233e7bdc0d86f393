"""The port's Mask R-CNN losses and gradients (`det/mask_rcnn.py::
forward_train`, `train/trainer.py::make_det_train_step`) against the JAX
package's, on the CPU, at the tiny geometry of `torch_port_util.DET_*`
cut to 2 blocks (one windowed), which keeps JAX's compile of the gradient
short.

The samplers' uniforms are JAX's: the test replays the key splits of
`vitadapter/det/mask_rcnn.py::forward_train` (`r_rpn, r_roi =
split(rng)`, then one key an image for the RPN's and the RoI sampler's
draws) and hands the draws to the port's sampler in the order the port
asks for them. fp32: each loss and the float64 gradient norm within 2e-4
relative. The test first asserts that the proposals' top-k and NMS
decisions, and their order, are clear of float noise on these inputs.
The bf16 model against JAX's bf16 is held to `BF16_TOL`."""

import jax
import numpy as np
import pytest
import torch

from vitadapter.det import mask_rcnn as jmr
from vitadapter.models.vit_adapter import ViTAdapter as JViTAdapter
from vitadapter_torch.det import mask_rcnn as tmr
from vitadapter_torch.det import rpn as trpn
from vitadapter_torch.det.roi_align import multi_level_roi_align
from vitadapter_torch.models.vit_adapter import ViTAdapter
from vitadapter_torch.train.optim import make_optimizer
from vitadapter_torch.train.trainer import TrainState, make_det_train_step

from torch_port_util import (DET_BACKBONE, DET_HEADS, DET_HW, ReplaySampler,
                             assert_close, flax_variables, port_like,
                             proposal_margins)

BACKBONE = dict(DET_BACKBONE, depth=2, interaction_indexes=((0, 0), (1, 1)),
                window_attn=(True, False), window_size=(3, None))
B, G = 2, 5
# bf16 against bf16: both sides round every conv, linear and norm output to
# bf16 from fp32 sums taken in another order (and JAX's attention rounds
# its logits to bf16 where the port's kernel keeps them fp32), so a
# rounding can go the other way and travel through the later layers. Held
# to 4 bf16 ulps (2^-6) of each output's scale, as
# `test_torch_upernet.py::test_bf16_segmentor_and_loss_match_jax_bf16`
BF16_TOL = 4 * 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores (see test_torch_upernet)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch(seed):
    """Images, gt boxes (8-38 px) in the image, labels, bool masks (the
    boxes filled) and valid flags (the last gt of each image invalid)."""
    rs = np.random.RandomState(seed)
    H, W = DET_HW
    xy = rs.rand(B, G, 2) * np.array([W - 40, H - 40])
    wh = rs.rand(B, G, 2) * 30 + 8
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    masks = np.zeros((B, G, H, W), bool)
    for b in range(B):
        for g in range(G):
            x1, y1, x2, y2 = boxes[b, g].astype(int)
            masks[b, g, y1:y2, x1:x2] = True
    valid = np.ones((B, G), bool)
    valid[:, -1] = False
    return {"image": rs.randn(B, H, W, 3).astype(np.float32),
            "gt_boxes": boxes,
            "gt_labels": rs.randint(0, 5, (B, G)).astype(np.int32),
            "gt_masks": masks, "gt_valid": valid}


def jax_draws(rng, n_anchors: int, n_rois: int):
    """The uniforms JAX's forward_train draws from `rng`, in the port's
    order: the RPN's of each image, then the RoI sampler's."""
    r_rpn, r_roi = jax.random.split(rng)
    return ([np.asarray(jax.random.uniform(k, (n_anchors,)))
             for k in jax.random.split(r_rpn, B)]
            + [np.asarray(jax.random.uniform(k, (n_rois,)))
               for k in jax.random.split(r_roi, B)])


def test_train_losses_and_grad_norm_match_jax():
    """One `make_det_train_step` on JAX's draws: the five losses, their
    sum, and the float64 norm of the gradients (the step's own fp32 norm
    before clipping too) against JAX's `value_and_grad`; the sampler used
    up exactly."""
    data = batch(5)
    jm = jmr.MaskRCNN(backbone=JViTAdapter(**BACKBONE), **DET_HEADS)
    v = flax_variables(jm, data["image"], 2)
    port = port_like(tmr.MaskRCNN(ViTAdapter(**BACKBONE, device="meta"),
                                  device="meta", **DET_HEADS), v)
    rng = jax.random.PRNGKey(3)

    def loss_fn(params):
        losses, _ = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            data["image"], train=True, gt_boxes=data["gt_boxes"],
            gt_labels=data["gt_labels"],
            gt_masks=data["gt_masks"].astype(np.float32),
            gt_valid=data["gt_valid"], rng=rng, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(4)})
        return losses["loss"], losses

    with jax.default_matmul_precision("highest"):
        (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v["params"])
    want_norm = np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum()
                            for g in jax.tree_util.tree_leaves(grads)))

    # the proposals' margins on the train-mode RPN outputs (a top-k cut or
    # NMS decision within float noise would give the sides other rois)
    with torch.no_grad():
        port.train()
        feats = port.extract_feats(torch.from_numpy(data["image"]))
        cls_out, reg_out = port.rpn_head(feats)
    anchors = trpn.level_anchors([f.shape[1:3] for f in feats],
                                 tmr.FPN_STRIDES, "cpu")
    margins = proposal_margins(cls_out, reg_out, anchors, DET_HW)
    assert margins[0] > 1e-4 and min(margins[1:]) > 1e-5, margins

    n_anchors = sum(len(a) for a in anchors)
    sampler = ReplaySampler(jax_draws(rng, n_anchors,
                                      DET_HEADS["num_proposals_train"] + G))
    optimizer, _ = make_optimizer(port, base_lr=0.0, weight_decay=0.0,
                                  depth=2, total_steps=10, warmup_steps=0)
    step = make_det_train_step(port)
    b = {k: torch.from_numpy(x) for k, x in data.items()}
    b["gt_labels"] = b["gt_labels"].long()
    _, logs = step(TrainState.create(port, optimizer), b,
                   torch.Generator().manual_seed(0), sampler)
    assert sampler.done()
    got_norm = float(torch.sqrt(sum(
        p.grad.double().square().sum() for p in port.parameters()
        if p.grad is not None)))
    assert set(want) == set(tmr.LOSS_KEYS) | {"loss"}
    for k in want:
        assert abs(float(logs[k]) - float(want[k])) <= 2e-4 * abs(
            float(want[k])), (k, float(logs[k]), float(want[k]))
    assert abs(got_norm - want_norm) <= 2e-4 * want_norm
    assert abs(float(logs["grad_norm"]) - want_norm) <= 2e-4 * want_norm
    assert float(want["loss_mask"]) > 0 and float(want["loss_bbox"]) > 0


def test_bf16_model_matches_jax_bf16():
    """The model with its backbone, neck and heads in bf16 on both sides,
    as the bf16 Mask R-CNN configs run them, from the same fp32 weights:
    the FPN maps, the RPN outputs and the RoI heads' outputs on the same
    (JAX's) proposals within `BF16_TOL` of each one's scale."""
    x = np.random.RandomState(6).randn(2, *DET_HW, 3).astype(np.float32)
    bb = dict(BACKBONE, dtype=jax.numpy.bfloat16)
    jm = jmr.MaskRCNN(backbone=JViTAdapter(**bb), dtype=jax.numpy.bfloat16,
                      **DET_HEADS)
    v = flax_variables(jm, x, 6)
    port = port_like(tmr.MaskRCNN(
        ViTAdapter(**BACKBONE, dtype=torch.bfloat16, device="meta"),
        dtype=torch.bfloat16, device="meta", **DET_HEADS), v)

    def stages(m, x):
        feats = m.extract_feats(x, False)
        cls, reg = m.rpn_head(feats)
        props = jmr.get_proposals(cls, reg, jmr.multi_level_anchors(
            [f.shape[1:3] for f in feats], jmr.FPN_STRIDES), DET_HW,
            max_per_img=DET_HEADS["num_proposals_test"])[0]
        rois = [jmr.multi_level_roi_align([f[b] for f in feats[:4]],
                                          props[b], 7, jmr.FPN_STRIDES[:4])
                for b in range(x.shape[0])]
        return feats, cls + reg, props, [m.bbox_head(r) for r in rois]

    want = jax.jit(lambda v, x: jm.apply(v, x, method=stages))(v, x)
    with torch.no_grad():
        feats = port.extract_feats(torch.from_numpy(x))
        cls, reg = port.rpn_head(feats)
        heads = [port.roi_head.bbox_head(multi_level_roi_align(
            [f[b] for f in feats[:4]], torch.from_numpy(np.asarray(
                want[2][b])), 7, tmr.FPN_STRIDES[:4]))
            for b in range(x.shape[0])]
    assert feats[0].dtype == torch.bfloat16 and cls[0].dtype == torch.float32
    for i, (g, w) in enumerate(zip(feats, want[0])):
        assert_close(g, w, BF16_TOL, f"level {i}")
    for g, w in zip(cls + reg, want[1]):
        assert_close(g, w, BF16_TOL, "rpn")
    for (gc, gd), (wc, wd) in zip(heads, want[3]):
        assert_close(gc, wc, BF16_TOL, "class logits")
        assert_close(gd, wd, BF16_TOL, "deltas")
