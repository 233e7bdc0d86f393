"""The port's HTC++-style Cascade Mask R-CNN train step
(`det/cascade.py::CascadeRCNN.forward_train` through
`train/trainer.py::make_det_train_step`) against the JAX package's, on the
CPU, in fp32: ExtraAttention, the semantic branch, the mask information
flow and the three stages on the tiny plain-ViT baseline trunk (2 blocks,
one windowed), which keeps JAX's compile of the gradient short
(`test_torch_cascade.py` holds inference on the ViT-Adapter trunk).

The step runs on JAX's sampler draws, replayed from the key splits of
`vitadapter/det/cascade.py::forward_train`: its losses and float64
gradient norm within 2e-4 relative, and one AdamW step with weight decay
that changes the same parameters as optax's (the semantic logits and the
first stage's `conv_res_feat` take no loss: their zero gradients must
still be decayed, as optax decays them)."""

import jax
import numpy as np
import pytest
import torch

from vitadapter.det import cascade as jc
from vitadapter.models.baselines import ViTBaseline as JViTBaseline
from vitadapter.train import optim as joptim
from vitadapter_torch.det import cascade as tc
from vitadapter_torch.det import rpn as trpn
from vitadapter_torch.models.baselines import ViTBaseline
from vitadapter_torch.train.optim import make_optimizer
from vitadapter_torch.train.trainer import TrainState, make_det_train_step
from vitadapter_torch.utils.weights import state_dict_from_flax

from torch_port_util import (CASCADE_HEADS, DET_HW, ReplaySampler,
                             flax_variables, port_like, proposal_margins,
                             scale_cascade_logits, to_np)

BACKBONE = dict(patch_size=16, embed_dim=48, depth=2, num_heads=4,
                window_attn=(True, False), window_size=(3, None))
HEADS = CASCADE_HEADS
B, G = 2, 5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores (see test_torch_upernet)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_draws(rng, n_anchors: int, n_rois: int, stages: int = 3):
    """The uniforms JAX's cascade `forward_train` draws from `rng`, in the
    port's order: the RPN's of each image, then each image's per stage
    (`rng_i, rs = split(rng_i)` a stage)."""
    r_rpn, r_roi = jax.random.split(rng)
    draws = [np.asarray(jax.random.uniform(k, (n_anchors,)))
             for k in jax.random.split(r_rpn, B)]
    for rng_i in jax.random.split(r_roi, B):
        for _ in range(stages):
            rng_i, rs = jax.random.split(rng_i)
            draws.append(np.asarray(jax.random.uniform(rs, (n_rois,))))
    return draws


def batch(seed):
    """Images, gt boxes (8-38 px), labels, bool masks (the boxes filled)
    and valid flags (the last gt of each image invalid)."""
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


OPT = dict(base_lr=1e-3, weight_decay=0.05, depth=2, layer_decay_rate=0.9,
           total_steps=10, warmup_steps=0)


@pytest.fixture(scope="module")
def trained():
    """One port train step (`make_det_train_step`, AdamW with weight
    decay) on JAX's draws, and JAX's losses, gradients and optax step on
    the same batch."""
    jm = jc.CascadeRCNN(backbone=JViTBaseline(**BACKBONE), **HEADS)
    v = flax_variables(jm, np.zeros((1, *DET_HW, 3), np.float32), 21)
    scale_cascade_logits(v["params"])
    port = port_like(tc.CascadeRCNN(ViTBaseline(**BACKBONE, device="meta"),
                                    device="meta", **HEADS), v)
    data = batch(34)
    rng = jax.random.PRNGKey(5)

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
    tx, _ = joptim.make_optimizer(v["params"], **OPT)
    stepped = jax.jit(lambda g, p: jax.tree_util.tree_map(
        lambda a, u: a + u, p, tx.update(g, tx.init(p), p)[0]))(
            grads, v["params"])

    with torch.no_grad():
        port.train()
        feats = port.extract_feats(torch.from_numpy(data["image"]))
        cls_out, reg_out = port.rpn_head(feats)
    anchors = trpn.level_anchors([f.shape[1:3] for f in feats],
                                 tc.FPN_STRIDES, "cpu")
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    sampler = ReplaySampler(jax_draws(
        rng, sum(len(a) for a in anchors), HEADS["num_proposals"] + G))
    optimizer, _ = make_optimizer(port, **OPT)
    b = {k: torch.from_numpy(x) for k, x in data.items()}
    b["gt_labels"] = b["gt_labels"].long()
    _, logs = make_det_train_step(port)(
        TrainState.create(port, optimizer), b,
        torch.Generator().manual_seed(0), sampler)
    return dict(port=port, before=before, logs=logs, want=want, grads=grads,
                stepped=stepped, sampler=sampler, v=v,
                margins=proposal_margins(cls_out, reg_out, anchors, DET_HW))


def test_cascade_train_losses_and_grad_norm_match_jax(trained):
    """The RPN's and the three stages' losses, their sum and the float64
    gradient norm (the step's fp32 norm too), the sampler used up."""
    t = trained
    assert t["margins"][0] > 1e-4 and min(t["margins"][1:]) > 1e-5, \
        t["margins"]
    assert t["sampler"].done()
    want, logs = t["want"], t["logs"]
    stage_keys = {f"s{s}.{k}" for s in range(3)
                  for k in ("loss_cls", "loss_bbox", "loss_mask")}
    assert set(want) == stage_keys | {"loss_rpn_cls", "loss_rpn_bbox",
                                      "loss"}
    for k in want:
        assert abs(float(logs[k]) - float(want[k])) <= 2e-4 * abs(
            float(want[k])), (k, float(logs[k]), float(want[k]))
    want_norm = np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum()
                            for g in jax.tree_util.tree_leaves(t["grads"])))
    assert abs(float(logs["grad_norm"]) - want_norm) <= 2e-4 * want_norm
    assert all(float(want[f"s{s}.loss_mask"]) > 0 for s in range(3))


def test_cascade_optimizer_step_changes_what_optax_changes(trained):
    """After one AdamW step the port's parameters that moved are optax's
    that moved; the ones no loss reaches (the semantic logits, stage 0's
    `conv_res_feat`) got a zero gradient and were decayed as optax decays
    them, and the cls-free biases among them stayed."""
    t = trained
    port = t["port"]
    want = state_dict_from_flax(t["stepped"], t["v"]["batch_stats"])
    start = state_dict_from_flax(t["v"]["params"], t["v"]["batch_stats"])
    zero = state_dict_from_flax(t["grads"], t["v"]["batch_stats"])
    moved = {n for n, p in port.named_parameters()
             if not torch.equal(p.detach(), t["before"][n])}
    want_moved = {n for n in t["before"]
                  if not torch.equal(want[n], start[n])}
    assert moved == want_moved, sorted(moved ^ want_moved)[:8]
    dead = [n for n in t["before"] if not zero[n].any()]
    assert {"roi_head.semantic_head.conv_logits.weight",
            "roi_head.mask_head.0.conv_res_feat.conv.weight"} <= set(dead)
    for n in dead:
        p = dict(port.named_parameters())[n]
        assert p.grad is not None and not p.grad.any(), n
        np.testing.assert_allclose(to_np(p), to_np(want[n]), rtol=1e-6,
                                   atol=1e-8, err_msg=n)
