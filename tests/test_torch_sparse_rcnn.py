"""The port's Sparse R-CNN (`det/sparse_rcnn.py`, `utils/weights.py::
sparse_rcnn_from_flax`) against the JAX package on the CPU, at the tiny
geometry of `torch_port_util.DET_*` cut to 1 block, 12 proposals and 2
stages, in fp32 within 2e-4 of each output's scale: every stage's class
logits and boxes; the eval decode; one train step's losses and float64
gradient norm (2e-4 relative) with both sides matched by scipy's exact
solver (the JAX package's own on one CPU device; the port's plain auction
can split near-ties otherwise), every matching asserted 1e-4 clear of its
next best; the converter's round trip through JAX's
`convert_detector_checkpoint`; and the shipped config's parameter count
against JAX's `eval_shape`."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from vitadapter.builder import build_model as jbuild_model
from vitadapter.det import sparse_rcnn as jsr
from vitadapter.det.boxes import delta2bbox as jdelta2bbox
from vitadapter.det.losses import cxcywh_to_xyxy
from vitadapter.models.vit_adapter import ViTAdapter as JViTAdapter
from vitadapter.utils.checkpoint import convert_detector_checkpoint
from vitadapter.utils.config import Config as JConfig
from vitadapter_torch import builder
from vitadapter_torch.det import sparse_rcnn as tsr
from vitadapter_torch.models.vit_adapter import ViTAdapter
from vitadapter_torch.train.optim import make_optimizer
from vitadapter_torch.train.trainer import TrainState, make_det_train_step
from vitadapter_torch.utils.config import Config

from torch_port_util import (DET_BACKBONE, DET_HW, assert_close,
                             flax_variables, port_like)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4
BACKBONE = dict(DET_BACKBONE, depth=1, interaction_indexes=((0, 0),),
                window_attn=(True,), window_size=(3,))
HEADS = dict(num_classes=4, num_proposals=12, num_stages=2, channels=32,
             max_dets=10)
B, G = 2, 4
CONFIG = "configs/sparse_rcnn/sparse_rcnn_deit_adapter_small_fpn_3x_coco.py"
# JAX's `eval_shape` of the shipped config
PARAMETERS = 109_687_704


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores (see test_torch_upernet)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models(x, seed):
    """Both detectors on the same random weights, the stages' box
    regression scaled by 0.1 (deltas of order 1, as trained stages give
    them) and the learned proposals spread over the image."""
    jm = jsr.SparseRCNN(backbone=JViTAdapter(**BACKBONE), **HEADS)
    v = flax_variables(jm, x, seed)
    p = v["params"]
    for s in range(HEADS["num_stages"]):
        reg = p[f"stage_{s}"]["fc_reg"]
        reg["kernel"] = reg["kernel"] * 0.1
    rs = np.random.RandomState(seed)
    n = HEADS["num_proposals"]
    p["init_proposal_boxes"] = np.concatenate(
        [0.3 + 0.4 * rs.rand(n, 2), 0.2 + 0.5 * rs.rand(n, 2)],
        -1).astype(np.float32)
    port = port_like(tsr.SparseRCNN(ViTAdapter(**BACKBONE, device="meta"),
                                    device="meta", **HEADS), v)
    return jm, v, port


def jax_stages(m, x):
    """Every stage's class logits and boxes, as `SparseRCNN._stages`."""
    Bx, H, W, _ = x.shape
    feats = m.neck(m.backbone(x))
    scale = jnp.asarray([W, H, W, H], jnp.float32)
    boxes = jnp.broadcast_to(cxcywh_to_xyxy(m.init_boxes)[None] * scale,
                             (Bx, m.num_proposals, 4))
    prop = jnp.broadcast_to(m.init_feats[None],
                            (Bx, m.num_proposals, m.channels))
    out = []
    for head in m.heads:
        rf = jax.vmap(lambda f, b: jsr.multi_level_roi_align(
            f, b, 7, jsr.FPN_STRIDES).reshape(b.shape[0], 49, -1))(
            list(feats), boxes)
        cls, delta, prop = head(rf, prop)
        boxes = jdelta2bbox(boxes, delta, (0.5, 0.5, 1.0, 1.0), (H, W))
        out.append((cls, boxes))
    return out


def batch(seed):
    rs = np.random.RandomState(seed)
    H, W = DET_HW
    xy = rs.rand(B, G, 2) * np.array([W - 40, H - 40])
    wh = rs.rand(B, G, 2) * 30 + 8
    valid = np.ones((B, G), bool)
    valid[1, -1] = False
    return {"image": rs.randn(B, H, W, 3).astype(np.float32),
            "gt_boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
            "gt_labels": rs.randint(0, HEADS["num_classes"], (B, G)
                                    ).astype(np.int32),
            "gt_valid": valid}


def test_stages_and_decode_match_jax():
    x = np.random.RandomState(1).randn(B, *DET_HW, 3).astype(np.float32)
    jm, v, port = models(x, 2)
    want, dets = jax.jit(lambda v, x: (jm.apply(v, x, method=jax_stages),
                                       jm.apply(v, x)))(v, x)
    with torch.no_grad():
        all_cls, all_boxes = port._stages(torch.from_numpy(x))
        out = port(torch.from_numpy(x))
    for s, (gc, gb, (wc, wb)) in enumerate(zip(all_cls, all_boxes, want)):
        assert_close(gc, wc, TOL, f"stage {s} cls")
        assert_close(gb, wb, TOL, f"stage {s} boxes")
    # the decode's top-k cut and order are clear of float noise
    s = np.sort(np.asarray(jax.nn.sigmoid(want[-1][0])).reshape(B, -1),
                -1)[:, ::-1]
    assert np.diff(s[:, :HEADS["max_dets"] + 1], axis=-1).max() < -1e-5
    np.testing.assert_array_equal(out["labels"].numpy(),
                                  np.asarray(dets["labels"]))
    for k in ("scores", "boxes"):
        assert_close(out[k], dets[k], TOL, k)


def assignment_margin(cost: np.ndarray, n: int) -> float:
    """The optimal assignment's total cost on the `n` valid gts against
    the next best one's (each optimal pair forbidden in turn)."""
    c = cost[:, :n].astype(np.float64)
    r, col = linear_sum_assignment(c)
    best = c[r, col].sum()
    gaps = []
    for i, j in zip(r, col):
        f = c.copy()
        f[i, j] = 1e9
        r2, c2 = linear_sum_assignment(f)
        gaps.append(f[r2, c2].sum() - best)
    return min(gaps)


def scipy_assign(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """The JAX package's matching on one CPU device: scipy's exact solver
    on each image's valid gts."""
    out = torch.full(cost.shape[:2], -1, dtype=torch.long)
    for b, (c, n) in enumerate(zip(cost.double().numpy(), n_valid.tolist())):
        r, col = linear_sum_assignment(c[:, :n])
        out[b, torch.from_numpy(r)] = torch.from_numpy(col)
    return out


def test_train_step_losses_and_grad_norm_match_jax():
    """Every stage's losses (`s0.` the first) and the float64 gradient
    norm of one `make_det_train_step` against JAX's `value_and_grad`."""
    data = batch(3)
    jm, v, port = models(data["image"], 4)

    def loss_fn(params):
        losses, _ = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            data["image"], train=True, gt_boxes=data["gt_boxes"],
            gt_labels=data["gt_labels"], gt_valid=data["gt_valid"],
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(5)})
        return losses["loss"], losses

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    want_norm = np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum()
                            for g in jax.tree_util.tree_leaves(grads)))
    costs = []

    def assigner(cost, n_valid):
        costs.append((cost.numpy().copy(), n_valid.tolist()))
        return scipy_assign(cost, n_valid)

    optimizer, _ = make_optimizer(port, base_lr=0.0, weight_decay=0.0,
                                  depth=1, total_steps=10, warmup_steps=0)
    b = {k: torch.from_numpy(x) for k, x in data.items()}
    b["gt_labels"] = b["gt_labels"].long()
    _, logs = make_det_train_step(port)(
        TrainState.create(port, optimizer), b,
        torch.Generator().manual_seed(0), assigner=assigner)
    assert len(costs) == HEADS["num_stages"]
    assert min(assignment_margin(c[i], n[i]) for c, n in costs
               for i in range(B)) > 1e-4
    got_norm = float(torch.sqrt(sum(p.grad.double().square().sum()
                                    for p in port.parameters())))
    assert set(want) == set(logs) - {"grad_norm"}
    assert {"s0.loss_cls", "loss_iou"} <= set(want)
    for k in want:
        assert abs(float(logs[k]) - float(want[k])) <= TOL * abs(
            float(want[k])), (k, float(logs[k]), float(want[k]))
    assert abs(got_norm - want_norm) <= TOL * want_norm, (got_norm,
                                                          want_norm)
    assert port.rpn_head.init_proposal_bboxes.weight.grad.abs().sum() > 0


def test_converter_round_trip_through_jax():
    """The port's `state_dict()` (mmdet's keys) read by JAX's
    `convert_detector_checkpoint` gives back the flax tree it came from."""
    jm, v, port = models(np.zeros((1, 64, 64, 3), np.float32), 6)
    sd = port.state_dict()
    assert {"rpn_head.init_proposal_bboxes.weight",
            "roi_head.bbox_head.1.attention.attn.in_proj_weight",
            "roi_head.bbox_head.0.instance_interactive_conv.fc_layer.weight",
            "roi_head.bbox_head.0.reg_fcs.7.weight"} <= set(sd)
    back = convert_detector_checkpoint(dict(sd))["params"]
    flat_w = jax.tree_util.tree_flatten_with_path(v["params"])[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_b) == len(flat_w)
    for path, leaf in flat_w:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf))


def test_config_parameter_count_matches_jax():
    path = os.path.join(ROOT, CONFIG)
    model = builder.build(dict(Config.fromfile(path).model))
    assert isinstance(model, tsr.SparseRCNN)
    got = sum(p.numel() for p in model.parameters())
    jm = jbuild_model(dict(JConfig.fromfile(path).model))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3),
                                                 np.float32))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert got == want == PARAMETERS
