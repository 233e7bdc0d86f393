"""The port's ATSS and GFL (`det/single_stage.py`, FPN's `start_level` and
learned `on_output` extras in `det/necks.py`, `utils/weights.py::
atss_from_flax`) against the JAX package on the CPU, at the tiny geometry
of `torch_port_util.DET_*` cut to 1 block, in fp32 within 2e-4 of each
output's scale: the FPN; `atss_assign` exactly, grid ties and an invalid
gt among them; the centerness target, the delta decode, GFL's integral,
the quality and distribution focal losses; each detector's per-anchor
outputs, its detections (after asserting that the NMS decisions are clear
of float noise) and one train step's losses and float64 gradient norm
(2e-4 relative); the converter's round trip through JAX's
`convert_detector_checkpoint`; and the two shipped configs' parameter
counts against JAX's `eval_shape`."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitadapter.builder import build_model as jbuild_model
from vitadapter.det import single_stage as jss
from vitadapter.det.necks import FPN as JFPN
from vitadapter.models.vit_adapter import ViTAdapter as JViTAdapter
from vitadapter.utils.checkpoint import convert_detector_checkpoint
from vitadapter.utils.config import Config as JConfig
from vitadapter_torch import builder
from vitadapter_torch.det import single_stage as tss
from vitadapter_torch.det.anchors import multi_level_anchors
from vitadapter_torch.det.necks import FPN
from vitadapter_torch.models.vit_adapter import ViTAdapter
from vitadapter_torch.train.optim import make_optimizer
from vitadapter_torch.train.trainer import TrainState, make_det_train_step
from vitadapter_torch.utils.config import Config
from vitadapter_torch.utils.weights import neck_from_flax, state_dict_from_flax

from torch_port_util import (DET_BACKBONE, DET_HW, assert_close,
                             flax_variables, nms_margin, port_like,
                             randomize_flax, to_np)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4
# one windowed block in one interaction keeps JAX's traces short
BACKBONE = dict(DET_BACKBONE, depth=1, interaction_indexes=((0, 0),),
                window_attn=(True,), window_size=(3,))
# 128 FPN channels: the towers' GroupNorm(32) then takes 4 channels of the
# 1x2 and 1x1 maps of strides 64 and 128 on the 64x96 image (one channel
# over two cells normalizes to about +-1 whatever the inputs, so float
# noise decides the sign)
HEADS = dict(num_classes=4, fpn_channels=128, max_dets=10)
B, G = 2, 4
CONFIGS = {0: "configs/atss/atss_deit_adapter_small_fpn_3x_coco.py",
           16: "configs/gfl/gfl_deit_adapter_small_fpn_3x_coco.py"}
# JAX's `eval_shape` of the two shipped configs (`test_config_parameter_
# count_matches_jax` computes them)
PARAMETERS = {0: 35_661_418, 16: 35_808_938}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores (see test_torch_upernet)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch(seed):
    """Images, gt boxes of 8-38 px in the image, labels and valid flags
    (the last gt of each image invalid)."""
    rs = np.random.RandomState(seed)
    H, W = DET_HW
    xy = rs.rand(B, G, 2) * np.array([W - 40, H - 40])
    wh = rs.rand(B, G, 2) * 30 + 8
    valid = np.ones((B, G), bool)
    valid[:, -1] = False
    return {"image": rs.randn(B, H, W, 3).astype(np.float32),
            "gt_boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
            "gt_labels": rs.randint(0, HEADS["num_classes"], (B, G)
                                    ).astype(np.int32),
            "gt_valid": valid}


def test_fpn_start_level_and_learned_extras_match_jax():
    rs = np.random.RandomState(0)
    feats = [rs.randn(2, h, w, 24).astype(np.float32)
             for h, w in ((16, 24), (8, 12), (4, 6), (2, 3))]
    jm = JFPN(out_channels=32, num_outs=5, start_level=1, extra="on_output")
    p = randomize_flax(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), feats))["params"], 1)
    want = jm.apply({"params": p}, feats)
    port = FPN([24] * 4, 32, num_outs=5, start_level=1, extra="on_output")
    port.load_state_dict(neck_from_flax(p))
    got = port([torch.from_numpy(f) for f in feats])
    assert [tuple(g.shape[1:3]) for g in got] == [(8, 12), (4, 6), (2, 3),
                                                  (1, 2), (1, 1)]
    for g, w in zip(got, want):
        assert_close(g, w, TOL)


def test_group_norm_of_one_value_a_group_matches_flax():
    """A batch of one 1x1 map with one channel a group (the stride-128
    level of a small test image under the towers' GroupNorm(32)): flax
    normalizes each value to 0 and returns the bias, where `F.group_norm`
    refuses the input."""
    import flax.linen as fnn

    from vitadapter_torch.layers.norm import GroupNorm

    x = np.random.RandomState(9).randn(1, 1, 1, 32).astype(np.float32)
    jm = fnn.GroupNorm(num_groups=32, epsilon=1e-5)
    p = randomize_flax(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), x))["params"], 10)
    want = jm.apply({"params": p}, x)
    port = GroupNorm(32, 32)
    port.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                          "bias": torch.from_numpy(p["bias"])})
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy()[0, 0, 0], p["bias"],
                               atol=1e-6)


def anchors_of(hw):
    shapes = [(-(-hw[0] // s), -(-hw[1] // s)) for s in tss.ATSS_STRIDES]
    lvl = multi_level_anchors(shapes, tss.ATSS_STRIDES, scales=(8,),
                              ratios=(1.0,))
    return np.concatenate(lvl), [len(a) for a in lvl]


@pytest.mark.parametrize("case", ["random", "grid_ties"])
def test_atss_assign_matches_jax_exactly(case):
    """Random gts (one invalid), or gts centred between grid anchors, where
    the nearest candidates tie in distance."""
    anchors, n_lvl = anchors_of((128, 192))
    rs = np.random.RandomState(1)
    if case == "random":
        xy = rs.rand(6, 2) * np.array([150, 90])
        gts = np.concatenate([xy, xy + 8 + rs.rand(6, 2) * 60], -1)
    else:
        c = np.array([[16, 16], [40, 24], [64, 64], [96, 32], [120, 80],
                      [32, 96]], np.float64)
        half = np.array([[12, 12], [20, 12], [24, 40], [30, 30], [8, 8],
                         [40, 20]])
        gts = np.concatenate([c - half, c + half], -1)
    gts = gts.astype(np.float32)
    valid = np.ones(6, bool)
    valid[3] = False
    want = np.asarray(jax.jit(jss.atss_assign, static_argnums=1)(
        jnp.asarray(anchors), tuple(n_lvl), jnp.asarray(gts),
        jnp.asarray(valid)))
    got = tss.atss_assign(torch.from_numpy(anchors), n_lvl,
                          torch.from_numpy(gts), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 10 and not (want == 3).any()


def test_losses_and_box_coding_match_jax():
    rs = np.random.RandomState(2)
    N, K, R = 40, 5, 16
    anchors, _ = anchors_of((64, 96))
    anchors = anchors[:N]
    gts = (anchors + rs.randn(N, 4).astype(np.float32) * 4
           + np.array([-20, -20, 20, 20], np.float32))
    logits = rs.randn(N, K).astype(np.float32) * 2
    labels = rs.randint(0, K + 1, N).astype(np.int32)    # K: background
    quality = rs.rand(N).astype(np.float32)
    reg = rs.randn(N, 4 * (R + 1)).astype(np.float32)
    target = (rs.rand(N, 4) * (R + 2) - 1).astype(np.float32)
    deltas = rs.randn(N, 4).astype(np.float32)
    t = lambda *a: [torch.from_numpy(x) for x in a]
    j = lambda *a: [jnp.asarray(x) for x in a]
    pairs = [
        (tss.centerness_target(*t(anchors, gts)),
         jss.centerness_target(*j(anchors, gts))),
        (tss.decode_atss_deltas(*t(anchors, deltas)),
         jss.decode_atss_deltas(*j(anchors, deltas))),
        (tss.gfl_integral(*t(reg), R), jss.gfl_integral(*j(reg), R)),
        (tss.distribution_focal_loss(*t(reg, target), R),
         jss.distribution_focal_loss(*j(reg, target), R)),
        (tss.quality_focal_loss(*t(logits, labels, quality), K),
         jss.quality_focal_loss(*j(logits, labels, quality), K))]
    for i, (g, w) in enumerate(pairs):
        assert_close(g, w, TOL, i)


def jax_stages(m, x):
    """The JAX detector's per-anchor outputs, as `ATSS._outputs`."""
    feats = m.neck(m.backbone(x))
    cls_out, reg_out, ctr_out = m.head(feats)
    anchors = jnp.asarray(np.concatenate(m._anchors(feats)))
    Bx = x.shape[0]
    cls = jnp.concatenate([c.reshape(Bx, -1, m.num_classes)
                           for c in cls_out], 1)
    reg = jnp.concatenate([r.reshape(Bx, -1, r.shape[-1]) for r in reg_out],
                          1)
    ctr = jnp.concatenate([c.reshape(Bx, -1) for c in ctr_out], 1)
    dist = jss.gfl_integral(reg, m.reg_max) if m.reg_max else reg
    boxes = jnp.clip(jss.decode_atss_deltas(anchors[None], dist), 0,
                     jnp.asarray([x.shape[2], x.shape[1]] * 2, jnp.float32))
    return cls, reg, ctr, boxes


def models(reg_max, x, seed):
    """Both detectors on the same random weights, the box regression
    scaled by 0.1: deltas (or bin logits) of order 1, as a trained head
    gives them (random ones of order 10 clip most boxes to the whole
    image, where equal boxes leave the NMS to float noise)."""
    jm = jss.ATSS(backbone=JViTAdapter(**BACKBONE), reg_max=reg_max,
                  **HEADS)
    v = flax_variables(jm, x, seed)
    reg = v["params"]["head"]["atss_reg"]
    reg["kernel"] = reg["kernel"] * 0.1
    port = port_like(tss.ATSS(ViTAdapter(**BACKBONE, device="meta"),
                              reg_max=reg_max, device="meta", **HEADS), v)
    return jm, v, port


@pytest.mark.parametrize("reg_max", [0, 16])
def test_detector_outputs_and_detections_match_jax(reg_max):
    x = np.random.RandomState(3).randn(B, *DET_HW, 3).astype(np.float32)
    jm, v, port = models(reg_max, x, 4)
    want, dets = jax.jit(lambda v, x: (jm.apply(v, x, method=jax_stages),
                                       jm.apply(v, x)))(v, x)
    with torch.no_grad():
        _, _, *got = port._outputs(torch.from_numpy(x))
        out = port(torch.from_numpy(x))
    for name, g, w in zip(("cls", "reg", "ctr", "boxes"), got, want):
        assert_close(g, w, TOL, name)
    # the NMS decisions are clear of the float noise between the sides:
    # overlapping candidates' scores and the 0.05 cut apart by more than
    # the largest score difference
    def scores(cls, ctr):
        s = 1 / (1 + np.exp(-np.asarray(cls, np.float64)))
        if not reg_max:
            s = s * (1 / (1 + np.exp(-np.asarray(ctr, np.float64))))[..., None]
        return s

    s_got = scores(to_np(got[0]), to_np(got[2]))
    noise = np.abs(s_got - scores(want[0], want[2])).max()
    boxes = to_np(got[3])
    for b in range(B):
        a, k = np.nonzero(s_got[b] > 0.05)
        off = k[:, None] * (boxes[b].max() + 1.0)
        iou_gap, score_gap = nms_margin(boxes[b][a] + off, s_got[b][a, k],
                                        0.6)
        assert iou_gap > 1e-5 and score_gap > noise, (iou_gap, score_gap,
                                                      noise)
        assert np.abs(s_got[b] - 0.05).min() > noise
    fin = np.isfinite(np.asarray(dets["scores"]))
    assert fin.sum() > 5
    np.testing.assert_array_equal(np.isfinite(to_np(out["scores"])), fin)
    np.testing.assert_array_equal(out["labels"].numpy(),
                                  np.asarray(dets["labels"]))
    assert_close(out["scores"].numpy()[fin], np.asarray(dets["scores"])[fin],
                 TOL)
    assert_close(out["boxes"], dets["boxes"], TOL)


@pytest.mark.parametrize("reg_max", [0, 16])
def test_train_step_losses_and_grad_norm_match_jax(reg_max):
    """One `make_det_train_step` (train mode: BatchNorm on batch
    statistics) against JAX's `value_and_grad`: each loss and the float64
    gradient norm within 2e-4 relative; the level the FPN drops (stride 4)
    takes a zero gradient, as JAX gives it."""
    data = batch(5)
    jm, v, port = models(reg_max, data["image"], 6)

    def loss_fn(params):
        losses, _ = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            data["image"], train=True, gt_boxes=data["gt_boxes"],
            gt_labels=data["gt_labels"], gt_valid=data["gt_valid"],
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(4)})
        return losses["loss"], losses

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    want_norm = np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum()
                            for g in jax.tree_util.tree_leaves(grads)))
    optimizer, _ = make_optimizer(port, base_lr=0.0, weight_decay=0.0,
                                  depth=1, total_steps=10, warmup_steps=0)
    b = {k: torch.from_numpy(x) for k, x in data.items()}
    b["gt_labels"] = b["gt_labels"].long()
    _, logs = make_det_train_step(port)(TrainState.create(port, optimizer),
                                        b, torch.Generator().manual_seed(0))
    got_norm = float(torch.sqrt(sum(p.grad.double().square().sum()
                                    for p in port.parameters())))
    names = ({"loss_cls", "loss_bbox", "loss_dfl"} if reg_max
             else {"loss_cls", "loss_bbox", "loss_centerness"})
    assert set(want) == set(logs) - {"grad_norm"} == names | {"loss"}
    for k in want:
        assert abs(float(logs[k]) - float(want[k])) <= TOL * abs(
            float(want[k])), (k, float(logs[k]), float(want[k]))
        assert float(want[k]) > 0
    assert abs(got_norm - want_norm) <= TOL * want_norm, (got_norm,
                                                          want_norm)
    assert not port.backbone.up.weight.grad.any()


@pytest.mark.parametrize("reg_max", [0, 16])
def test_converter_round_trip_through_jax(reg_max):
    """The port's `state_dict()` (mmdet's keys: `bbox_head.{atss,gfl}_cls`,
    `neck.fpn_convs.3` / `.4` the learned extras, ...) read by JAX's
    `convert_detector_checkpoint` gives back the flax tree it came from."""
    x = np.zeros((1, 64, 64, 3), np.float32)
    jm, v, port = models(reg_max, x, 7)
    sd = {k: t.numpy() for k, t in port.state_dict().items()}
    fam = "gfl" if reg_max else "atss"
    assert f"bbox_head.{fam}_cls.weight" in sd
    assert "neck.fpn_convs.4.conv.weight" in sd
    assert "bbox_head.scales.4.scale" in sd
    back = convert_detector_checkpoint(
        {k: torch.from_numpy(a) for k, a in sd.items()})["params"]
    flat_w = jax.tree_util.tree_flatten_with_path(v["params"])[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_b) == len(flat_w)
    for path, leaf in flat_w:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf))
    assert set(state_dict_from_flax(v["params"], v["batch_stats"])) <= set(
        sd)


@pytest.mark.parametrize("reg_max", [0, 16])
def test_config_parameter_count_matches_jax(reg_max):
    """The shipped config (DeiT-S adapter, bf16, 1024 canvas) builds on the
    meta device with JAX's parameter count."""
    path = os.path.join(ROOT, CONFIGS[reg_max])
    model = builder.build(dict(Config.fromfile(path).model))
    assert isinstance(model, tss.ATSS) and model.reg_max == reg_max
    got = sum(p.numel() for p in model.parameters())
    jm = jbuild_model(dict(JConfig.fromfile(path).model))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3),
                                                 np.float32))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert got == want == PARAMETERS[reg_max]
