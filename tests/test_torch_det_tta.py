"""The port's merge of augmented detections (`det/cascade.py::
remove_boxes_by_scale`, `soft_nms`, `merge_aug_detections`) against the JAX
package's on the same numpy inputs, exactly; and `run_det_eval
--aug-test` (`train/det_loop.py`) on a tiny Cascade Mask R-CNN, against
the merge of the port's own per-aug outputs put through the same COCO
evaluator: every `tta` scale with and without the flip, each aug gated
by its scale's range (the (scale, flip) order's `ranges[i // 2]`)."""

import numpy as np
import pytest
import torch

from vitadapter.det import cascade as jc
from vitadapter_torch.builder import build_model
from vitadapter_torch.data.preprocess import normalize
from vitadapter_torch.det import cascade as tc
from vitadapter_torch.det.coco_eval import COCOEvaluator
from vitadapter_torch.train import det_loop
from vitadapter_torch.utils.config import Config

from torch_port_util import write_coco


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores (see test_torch_upernet)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_dets(rs, n, classes=3, masks=True, spread=300.0):
    """n detections: boxes of 3-202 px anywhere in a `spread` square, some
    pairs heavily overlapping, random scores (a few -inf pads) and
    labels, and 28x28 mask crops."""
    xy = rs.rand(n, 2) * spread
    wh = np.exp(rs.rand(n, 2) * np.log(200.0)) + 2
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    dup = rs.rand(n) < 0.3
    boxes[dup] = boxes[0] + rs.randn(int(dup.sum()), 4).astype(np.float32)
    scores = rs.rand(n).astype(np.float32)
    scores[rs.rand(n) < 0.1] = -np.inf
    out = {"boxes": boxes, "scores": scores,
           "labels": rs.randint(0, classes, n).astype(np.int64)}
    if masks:
        out["masks"] = rs.rand(n, 28, 28).astype(np.float32)
    return out


def assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("bands", [["s"], ["m"], ["m-"], ["m+"], ["l"],
                                   ["l-"], ["l+"], ["s", "m"], ["m", "l"],
                                   ["m-", "l+"]])
def test_remove_boxes_by_scale_matches_jax(bands):
    d = random_dets(np.random.RandomState(1), 200, spread=600.0)
    # areas exactly on the bands' boundaries
    edges = np.asarray([[0, 0, e, e] for e in (32, 64, 96, 512, 700)],
                       np.float32)
    boxes = np.concatenate([d["boxes"], edges])
    got = tc.remove_boxes_by_scale(boxes, bands)
    np.testing.assert_array_equal(got, jc.remove_boxes_by_scale(boxes,
                                                                 bands))
    assert 0 < got.sum() < len(boxes)


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_soft_nms_matches_jax(seed):
    """The port's Gaussian soft-NMS against JAX's at the reference merge's
    settings (IoU 0.5, sigma 0.5, score threshold 1e-3)."""
    d = random_dets(np.random.RandomState(seed), 120, masks=False)
    fin = np.isfinite(d["scores"])
    args = (d["boxes"][fin], d["scores"][fin])
    got = tc.soft_nms(*args)
    want = jc.soft_nms(*args, 0.5, sigma=0.5, score_thr=1e-3,
                       method="gaussian")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0 < len(got[0]) <= fin.sum()


@pytest.mark.parametrize("ranges", [
    [["l"], ["l"], ["m", "l"], ["m", "l"], ["s", "m"], ["s", "m"]],
    [["s", "m", "l"]] * 6,
    [["s"], ["s"], ["m-"], ["m+"], ["l-"], ["l+"]]])
def test_merge_aug_detections_matches_jax(ranges):
    rs = np.random.RandomState(5)
    per_aug = [random_dets(rs, 60) for _ in range(6)]
    got = tc.merge_aug_detections(per_aug, scale_ranges=ranges, max_dets=40)
    want = jc.merge_aug_detections(per_aug, scale_ranges=ranges,
                                   iou_thr=0.5, max_dets=40)
    assert_same(got, want)
    assert len(got["boxes"]) == 40


TINY = "configs/htc/htc++_augreg_adapter_large_fpn_3x_coco_ms.py"
OPTIONS = {
    "model.backbone.depth": 2, "model.backbone.embed_dim": 48,
    "model.backbone.num_heads": 4, "model.backbone.deform_num_heads": 4,
    "model.backbone.conv_inplane": 16,
    "model.backbone.interaction_indexes": [[0, 0], [1, 1]],
    "model.backbone.window_attn": [True, False],
    "model.backbone.window_size": [3, None], "model.fpn_channels": 32,
    "model.num_classes": 3, "model.num_proposals": 50,
    "model.num_roi_samples": 16, "model.max_dets": 10,
    "test_cfg.img_scale": [112, 64], "test_cfg.images_per_device": 2,
    "tta.scales": [[64, 96], [96, 128], [48, 64]],
    "tta.scale_ranges": [["l"], ["m", "l"], ["s", "m"]],
    "tta.max_per_img": 12}


def test_run_det_eval_aug_test_is_the_merge_of_its_augs(tmp_path):
    """`run_det_eval(aug_test=True)` on the tiny HTC++ (`_ms` config cut
    to size): 3 scales x flip an image; the metrics equal those of the
    port's own per-aug detections, each mapped back to the image and
    gated by its scale's range, merged and pasted by hand."""
    write_coco(str(tmp_path), ((60, 90), (90, 70), (64, 64)), seed=2)
    cfg = Config.fromfile(TINY)
    cfg.merge_from_options({**OPTIONS, "data.data_root": str(tmp_path)})
    model = build_model(dict(cfg.model), device="cpu",
                        generator=torch.Generator().manual_seed(3))
    # score layers spread, so that the merge sees detections above 0.05
    with torch.no_grad():
        for head in model.roi_head.bbox_head:
            head.fc_cls.weight.mul_(30.0)
    ds = det_loop.build_det_dataset(cfg.data, "val")
    got = det_loop.run_det_eval(cfg, model, ds, ("bbox", "segm"),
                                aug_test=True, log_fn=lambda *_: None)
    assert got["timing"]["augs"] == 6

    evaluators = {t: COCOEvaluator(ds.num_classes, iou_type=t)
                  for t in ("bbox", "segm")}
    ranges = cfg.tta["scale_ranges"]
    n_dets = 0
    for i in range(len(ds)):
        img, gts = ds.load(i)
        per_aug = []
        for scale in cfg.tta["scales"]:
            for flip in (False, True):
                x, meta = det_loop._prep_one_aug(img, tuple(scale), flip)
                with torch.no_grad():
                    out = model(normalize(torch.from_numpy(x[None])))
                per_aug.append(det_loop._map_back_one_aug(
                    {k: v[0].numpy().copy() for k, v in out.items()}, meta))
        dets = tc.merge_aug_detections(
            per_aug, [ranges[a // 2] for a in range(len(per_aug))],
            max_dets=12)
        n_dets += len(dets["boxes"])
        dets["masks"] = det_loop.paste_mask_crops(dets, *img.shape[:2])
        for ev in evaluators.values():
            ev.add_image(dets, gts)
    want = {}
    for ev in evaluators.values():
        want.update(ev.summarize())
    assert n_dets > 0
    for k, v in want.items():
        assert got[k] == v or (np.isnan(got[k]) and np.isnan(v)), k
