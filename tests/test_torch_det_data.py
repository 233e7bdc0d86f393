"""The port's detection data and evaluation (`vitadapter_torch/data/coco.py`,
the `det_*` transforms of `data/transforms.py`, `det/coco_eval.py`,
`det/mask_utils.py` and the host side of `train/det_loop.py`) against the
JAX package, on the CPU. All of it is numpy and PIL on both sides, so the
results are held equal: datasets, batches, masks and RLE strings
bitwise, the evaluator's summaries exactly (NaN where JAX has NaN). The
JAX side decodes and encodes RLE and takes mask IoUs with its native
codec (`native/rle.cpp`) where it is built; the port with the numpy
one."""

import os

import numpy as np
import pytest

from vitadapter.data import coco as jcoco
from vitadapter.data import transforms as jT
from vitadapter.det import coco_eval as jeval
from vitadapter.det import mask_utils as jmask
from vitadapter.train import det_loop as jloop
from vitadapter_torch.data import coco as tcoco
from vitadapter_torch.data import transforms as tT
from vitadapter_torch.det import coco_eval as teval
from vitadapter_torch.det import mask_utils as tmask
from vitadapter_torch.train import det_loop as tloop

from torch_port_util import write_coco

SIZES = ((60, 90), (90, 70), (64, 64), (50, 80))


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    return root, write_coco(root, SIZES, seed=1)


def assert_equal_trees(got, want):
    assert type(got) is type(want) or isinstance(got, np.ndarray), (
        type(got), type(want))
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_equal_trees(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_rle_codec_matches_jax():
    """Encoded strings equal JAX's (native codec), and each side decodes
    the other's, on random, empty, full and one-pixel masks; the
    uncompressed list form too."""
    rs = np.random.RandomState(2)
    masks = [rs.rand(17, 23) > 0.5, np.zeros((5, 7), bool),
             np.ones((6, 4), bool), np.eye(9, 11, dtype=bool)]
    masks.append((rs.rand(40, 30) > 0.95).astype(np.uint8))
    for m in masks:
        got = tcoco.encode_rle(m)
        want = jcoco.encode_rle(m)
        assert got == want
        np.testing.assert_array_equal(
            tcoco.decode_rle(want["counts"], want["size"]), m.astype(
                np.uint8))
        np.testing.assert_array_equal(
            tcoco.decode_rle(got["counts"].encode("ascii"), got["size"]),
            jcoco.decode_rle(got["counts"], got["size"]))
    runs = [3, 4, 0, 5, 100]
    np.testing.assert_array_equal(tcoco.decode_rle(runs, [8, 14]),
                                  jcoco.decode_rle(runs, [8, 14]))


@pytest.mark.parametrize("with_masks", [True, False])
def test_coco_dataset_matches_jax(coco, with_masks):
    """Categories, the kept images (the one without annotations left out),
    and every loaded image and target: boxes, labels, crowd flags,
    annotation areas and masks (polygons rasterized, RLE decoded; the
    ignored and the sub-pixel annotations dropped)."""
    root, paths = coco
    img_dir = os.path.join(root, "val2017")
    got = tcoco.CocoDataset(paths["val"], img_dir, with_masks=with_masks)
    want = jcoco.CocoDataset(paths["val"], img_dir, with_masks=with_masks)
    assert len(got) == len(want) == len(SIZES) - 1
    assert got.ids == want.ids and got.num_classes == want.num_classes == 3
    assert got.label_to_cat == want.label_to_cat
    for i in range(len(got)):
        (gi, gt), (wi, wt) = got.load(i), want.load(i)
        np.testing.assert_array_equal(gi, wi)
        assert_equal_trees(gt, wt)
        assert len(gt["labels"]) == 4 and gt["iscrowd"].sum() == i % 2
        if with_masks:
            assert gt["masks"].sum() > 0


def test_pad_targets_matches_jax(coco):
    root, paths = coco
    ds = tcoco.CocoDataset(paths["val"], os.path.join(root, "val2017"))
    _, t = ds.load(1)
    for budget in (2, 4, 7):
        assert_equal_trees(tcoco.pad_targets(t, budget),
                           jcoco.pad_targets(t, budget))


@pytest.mark.parametrize("autoaug,photometric", [(True, False),
                                                 (False, True)])
def test_det_train_transform_matches_jax(coco, autoaug, photometric):
    """The whole det train transform on the same RandomState: flip,
    AutoAugment's two policies (or one resize), the crop to the canvas,
    photometric distortion, the padding and the kept boxes."""
    root, paths = coco
    ds = tcoco.CocoDataset(paths["val"], os.path.join(root, "val2017"))
    for seed in range(4):
        img, t = ds.load(seed % len(ds))
        args = (img, t["boxes"], t["masks"], (48, 64))
        kw = dict(autoaug=autoaug, photometric=photometric, max_long=120,
                  scales=(40, 56, 72), scales_small=(30, 45),
                  crop_range=(20, 40))
        got = tT.det_train_transform(np.random.RandomState(seed), *args, **kw)
        want = jT.det_train_transform(np.random.RandomState(seed), *args,
                                      **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("autoaug", [True, False])
def test_det_train_batches_match_jax(coco, autoaug):
    """Three batches of two from the train split, one seed: images, boxes,
    labels, valid flags and bool masks equal JAX's."""
    root, _ = coco
    data_cfg = {"dataset_type": "CocoDataset", "data_root": root,
                "train": {"ann_file": "annotations/instances_train2017.json",
                          "img_dir": "train2017"},
                "crop_size": (48, 64), "max_instances": 6,
                "autoaug": autoaug, "max_long_edge": 120,
                "det_scales": (40, 56, 72), "det_scales_small": (30, 45),
                "det_crop_range": (20, 40)}
    got_ds = tloop.build_det_dataset(data_cfg, "train")
    want_ds = jloop.build_det_dataset(data_cfg, "train")
    got = tloop.det_train_batches(got_ds, data_cfg, 2, seed=3)
    want = jloop.det_train_batches(want_ds, data_cfg, 2, seed=3)
    for _ in range(3):
        g, w = next(got), next(want)
        assert_equal_trees(g, w)
        assert g["gt_masks"].dtype == bool and g["gt_valid"].any()


def _eval_records(seed, iou_type):
    """Detections and gts of 4 images, 3 classes: detections near the gts
    and some off, random scores (some tied, some -inf), one crowd gt, one
    invalid gt, annotation areas of all three area ranges; masks as
    boxes filled."""
    rs = np.random.RandomState(seed)
    H = W = 160
    out = []
    for i in range(4):
        G = 6
        xy = rs.rand(G, 2) * 100
        wh = np.exp(rs.uniform(np.log(4), np.log(60), (G, 1))) * \
            rs.uniform(0.7, 1.3, (G, 2))
        gb = np.concatenate([xy, xy + wh], 1)
        gts = {"boxes": gb, "labels": rs.randint(0, 3, G),
               "iscrowd": np.arange(G) == (i % G),
               "valid": np.arange(G) != 4,
               "area": np.prod(wh, 1) * rs.uniform(0.6, 1.0, G)}
        D = 12
        src = rs.randint(0, G, D)
        db = gb[src] + rs.randn(D, 4) * rs.choice([1.0, 6.0, 30.0], (D, 1))
        db[:, 2:] = np.maximum(db[:, 2:], db[:, :2] + 1)
        scores = np.round(rs.rand(D), 1)
        scores[D - 1] = -np.inf
        labels = np.where(rs.rand(D) < 0.8, gts["labels"][src],
                          rs.randint(0, 3, D))
        dets = {"boxes": db, "scores": scores, "labels": labels}
        if iou_type == "segm":
            def fill(b):
                m = np.zeros((len(b), H, W), bool)
                for k, (x1, y1, x2, y2) in enumerate(np.clip(b, 0, W)):
                    m[k, int(y1):int(np.ceil(y2)), int(x1):int(np.ceil(x2))] \
                        = True
                return m
            dets["masks"] = fill(db)
            gts["masks"] = fill(gb)
        out.append((dets, gts))
    return out


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_coco_evaluator_summary_matches_jax(iou_type):
    got = teval.COCOEvaluator(3, iou_type=iou_type)
    want = jeval.COCOEvaluator(3, iou_type=iou_type)
    for dets, gts in _eval_records(4, iou_type):
        got.add_image(dets, gts)
        want.add_image(dets, gts)
    g, w = got.summarize(), want.summarize()
    assert list(g) == list(w)
    for k in w:
        assert (g[k] == w[k]) or (np.isnan(g[k]) and np.isnan(w[k])), k
    assert 0 < g[f"{iou_type}_mAP"] < 1


def test_mask_utils_match_jax():
    rs = np.random.RandomState(5)
    masks = rs.rand(4, 20, 30) > 0.7
    masks[2] = False
    np.testing.assert_array_equal(tmask.mask2bbox(masks),
                                  jmask.mask2bbox(masks))
    assert tmask.encode_mask_results(masks) == \
        jmask.encode_mask_results(masks)


def test_det_eval_host_steps_match_jax(coco):
    """The test path's host steps: the canvases, the keep-ratio resize and
    pad (both orientations, flipped and not), the detections mapped back
    (boxes in the padding zeroed) and the pasted masks."""
    root, paths = coco
    ds = tcoco.CocoDataset(paths["val"], os.path.join(root, "val2017"))
    assert tloop.test_canvas((1333, 800)) == jloop.test_canvas((1333, 800))
    rs = np.random.RandomState(6)
    for i in range(len(ds)):
        img, _ = ds.load(i)
        for flip in (False, True):
            got = tloop._prep_one_aug(img, (120, 72), flip)
            want = jloop._prep_one_aug(img, (120, 72), flip)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
            rh, rw = got[1][:2]
            boxes = np.concatenate([rs.rand(8, 2) * [rw + 20, rh + 20],
                                    rs.rand(8, 2) * 30], 1)
            boxes[:, 2:] += boxes[:, :2]
            dets = {"boxes": boxes.astype(np.float32),
                    "scores": rs.rand(8).astype(np.float32),
                    "masks": rs.rand(8, 28, 28).astype(np.float32)}
            g = tloop._map_back_one_aug({k: v.copy() for k, v in
                                         dets.items()}, got[1])
            w = jloop._map_back_one_aug({k: v.copy() for k, v in
                                         dets.items()}, want[1])
            assert_equal_trees(g, w)
            np.testing.assert_array_equal(
                tloop.paste_mask_crops(g, *img.shape[:2]),
                jloop.paste_mask_crops(w, *img.shape[:2]))


def test_synthetic_det_batches():
    """The synthetic stream: the JAX loop's boxes, labels and images from
    seed 0, bool masks with about half their pixels set."""
    b = next(tloop.synthetic_det_batches(2, (32, 48), 5, 80))
    assert b["image"].shape == (2, 32, 48, 3) and b["image"].dtype == \
        np.float32
    assert b["gt_boxes"].shape == (2, 5, 4) and b["gt_labels"].max() < 80
    assert b["gt_masks"].shape == (2, 5, 32, 48)
    assert b["gt_masks"].dtype == bool
    assert 0.45 < b["gt_masks"].mean() < 0.55
    rng = np.random.RandomState(0)
    xy = rng.rand(2, 5, 2) * 16
    wh = rng.rand(2, 5, 2) * 32 + 8
    np.testing.assert_array_equal(
        b["gt_boxes"], np.concatenate([xy, xy + wh], -1).astype(np.float32))
