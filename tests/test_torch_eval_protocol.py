"""The port's evaluation protocol against the JAX package's, on the CPU:
`vitadapter_torch/models/seg_protocol.py` and `data/metrics.py` against
their JAX twins, and `train/loop.py::run_eval` against the JAX `run_eval`
on the tiny Mask2Former (fp32), odd-sized non-square images, whole and
slide mode, with and without multi-scale + flip: the confusion matrices
must be identical, as `tests/test_seg_protocol.py` asserts for its torch
composite."""

import numpy as np
import pytest
import torch

import vitadapter.train.loop as jloop
from vitadapter.data import metrics as jmetrics
from vitadapter.models import seg_protocol as JSP
from vitadapter.utils.checkpoint import (convert_mask2former_head,
                                         convert_vit_adapter_backbone)
from vitadapter.utils.config import Config
from vitadapter_torch.data import metrics as tmetrics
from vitadapter_torch.heads.mask2former import Mask2FormerHead
from vitadapter_torch.models import seg_protocol as TSP
from vitadapter_torch.models.mask2former_segmentor import \
    EncoderDecoderMask2Former
from vitadapter_torch.models.vit_adapter import ViTAdapter
from vitadapter_torch.train import loop as tloop
from vitadapter_torch.utils.weights import load_flax

from torch_port_util import TINY_TRAIN_BACKBONE, TINY_TRAIN_HEAD, randomize

# the tiny model cut to 2 blocks and 2 decoder layers, which keeps JAX's
# compiles short; one crop per model call keeps JAX's padded chunks small
BACKBONE, HEAD = TINY_TRAIN_BACKBONE, TINY_TRAIN_HEAD
K = HEAD["num_classes"]
# (long, short): every image keeps one scaled shape at both ratios, so the
# JAX side compiles one model program per image shape
IMG_SCALE = (96, 64)
CROP = (64, 64)
STRIDE = (48, 48)
RATIOS = [0.75, 1.0]


# --- the numpy helpers and the metrics -------------------------------------

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make the small eager ops here many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("hw", [(97, 151), (151, 97), (30, 200), (512, 683)])
def test_seg_protocol_helpers_match_jax(hw):
    ho, wo = hw
    for scale in ((128, 96), (2048, 512), (2048, 1024)):
        assert TSP.rescale_size(ho, wo, scale) == JSP.rescale_size(ho, wo,
                                                                   scale)
        for r in (0.5, 0.75, 1.0, 1.5):
            assert TSP.variant_plan(ho, wo, scale, r) == JSP.variant_plan(
                ho, wo, scale, r)
    assert TSP.to_multiple(ho, wo, 32) == JSP.to_multiple(ho, wo, 32)
    img = np.random.RandomState(ho).randint(0, 256, (ho, wo, 3)
                                            ).astype(np.uint8)
    (h1, w1), (h2, w2) = JSP.variant_plan(ho, wo, IMG_SCALE, 0.75)
    for fl in (False, True):
        np.testing.assert_array_equal(
            TSP.prepare_variant_image(img, (h1, w1), (h2, w2), fl),
            JSP.prepare_variant_image(img, (h1, w1), (h2, w2), fl))
        # JAX pads the matrices to shape buckets with zero rows; the port
        # does not, so pad its matrices to the same buckets here
        for got, want in zip(TSP.ori_matrices(h2, w2, ho, wo, fl),
                             JSP.ori_matrices(h2, w2, ho, wo, 640, 768, fl)):
            assert got.dtype == want.dtype
            padded = np.zeros_like(want)
            padded[:got.shape[0]] = got
            np.testing.assert_array_equal(padded, want)
    plan = TSP.slide_plan(h2, w2, CROP, STRIDE)
    assert plan == JSP.slide_plan(h2, w2, CROP, STRIDE)
    assert TSP.slide_grid(wo, 64, 48) == JSP.slide_grid(wo, 64, 48)
    np.testing.assert_array_equal(TSP.count_map(h2, w2, *plan),
                                  JSP.count_map(h2, w2, *plan))
    x = TSP.prepare_variant_image(img, (h1, w1), (h2, w2), False)
    np.testing.assert_array_equal(TSP.extract_crops(x, *plan),
                                  JSP.extract_crops(x, *plan))


def test_metrics_match_jax():
    rng = np.random.RandomState(0)
    pred = rng.randint(0, K, (37, 53))
    label = rng.randint(0, K, (37, 53))
    label[rng.rand(37, 53) < 0.2] = 255
    want = np.asarray(jmetrics.confusion_matrix(pred, label, K))
    got = tmetrics.confusion_matrix(torch.from_numpy(pred),
                                    torch.from_numpy(label), K)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int((label != 255).sum())
    cm = want.copy()
    cm[3] = 0                                      # a class absent
    assert tmetrics.miou_from_confusion(cm) == jmetrics.miou_from_confusion(cm)


# --- run_eval on the tiny Mask2Former --------------------------------------

# one odd-sized non-square image per mode, which keeps JAX's compiles few:
# a portrait one in whole mode, and in slide mode a landscape one that is
# smaller than the crop in H after the keep-ratio resize (the reference's
# small-patch branch) and takes two overlapping windows in W
SIZES = {"whole": (151, 97), "slide": (30, 200)}


class OddSizeDS:
    def __init__(self, size):
        rng = np.random.RandomState(3)
        self.items = [(rng.randint(0, 256, (*size, 3)).astype(np.uint8),
                       rng.randint(0, K, size).astype(np.int32))]
        self.items[0][1][:5, :7] = 255        # ignored pixels

    def __len__(self):
        return len(self.items)

    def load(self, i):
        return self.items[i]


@pytest.fixture(scope="module")
def tiny_m2f():
    """The port's tiny Mask2Former and the same weights as JAX variables."""
    model = EncoderDecoderMask2Former(
        ViTAdapter(**BACKBONE),
        Mask2FormerHead([BACKBONE["embed_dim"]] * 4, **HEAD))
    randomize(model, 31)
    sd = model.state_dict()
    pb, sb = convert_vit_adapter_backbone(sd, "backbone.")
    ph, _ = convert_mask2former_head(sd, "decode_head.")
    params, stats = {"backbone": pb, "decode_head": ph}, {"backbone": sb}
    load_flax(model, params, stats)
    return model.eval(), {"params": params, "batch_stats": stats}


def _test_cfg(mode):
    cfg = {"mode": mode, "crops_per_device": 1}
    if mode == "slide":
        cfg.update(crop_size=list(CROP), stride=list(STRIDE))
    return cfg


@pytest.mark.parametrize("mode", ["whole", "slide"])
@pytest.mark.parametrize("aug", [False, True])
def test_run_eval_matches_jax(tiny_m2f, monkeypatch, mode, aug):
    model, variables = tiny_m2f
    ds = OddSizeDS(SIZES[mode])
    jcfg = Config({
        "model": {"type": "EncoderDecoderMask2Former",
                  "backbone": {"type": "ViTAdapter", **BACKBONE},
                  "decode_head": {"type": "Mask2FormerHead", **HEAD}},
        "data": {"scale": list(IMG_SCALE)},
        "test_cfg": _test_cfg(mode),
        "aug_test": {"img_ratios": RATIOS, "flip": True},
    })
    seen = {}
    orig = jloop.miou_from_confusion

    def spy(cm):
        seen["cm"] = np.array(cm)
        return orig(cm)

    monkeypatch.setattr(jloop, "miou_from_confusion", spy)
    want = jloop.run_eval(jcfg, variables, ds, aug_test=aug,
                          log_fn=lambda *_: None)
    cfg = {"num_classes": K, "data": {"scale": list(IMG_SCALE)},
           "test_cfg": _test_cfg(mode),
           "aug_test": {"img_ratios": RATIOS, "flip": True}}
    lines = []
    got = tloop.run_eval(cfg, model, ds, aug_test=aug, log_fn=lines.append)
    np.testing.assert_array_equal(got["confusion"], seen["cm"])
    assert got["confusion"].sum() == sum(int((s != 255).sum())
                                         for _, s in ds.items)
    for k in ("aAcc", "mIoU", "mAcc"):
        assert got[k] == want[k]
    assert lines[-1].startswith("aAcc ")
    assert not model.training
