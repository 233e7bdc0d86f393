"""The port's panoptic path against the JAX package on the CPU:
`heads/panoptic.py::panoptic_fuse` and `instance_postprocess` exactly;
`det/panoptic_eval.py::PQEvaluator` and `data/coco.py::
CocoPanopticDataset` equal to JAX's on a tiny COCO-panoptic dataset the
test writes (RGB-encoded segment PNGs, a crowd segment and void pixels);
`train/det_loop.py::run_panoptic_eval` and `tools.test --eval PQ` on the
panoptic config cut to a tiny BEiT-Adapter + Mask2Former against JAX's
`run_panoptic_eval` on the same weights; `--aug-test` refused for PQ; and
the behaviour both packages share: the panoptic config's
`data.dataset_type="CocoDataset"` is not a segmentation dataset, so it
trains on `--synthetic-data` only (`KeyError` otherwise)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vitadapter.data.coco import CocoPanopticDataset as JDataset
from vitadapter.det.panoptic_eval import PQEvaluator as JPQEvaluator
from vitadapter.heads import panoptic as jpan
from vitadapter.train import loop as jloop
from vitadapter.train.det_loop import run_panoptic_eval as jrun
from vitadapter.utils.checkpoint import convert_segmentor_checkpoint
from vitadapter.utils.config import Config as JConfig
from vitadapter_torch import builder
from vitadapter_torch.builder import build_model
from vitadapter_torch.data.coco import CocoPanopticDataset
from vitadapter_torch.det.panoptic_eval import PQEvaluator
from vitadapter_torch.heads import panoptic as tpan
from vitadapter_torch.heads.mask2former import Mask2FormerHead
from vitadapter_torch.tools import test as test_cli
from vitadapter_torch.train.det_loop import (build_panoptic_dataset,
                                             run_panoptic_eval)
from vitadapter_torch.train.loop import run_training
from vitadapter_torch.utils.config import Config, parse_cfg_options

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = ("configs/mask2former/mask2former_beitv2_adapter_large_16x1_3x_"
          "coco-panoptic.py")
# JAX's `eval_shape` of the shipped config
PARAMETERS = 572_189_254
THINGS, STUFF = (1, 2, 5), (7, 9)
# the panoptic config cut to a tiny BEiT-Adapter and Mask2Former head on
# 128 px (BEiT's tables span img_size / 16: the 128 pad bucket), 3 thing
# and 2 stuff classes, every query kept (object_mask_thr 0) so that the
# random weights give segments
TINY = ["model.backbone.depth=2", "model.backbone.embed_dim=48",
        "model.backbone.num_heads=4", "model.backbone.deform_num_heads=4",
        "model.backbone.conv_inplane=16", "model.backbone.img_size=128",
        "model.backbone.interaction_indexes=[[0,0],[1,1]]",
        "model.decode_head.num_classes=5", "model.decode_head.num_queries=8",
        "model.decode_head.feat_channels=32",
        "model.decode_head.out_channels=32", "model.decode_head.num_heads=4",
        "model.decode_head.num_decoder_layers=2",
        "model.decode_head.decoder_ffn_dim=64",
        "model.decode_head.pixel_encoder_ffn_dim=64",
        "model.decode_head.pixel_encoder_heads=4", "panoptic.num_things=3",
        "panoptic.num_stuff=2", "panoptic.object_mask_thr=0.0",
        "data.crop_size=[128,128]", "test_cfg.images_per_device=2"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores (see test_torch_upernet)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_coco_panoptic(root, sizes, seed=0):
    """A COCO-panoptic `val2017` split under `root`: random images; each
    segment PNG (in `annotations/panoptic_val2017/`, the JSON's stem)
    encodes segment ids as R + 256 G + 65536 B, 0 void: two instances of
    thing categories, two stuff regions, one crowd segment (void in the
    dataset) and a void band. Returns the JSON's path."""
    rs = np.random.RandomState(seed)
    img_dir = os.path.join(root, "val2017")
    seg_dir = os.path.join(root, "annotations", "panoptic_val2017")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(seg_dir, exist_ok=True)
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        name = f"{i:012d}"
        Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
            os.path.join(img_dir, name + ".jpg"))
        ids = np.zeros((h, w), np.int64)
        segs = []
        regions = [(THINGS[i % 3], 0, 0, h // 2, w // 2, 0),
                   (THINGS[(i + 1) % 3], h // 3, w // 3, h - 4, w - 6, 0),
                   (STUFF[0], h // 2, 0, h, w // 3, 0),
                   (STUFF[1], 0, w // 2, h // 3, w, 0),
                   (THINGS[2], h - 8, w - 10, h, w, 1)]
        for k, (cat, y0, x0, y1, x1, crowd) in enumerate(regions):
            sid = 1 + k * 70000 + i * 300      # ids use the G and B bytes
            ids[y0:y1, x0:x1] = sid
            segs.append({"id": sid, "category_id": cat, "iscrowd": crowd})
        ids[:, :3] = 0                          # a void band
        rgb = np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1)
        Image.fromarray(rgb.astype(np.uint8)).save(
            os.path.join(seg_dir, name + ".png"))
        images.append({"id": i + 1, "file_name": name + ".jpg",
                       "height": h, "width": w})
        anns.append({"image_id": i + 1, "file_name": name + ".png",
                     "segments_info": segs})
    cats = ([{"id": c, "name": f"t{c}", "isthing": 1} for c in THINGS]
            + [{"id": c, "name": f"s{c}", "isthing": 0} for c in STUFF])
    path = os.path.join(root, "annotations", "panoptic_val2017.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": cats}, f)
    return path


def fuse_inputs(seed, Q=12, K=5, H=32, W=40):
    """Class logits with some confident queries, and mask logits of round
    blobs, some overlapping, as a trained head gives them."""
    rs = np.random.RandomState(seed)
    cls = rs.randn(Q, K + 1).astype(np.float32)
    cls[np.arange(0, Q, 2), rs.randint(0, K + 1, Q // 2)] += 6.0
    yy, xx = np.mgrid[:H, :W]
    cy, cx, r = rs.rand(Q, 1, 1) * H, rs.rand(Q, 1, 1) * W, 2 + rs.rand(
        Q, 1, 1) * 6
    masks = (r - np.hypot(yy - cy, xx - cx)) + 0.3 * rs.randn(Q, H, W)
    return cls, masks.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_panoptic_fuse_and_instance_postprocess_match_jax_exactly(seed):
    cls, masks = fuse_inputs(seed)
    for thr in (0.8, 0.5):
        want = np.asarray(jpan.panoptic_fuse(
            jnp.asarray(cls), jnp.asarray(masks), 3, 2, object_mask_thr=thr))
        got = tpan.panoptic_fuse(torch.from_numpy(cls),
                                 torch.from_numpy(masks), 3, 2,
                                 object_mask_thr=thr)
        np.testing.assert_array_equal(got.numpy(), want)
        assert len(np.unique(want)) > 2
    want = jpan.instance_postprocess(jnp.asarray(cls), jnp.asarray(masks), 3,
                                     max_per_image=10)
    got = tpan.instance_postprocess(torch.from_numpy(cls),
                                    torch.from_numpy(masks), 3,
                                    max_per_image=10)
    for k in ("labels", "masks"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=1e-6)


def test_dataset_and_evaluator_match_jax(tmp_path):
    """`CocoPanopticDataset` (the PNG decode, crowd and void, thing ids
    counted per class, stuff id 0; `seg_dir` the JSON's stem by default)
    and `PQEvaluator` on predictions made from the gts (a thing split, a
    stuff region moved, a false positive, a void overlap) equal JAX's."""
    path = write_coco_panoptic(str(tmp_path), [(40, 52), (36, 30)])
    img_dir = str(tmp_path / "val2017")
    got_ds, want_ds = CocoPanopticDataset(path, img_dir), JDataset(
        path, img_dir)
    assert (got_ds.num_things, got_ds.num_stuff) == (3, 2)
    assert len(got_ds) == len(want_ds) == 2
    got_ev, want_ev = PQEvaluator(3, 2), JPQEvaluator(3, 2)
    for i in range(2):
        gi, gt = got_ds.load(i)
        wi, wt = want_ds.load(i)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt["pan"], wt["pan"])
        assert (gt["pan"] == -1).any() and (gt["pan"] // 1000 >= 3).any()
        assert (gt["pan"] % 1000 == 1).any()
        pred = gt["pan"].copy()
        pred[:5, :5] = 1000 + 7               # a thing split off
        pred[pred == 3000] = 4000             # stuff class 3 -> 4
        pred[:, :2] = 2 * 1000 + 9            # over the void band
        for ev in (got_ev, want_ev):
            ev.add_image(pred, gt["pan"])
    got, want = got_ev.summarize(), want_ev.summarize()
    assert got == want
    assert 0 < got["PQ"] < 1


@pytest.fixture(scope="module")
def tiny_panoptic(tmp_path_factory):
    """The tiny panoptic config on a two-image COCO-panoptic split (both
    images pad to the one 128 x 128 bucket), a checkpoint of the port's
    random weights, and the JAX variables made from it. The mask
    embedding's last layer is scaled by 30: random mask logits of order
    0.1 give every pixel to the most confident query, and no query then
    keeps 80% of its fired mask, so nothing would survive the fusion."""
    root = tmp_path_factory.mktemp("coco")
    write_coco_panoptic(str(root), [(120, 100), (97, 128)])
    opts = TINY + [f"data.data_root={root}"]
    cfg = Config.fromfile(os.path.join(ROOT, CONFIG))
    cfg.merge_from_options(parse_cfg_options(opts))
    model = build_model(dict(cfg.model), device="cpu",
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for p in model.decode_head.mask_embed[4].parameters():
            p.mul_(30.0)
    ckpt = str(root / "model.pth")
    torch.save(model.state_dict(), ckpt)
    jcfg = JConfig.fromfile(os.path.join(ROOT, CONFIG))
    jcfg.merge_from_options(parse_cfg_options(opts))
    variables = convert_segmentor_checkpoint(
        {k: v.numpy() for k, v in model.state_dict().items()})
    return cfg, jcfg, model, ckpt, variables, opts


def test_run_panoptic_eval_and_test_cli_match_jax(tiny_panoptic):
    """`tools.test --eval PQ` equals `run_panoptic_eval` called directly,
    and both JAX's `run_panoptic_eval` on the same weights (every fused
    map equal: the metrics to the last bit)."""
    cfg, jcfg, model, ckpt, variables, opts = tiny_panoptic
    ds = build_panoptic_dataset(cfg.data, "val")
    got = run_panoptic_eval(cfg, model, ds, log_fn=lambda *_: None)
    cli = test_cli.main([os.path.join(ROOT, CONFIG), ckpt, "--eval", "PQ",
                         "--device", "cpu", "--cfg-options", *opts],
                        log_fn=lambda *_: None)
    sub = jcfg.data["val"]
    root = jcfg.data["data_root"]
    jds = JDataset(os.path.join(root, sub["ann_file"]),
                   os.path.join(root, sub["img_dir"]))
    with jax.default_matmul_precision("highest"):
        want = jrun(jcfg, variables, jds, log_fn=lambda *_: None)
    keys = ("PQ", "SQ", "RQ", "PQ_th", "PQ_st")
    assert {k: cli[k] for k in keys} == {k: got[k] for k in keys}
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["timing"]["images"] == 2
    # the fused maps themselves, padded, on the same weights
    from vitadapter.builder import build_model as jbuild_model
    from vitadapter.data.preprocess import normalize as jnormalize
    from vitadapter_torch.data.preprocess import normalize
    x = np.zeros((2, 128, 128, 3), np.float32)
    for i in range(2):
        img = ds.load(i)[0]
        x[i, :img.shape[0], :img.shape[1]] = img
    jm = jbuild_model(dict(jcfg.model))
    with jax.default_matmul_precision("highest"):
        jc, jmask = jax.jit(lambda v, x: jm.apply(
            v, jnormalize(x), return_queries=True))(variables, x)
    with torch.no_grad():
        tc, tmask = model(normalize(torch.from_numpy(x)),
                          return_queries=True)
    for b in range(2):
        want_pan = np.asarray(jpan.panoptic_fuse(jc[b], jmask[b], 3, 2,
                                                 object_mask_thr=0.0))
        got_pan = tpan.panoptic_fuse(tc[b], tmask[b], 3, 2,
                                     object_mask_thr=0.0).numpy()
        np.testing.assert_array_equal(got_pan, want_pan)
        assert len(np.unique(got_pan)) > 1
    assert isinstance(model.decode_head, Mask2FormerHead)
    with pytest.raises(SystemExit):
        test_cli.parse_args([CONFIG, ckpt, "--eval", "PQ", "--aug-test"])


def test_panoptic_config_trains_on_synthetic_data_only(tiny_panoptic,
                                                       tmp_path):
    """`run_training` looks `data.dataset_type` up among the segmentation
    datasets in both packages: the panoptic config's "CocoDataset" raises
    `KeyError` on real data, as JAX's `vitadapter/train/loop.py` does;
    `--synthetic-data` trains."""
    cfg, jcfg, *_ = tiny_panoptic
    with pytest.raises(KeyError, match="CocoDataset"):
        run_training(cfg, str(tmp_path / "p"), max_iters=1, device="cpu",
                     log_fn=lambda *_: None)
    with pytest.raises(KeyError, match="CocoDataset"):
        jloop.build_dataset(jcfg.data, "train")
    cfg.merge_from_options({"evaluation.interval": 0,
                            "train_cfg.num_points": 64})
    state = run_training(cfg, str(tmp_path / "s"), max_iters=1,
                         synthetic=True, device="cpu",
                         log_fn=lambda *_: None)
    assert state.step == 1


def test_config_parameter_count_matches_jax():
    """The shipped config (BEiTv2-Adapter-L at 1024, 133 classes, 200
    queries) builds on the meta device with JAX's parameter count."""
    path = os.path.join(ROOT, CONFIG)
    model = builder.build(dict(Config.fromfile(path).model))
    assert model.decode_head.cls_embed.out_features == 134
    got = sum(p.numel() for p in model.parameters())
    from vitadapter.builder import build_model as jbuild_model
    shapes = jax.eval_shape(jbuild_model(dict(JConfig.fromfile(path).model))
                            .init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 1024, 1024, 3),
                                                 np.float32))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert got == want == PARAMETERS
