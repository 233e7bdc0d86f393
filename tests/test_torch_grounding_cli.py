"""The port's grounding data and entry points on the CPU: the CLIP BPE
tokenizer and the flip word swap, `grounding_metrics` and the grounding
train batches (paraphrase, flip swap, tokenized text) against the JAX
package's for one seed; the repo's 6 grounding configs built with the JAX
package's parameter counts; and `tools.train`, `tools.test --eval IoU
[--aug-test]` and `tools.generate_results` on a tiny WSDM-layout set (a
COCO json with a question per image and a tiny merge table) at a tiny
size, `tools.test` equal to `run_grounding_eval` called directly."""

import csv
import gzip
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from vitadapter.builder import build_model as jbuild_model
from vitadapter.data import grounding as jgrounding
from vitadapter.data import tokenization as jtok
from vitadapter.det import grounding_dino as jgd
from vitadapter.train import det_loop as jloop
from vitadapter.utils.config import Config as JConfig
from vitadapter.utils.config import parse_cfg_options as jparse_cfg_options
from vitadapter_torch import builder
from vitadapter_torch.data import grounding as tgrounding
from vitadapter_torch.data import tokenization as ttok
from vitadapter_torch.tools import generate_results as gen_cli
from vitadapter_torch.tools import test as test_cli
from vitadapter_torch.tools import train as train_cli
from vitadapter_torch.train import det_loop as tloop
from vitadapter_torch.utils.checkpoint_io import load_model_weights
from vitadapter_torch.utils.config import Config, parse_cfg_options

from test_torch_det_data import assert_equal_trees
from torch_port_util import assert_close, flax_variables, port_like

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ["configs/wsdm2023/dino_4scale_uniperceiver_adapter_"
           f"{name}.py" for name in (
               "base_24ep_gqa_wsdm2023", "base_6ep_gqa",
               "large_24ep_gqa_wsdm2023",
               "large_24ep_gqa_wsdm2023_trainval", "large_6ep_gqa")] + [
    "configs/dino/dino_4scale_uniperceiver_adapter_large_24ep_wsdm2023.py"]
WSDM = CONFIGS[2]
QUESTIONS = ["What is on the LEFT side of the right cup?",
             "the left&amp;right  Doors", "Rightmost? no, left!", "a cat"]
SIZES = ((80, 112), (112, 80), (96, 96), (72, 120))
# the large wsdm2023 config at a tiny size: 2 joint layers 48 wide in one
# interaction, a 32-wide DINO head with one encoder and two decoder
# layers; 64 px training crops, 96 x 64 test canvases
TINY = [
    "model.backbone.embed_dim=48", "model.backbone.depth=2",
    "model.backbone.num_heads=4", "model.backbone.deform_num_heads=4",
    "model.backbone.conv_inplane=16", "model.backbone.vocab_size=600",
    "model.backbone.interaction_indexes=[[0,1]]", "model.embed_dim=32",
    "model.num_heads=4", "model.ffn_dim=64", "model.num_encoder_layers=1",
    "model.num_decoder_layers=2", "model.num_queries=12",
    "data.crop_size=[64,64]", "data.max_sent_len=16", "data.det_scales=[64]",
    "data.max_long_edge=96", "data.workers=1", "log_config.interval=1",
    "checkpoint_config.interval=2", "test_cfg.img_scale=[96,64]",
    "tta.scales=[[96,48],[96,64]]"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores (see test_torch_upernet)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_merges(path):
    """A tiny CLIP merge table: the header and a few merges, so that most
    words stay near byte level (the table is data, not behaviour)."""
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: tiny\nt h\ne d</w>\nr e\nl e\nf t</w>\n"
                "le ft</w>\ni gh\n")


@pytest.fixture(scope="module")
def wsdm(tmp_path_factory):
    """A WSDM-layout set: images, `annotations/{train,val}.json` (one box
    and a question per image), a paraphrase cache holding alternatives
    for two questions, and the merge table."""
    root = str(tmp_path_factory.mktemp("wsdm"))
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "annotations"))
    rs = np.random.RandomState(0)
    images, anns = [], []
    for i, (h, w) in enumerate(SIZES):
        Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
            os.path.join(root, "images", f"{i}.png"))
        images.append({"id": i + 1, "file_name": f"{i}.png", "height": h,
                       "width": w, "question": QUESTIONS[i]})
        x, y = rs.rand(2) * 20
        anns.append({"id": i + 1, "image_id": i + 1, "category_id": 1,
                     "bbox": [x, y, 20 + 20 * rs.rand(), 20 + 20 * rs.rand()],
                     "area": 400.0, "iscrowd": 0})
    for split in ("train", "val"):
        with open(os.path.join(root, "annotations", f"{split}.json"),
                  "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": 1, "name": "object"}]}, f)
    with open(os.path.join(root, "annotations", "paraphrase.json"), "w") as f:
        json.dump({QUESTIONS[0]: ["Which thing is left of the cup?",
                                  "the object to the right"],
                   QUESTIONS[3]: ["a small cat on the left"]}, f)
    write_merges(os.path.join(root, "bpe.txt.gz"))
    return root


def options(root):
    return TINY + [f"data.data_root={root}",
                   f"data.bpe_vocab={root}/bpe.txt.gz",
                   f"data.paraphrase_cache={root}/annotations/"
                   "paraphrase.json"]


def test_tokenizer_and_flip_swap_match_jax(wsdm):
    """Ids and masks (padded and truncated, the specials) and the
    left/right swap of the flipped question."""
    path = os.path.join(wsdm, "bpe.txt.gz")
    got, want = ttok.ClipTokenizer(path), jtok.ClipTokenizer(path)
    assert got.vocab_size == want.vocab_size
    for q in QUESTIONS + ["", "x" * 40]:
        assert got.encode(q) == want.encode(q)
        for n in (8, 16):
            assert got.tokenize_refer(q, n) == want.tokenize_refer(q, n)
        assert ttok.random_flip_refer(q) == jtok.random_flip_refer(q)
        assert got.decode(got.encode(q)) == want.decode(want.encode(q))
    assert ttok.random_flip_refer("the Left cup, right?") == \
        "the Right cup, left?"


def test_grounding_metrics_match_jax():
    rs = np.random.RandomState(1)
    pred = [np.concatenate([xy, xy + 5 + 20 * rs.rand(2)])
            for xy in rs.rand(30, 2) * 20]
    gt = [np.concatenate([xy, xy + 5 + 20 * rs.rand(2)])
          for xy in rs.rand(30, 2) * 20]
    assert tgrounding.grounding_metrics(pred, gt) == \
        jgrounding.grounding_metrics(pred, gt)
    assert tgrounding.grounding_metrics([], []) == \
        jgrounding.grounding_metrics([], [])


def test_grounding_train_batches_match_jax(wsdm):
    """Three batches of two, one seed: images, boxes, labels, valid flags
    and the tokenized (paraphrased, flip-swapped) questions; the
    paraphrase cache draws only for its questions, in the JAX order."""
    cfg = Config.fromfile(os.path.join(ROOT, WSDM))
    cfg.merge_from_options(parse_cfg_options(options(wsdm)))
    data_cfg = dict(cfg.data)
    path = data_cfg["bpe_vocab"]
    got_ds = tloop.build_det_dataset(data_cfg, "train", with_masks=False)
    want_ds = jloop.build_det_dataset(data_cfg, "train", with_masks=False)
    got = tloop.det_train_batches(got_ds, data_cfg, 2, seed=3,
                                  tokenizer=ttok.ClipTokenizer(path))
    want = jloop.det_train_batches(want_ds, data_cfg, 2, seed=3,
                                   tokenizer=jtok.ClipTokenizer(path))
    for _ in range(3):
        g, w = next(got), next(want)
        assert_equal_trees(g, w)
        assert g["refer"].shape == (2, 16) and g["r_mask"].any()


_JAX_COUNTS = {}


def jax_parameter_count(model_cfg) -> int:
    """Parameters of the JAX model (shapes only), once per distinct model
    dict (the 6 configs hold 3)."""
    key = json.dumps(model_cfg, sort_keys=True, default=str)
    if key not in _JAX_COUNTS:
        jm = jbuild_model(model_cfg)
        ids = jax.ShapeDtypeStruct((1, 16), np.int32)
        shapes = jax.eval_shape(
            lambda x, i: jm.init(jax.random.PRNGKey(0), x, i, i),
            jax.ShapeDtypeStruct((1, 128, 128, 3), np.float32), ids)
        _JAX_COUNTS[key] = sum(int(np.prod(s.shape)) for s in
                               jax.tree_util.tree_leaves(shapes["params"]))
    return _JAX_COUNTS[key]


@pytest.mark.parametrize("path", CONFIGS)
def test_grounding_config_parameter_count_matches_jax(path):
    cfg = Config.fromfile(os.path.join(ROOT, path))
    model = builder.build(dict(cfg.model))
    assert all(p.is_meta for p in model.parameters())
    got = sum(p.numel() for p in model.parameters())
    want = jax_parameter_count(dict(JConfig.fromfile(os.path.join(
        ROOT, path)).model))
    assert got == want, (path, got, want)


def vote_margin(per_aug, top_k=100):
    """The smallest gap between the best vote of `aug_test_vote` over
    `per_aug` and any other pooled box's vote."""
    boxes = np.concatenate([r["boxes"][:top_k] for r in per_aug])
    scores = np.concatenate([r["scores"][:top_k] for r in per_aug])
    keep = np.isfinite(scores)
    boxes, scores = boxes[keep].astype(np.float64), scores[keep]
    lt = np.maximum(boxes[:, None, :2], boxes[None, :, :2])
    rb = np.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = (boxes[:, 2:] - boxes[:, :2]).prod(-1)
    iou = inter / (area[:, None] + area[None] - inter)
    vote = np.sort(scores + iou.mean(1))
    return float(vote[-1] - vote[-2])


@pytest.mark.parametrize("aug_test", [False, True])
def test_run_grounding_eval_matches_jax(wsdm, monkeypatch, aug_test):
    """The port's `run_grounding_eval` against the JAX package's on the
    same random weights (converted), on the 4 val images of both
    orientations: keep-ratio resize, the two canvases, the batch slack,
    with `aug_test` 2 scales x flip (the flipped question's words
    swapped, the boxes unflipped in the aug's frame, then unscaled) and
    the vote. Each image's predicted box within 2e-4 of the boxes' scale,
    mIoU and Acc@0.5 within 1e-5; with `aug_test` also every aug's boxes
    and scores as they enter the vote (the two packages finish the images
    in different orders, so each image's augs are paired by content).
    Asserted first: the top score (or the top vote) of every prediction
    is 1e-4 clear of the next, so that float noise cannot change the
    pick."""
    opts = options(wsdm)
    cfg = Config.fromfile(os.path.join(ROOT, WSDM))
    cfg.merge_from_options(parse_cfg_options(opts))
    jcfg = JConfig.fromfile(os.path.join(ROOT, WSDM))
    jcfg.merge_from_options(jparse_cfg_options(opts))
    jm = jbuild_model(dict(jcfg.model))
    ids = np.zeros((1, 16), np.int32)
    v = flax_variables(jm, np.zeros((1, 64, 96, 3), np.float32), 41,
                       refer=ids, r_mask=ids + 1)
    port = port_like(builder.build(dict(cfg.model)), v)

    jax_preds, jax_augs, port_augs, calls = [], [], [], []
    metrics_fn, jvote, vote = (jgrounding.grounding_metrics,
                               jgd.aug_test_vote, tloop.aug_test_vote)

    def jax_metrics(preds, gts):
        jax_preds.extend(preds)
        return metrics_fn(preds, gts)

    def jax_vote(per_aug, *a, **kw):
        jax_augs.append(per_aug)
        return jvote(per_aug, *a, **kw)

    def port_vote(per_aug, *a, **kw):
        port_augs.append(per_aug)
        return vote(per_aug, *a, **kw)

    monkeypatch.setattr(jgrounding, "grounding_metrics", jax_metrics)
    monkeypatch.setattr(jgd, "aug_test_vote", jax_vote)
    monkeypatch.setattr(tloop, "aug_test_vote", port_vote)
    hook = port.register_forward_hook(
        lambda m, i, o: calls.append(o["scores"].numpy()))
    got = tloop.run_grounding_eval(
        cfg, port, tloop.build_det_dataset(cfg.data, "val",
                                           with_masks=False),
        aug_test=aug_test, log_fn=lambda *_: None)
    hook.remove()
    with jax.default_matmul_precision("highest"):
        want = jloop.run_grounding_eval(
            jcfg, v, jloop.build_det_dataset(jcfg.data, "val",
                                             with_masks=False),
            aug_test=aug_test, log_fn=lambda *_: None)
    assert got["timing"]["augs"] == (4 if aug_test else 1)
    if aug_test:
        margins = [vote_margin(p) for p in port_augs]
        assert len(margins) == len(SIZES) and min(margins) > 1e-4, margins
        assert len(jax_augs) == len(SIZES)
        for per_aug in port_augs:
            first = per_aug[0]["boxes"]
            j = min(range(len(jax_augs)), key=lambda j: float(np.abs(
                jax_augs[j][0]["boxes"] - first).max()))
            pair = jax_augs.pop(j)
            for a, (g, w) in enumerate(zip(per_aug, pair)):
                for k in ("boxes", "scores"):
                    assert_close(g[k], w[k], 2e-4, (a, k))
    else:
        s = np.concatenate(calls)
        assert float((s[:, 0] - s[:, 1]).min()) > 1e-4
    assert len(jax_preds) == len(SIZES)
    assert_close(got["boxes"], np.stack(jax_preds), 2e-4)
    for k in ("mIoU", "Acc@0.5"):
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])


def test_grounding_clis_train_evaluate_and_write_submissions(wsdm, tmp_path):
    """`tools.train` on the set (2 steps, checkpoints) and on synthetic
    data; `tools.test --eval IoU` equal to `run_grounding_eval` on the
    same weights, and with `--aug-test` (2 scales x flip: 4 augs an image);
    `tools.generate_results` writes the top box of each CSV row."""
    cfg_path = os.path.join(ROOT, WSDM)
    opts = options(wsdm)
    work = str(tmp_path / "work")
    state = train_cli.main([cfg_path, "--work-dir", work, "--max-iters", "2",
                            "--device", "cpu", "--cfg-options", *opts],
                           log_fn=lambda *_: None)
    assert state.step == 2
    synth = train_cli.main([cfg_path, "--work-dir", str(tmp_path / "s"),
                            "--max-iters", "1", "--synthetic-data",
                            "--device", "cpu", "--cfg-options", *opts],
                           log_fn=lambda *_: None)
    assert synth.step == 1
    ckpt = os.path.join(work, "ckpt")
    metrics = test_cli.main([cfg_path, ckpt, "--eval", "IoU", "--device",
                             "cpu", "--cfg-options", *opts],
                            log_fn=lambda *_: None)
    assert set(metrics) == {"mIoU", "Acc@0.5", "boxes", "timing"}
    assert metrics["boxes"].shape == (len(SIZES), 4)
    assert metrics["timing"]["augs"] == 1
    cfg = Config.fromfile(cfg_path)
    cfg.merge_from_options(parse_cfg_options(opts))
    model = load_model_weights(ckpt, builder.build_model(dict(cfg.model),
                                                         device="cpu"))
    direct = tloop.run_grounding_eval(
        cfg, model, tloop.build_det_dataset(cfg.data, "val",
                                            with_masks=False),
        log_fn=lambda *_: None)
    np.testing.assert_array_equal(direct["boxes"], metrics["boxes"])
    assert direct["mIoU"] == metrics["mIoU"]
    aug = test_cli.main([cfg_path, ckpt, "--eval", "IoU", "--aug-test",
                         "--device", "cpu", "--cfg-options", *opts],
                        log_fn=lambda *_: None)
    assert aug["timing"]["augs"] == 4
    assert np.isfinite(aug["boxes"]).all() and 0 <= aug["mIoU"] <= 1

    rows = str(tmp_path / "in.csv")
    with open(rows, "w") as f:
        f.write("image,question\n0.png,the left one\n3.png,a cat\n")
    out = str(tmp_path / "out.csv")
    written = gen_cli.main([cfg_path, ckpt, rows, out, "--img-root",
                            os.path.join(wsdm, "images"), "--max-sent-len",
                            "16", "--device", "cpu", "--cfg-options", *opts],
                           log_fn=lambda *_: None)
    with open(out) as f:
        back = list(csv.DictReader(f))
    assert [r["image"] for r in back] == ["0.png", "3.png"]
    assert len(written) == 2 and all(
        float(r["right"]) >= float(r["left"]) for r in back)
