"""The port's config layer, `builder.py` and host data pipeline against the JAX
package, on the CPU: `utils/config.py` on every file of `configs/`, with
`--cfg-options` and `_delete_`; every semantic Mask2Former config built on
the meta device by `builder.py` (the 640 px config's full-size parameter
count against JAX's `jax.eval_shape`); `data/transforms.train_transform`
and `data/loader.EpochSampler` under one seed; and what `builder.py`
refuses."""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from vitadapter.builder import build_model as jbuild_model
from vitadapter.data import loader as jloader
from vitadapter.data import transforms as jtransforms
from vitadapter.utils.config import Config as JConfig
from vitadapter.utils.config import parse_cfg_options as jparse
from vitadapter_torch import builder
from vitadapter_torch.data import loader as tloader
from vitadapter_torch.data import transforms as ttransforms
from vitadapter_torch.data.datasets import DATASETS
from vitadapter_torch.utils.config import Config, parse_cfg_options

from torch_port_util import assert_refer_required_at_first_forward

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT)
                 for p in glob.glob(os.path.join(ROOT, "configs/*/*.py")))
M2F_640 = "configs/ade20k/mask2former_beit_adapter_large_640_160k_ade20k_ss.py"
OPTIONS = ["model.backbone.depth=2", "data.crop_size=[64,64]",
           "optimizer.lr=1e-3", "evaluation.save_best=mIoU",
           "new.key=(1,2)", "log_config.interval=1"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make the small eager ops here many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _semantic_m2f(path):
    """A Mask2Former head on one of the semantic-segmentation datasets."""
    cfg = Config.fromfile(os.path.join(ROOT, path))
    model = cfg.get("model", {})
    return (model.get("type") == "EncoderDecoderMask2Former"
            and model["decode_head"]["type"] == "Mask2FormerHead"
            and cfg.data.get("dataset_type") in DATASETS)


SEMANTIC_M2F = [p for p in CONFIGS if _semantic_m2f(p)]


@pytest.mark.parametrize("path", CONFIGS)
def test_config_fromfile_matches_jax(path):
    got = Config.fromfile(os.path.join(ROOT, path))
    want = JConfig.fromfile(os.path.join(ROOT, path))
    assert got == want
    got.merge_from_options(parse_cfg_options(OPTIONS))
    want.merge_from_options(jparse(OPTIONS))
    assert got == want


def test_delete_replaces_a_subtree_as_jax(tmp_path):
    (tmp_path / "base.py").write_text(
        "model = dict(type='A', backbone=dict(x=1, y=[1, 2]), head=3)\n"
        "data = dict(a=1)\n")
    (tmp_path / "child.py").write_text(
        "_base_ = './base.py'\n"
        "model = dict(backbone=dict(_delete_=True, z=2), head=4)\n"
        "data = dict(b=2)\n")
    got = Config.fromfile(str(tmp_path / "child.py"))
    assert got == JConfig.fromfile(str(tmp_path / "child.py"))
    assert got.model == {"type": "A", "backbone": {"z": 2}, "head": 4}
    assert got.data == {"a": 1, "b": 2}


def test_the_semantic_mask2former_configs_are_found():
    """Every Mask2Former config of `configs/` on a semantic dataset (the
    panoptic COCO one and MaskFormer are not)."""
    assert len(SEMANTIC_M2F) == 24
    assert M2F_640 in SEMANTIC_M2F


@pytest.mark.parametrize("path", SEMANTIC_M2F)
def test_semantic_mask2former_config_builds_on_meta(path):
    cfg = Config.fromfile(os.path.join(ROOT, path))
    model = builder.build(dict(cfg.model))
    bb, head = cfg.model["backbone"], cfg.model["decode_head"]
    assert type(model.backbone).__name__ == bb["type"] == "BEiTAdapter"
    assert len(model.backbone.blocks) == bb["depth"]
    assert model.backbone.with_cp == bb["with_cp"]
    assert model.decode_head.cls_embed.out_features == head["num_classes"] + 1
    assert model.decode_head.query_feat.num_embeddings == head["num_queries"]
    assert all(p.is_meta for p in model.parameters())


def test_640_config_parameter_count_matches_jax():
    cfg = Config.fromfile(os.path.join(ROOT, M2F_640))
    got = sum(p.numel() for p in builder.build(dict(cfg.model)).parameters())
    jm = jbuild_model(dict(JConfig.fromfile(os.path.join(ROOT, M2F_640))
                           .model))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 640, 640, 3),
                                                 np.float32))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert got == want == 568_204_887


def test_builder_refuses_what_is_not_ported():
    # every component type of the JAX registry is ported: the MaskFormer,
    # panoptic, ATSS, GFL and Sparse R-CNN configs build on the meta
    # device with JAX's parameter counts (`eval_shape` of the JAX build,
    # computed in test_torch_{maskformer,panoptic,single_stage,
    # sparse_rcnn}.py); the shipped MaskFormer config's plain pixel decoder
    # raises at its first forward as JAX's does, so it is counted with
    # `use_encoder_decoder=True`
    for path, opts, n in (
            ("ade20k/maskformer_beit_adapter_large_640_160k_ade20k_ss",
             {"model.decode_head.use_encoder_decoder": True}, 350_383_959),
            ("mask2former/mask2former_beitv2_adapter_large_16x1_3x_"
             "coco-panoptic", {}, 572_189_254),
            ("atss/atss_deit_adapter_small_fpn_3x_coco", {}, 35_661_418),
            ("gfl/gfl_deit_adapter_small_fpn_3x_coco", {}, 35_808_938),
            ("sparse_rcnn/sparse_rcnn_deit_adapter_small_fpn_3x_coco", {},
             109_687_704)):
        cfg = Config.fromfile(os.path.join(ROOT, "configs", path + ".py"))
        cfg.merge_from_options(opts)
        model = builder.build(dict(cfg.model))
        assert sum(p.numel() for p in model.parameters()) == n, path
    # the UperNet Uni-Perceiver config builds and, as in JAX, its first
    # forward calls the backbone without the text
    assert_refer_required_at_first_forward(
        "configs/ade20k/upernet_uniperceiver_adapter_large_512_160k_"
        "ade20k.py", ["model.decode_head.channels=32",
                      "model.auxiliary_head.channels=16"])
    with pytest.raises(KeyError, match="unknown component type"):
        builder.build({"type": "NoSuchThing"})
    # what these refused before they were ported now builds: BEiT's
    # absolute position embedding (over the 224 pretrain grid), the cascade
    # detector, and BEiT's windowed blocks without a cls token
    cfg = Config.fromfile(os.path.join(ROOT, M2F_640))
    cfg.merge_from_options({"model.backbone.use_abs_pos_emb": True})
    assert builder.build(dict(cfg.model)).backbone.pos_embed.shape == (
        1, 14 * 14, 1024)
    cfg.merge_from_options({"model.backbone.qkv_bias": False,
                            "model.backbone.use_rel_pos_bias": False})
    attn = builder.build(dict(cfg.model)).backbone.blocks[0].attn
    assert not hasattr(attn, "q_bias") and attn.rel_pos_grid is None
    cfg = Config.fromfile(os.path.join(
        ROOT, "configs/ade20k/upernet_vit_adapter_tiny_512_160k_ade20k.py"))
    cfg.merge_from_options({"model.backbone.residual_indices": [2, 5]})
    blocks = builder.build(dict(cfg.model)).backbone.blocks
    assert [i for i, b in enumerate(blocks) if b.use_residual] == [2, 5]
    cfg = Config.fromfile(os.path.join(ROOT, M2F_640))
    cfg.merge_from_options({"model.backbone.window_attn": True,
                            "model.backbone.use_cls_token": False})
    assert builder.build(dict(cfg.model)).backbone.blocks[0].attn.windowed
    assert type(builder.build({"type": "CascadeRCNN", "backbone": dict(
        cfg.model["backbone"])})).__name__ == "CascadeRCNN"


def test_builder_maps_dtype_strings_and_materializes():
    cfg = {"type": "BEiTAdapter", "img_size": 64, "embed_dim": 48,
           "depth": 2, "num_heads": 4, "deform_num_heads": 6,
           "conv_inplane": 16, "interaction_indexes": [[0, 0], [1, 1]],
           "dtype": "bfloat16"}
    model = builder.build_model(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    assert model.blocks[0].attn.qkv.compute_dtype == torch.bfloat16
    assert not model.training
    assert all(torch.isfinite(p).all() for p in model.parameters())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_train_transform_matches_jax(seed):
    rs = np.random.RandomState(100 + seed)
    h, w = rs.randint(40, 160, 2)
    img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    seg = rs.randint(0, 6, (h, w)).astype(np.uint8)
    seg[:5] = 255
    args = ((64, 64), (128, 64), (0.5, 2.0), 0.75)
    got = ttransforms.train_transform(np.random.RandomState(seed), img, seg,
                                      *args)
    want = jtransforms.train_transform(np.random.RandomState(seed), img, seg,
                                       *args)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype
        np.testing.assert_array_equal(g, w_)


def test_epoch_sampler_matches_jax():
    got, want = tloader.EpochSampler(7, seed=3), jloader.EpochSampler(7,
                                                                      seed=3)
    assert [got.take(3) for _ in range(6)] == [want.take(3) for _ in range(6)]
