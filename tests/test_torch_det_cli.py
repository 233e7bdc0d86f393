"""The port's detection entry points on the CPU: `tools.train` on the
Mask R-CNN configs (`train/det_loop.py::run_det_training`) for 2 steps on
a tiny COCO-layout dataset with the eval hook, `--resume` for a third,
`--synthetic-data`, then `tools.test --eval bbox segm` against
`run_det_eval` called directly; and the builder on the repo's Mask R-CNN
configs: the 12 that the port runs build (on the meta device, one also
counted against JAX's parameters), the Uni-Perceiver and BEiTv2 ones
raise naming their ROADMAP items. The model is the shipped DeiT-T config
cut to the tiny geometry of `torch_port_util.DET_*` by `--cfg-options`."""

import os
import re

import jax
import numpy as np
import pytest
import torch

from vitadapter.builder import build_model as jbuild_model
from vitadapter.utils.config import Config as JConfig
from vitadapter_torch import builder
from vitadapter_torch.builder import build_model
from vitadapter_torch.det.mask_rcnn import MaskRCNN
from vitadapter_torch.det.necks import FPN, ChannelMapperWithPooling
from vitadapter_torch.layers.attention import WindowedAttention
from vitadapter_torch.tools import test as test_cli
from vitadapter_torch.tools import train as train_cli
from vitadapter_torch.train.det_loop import build_det_dataset, run_det_eval
from vitadapter_torch.utils.checkpoint_io import load_model_weights
from vitadapter_torch.utils.config import Config, parse_cfg_options

from torch_port_util import write_coco

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "configs/mask_rcnn/mask_rcnn_deit_adapter_tiny_fpn_1x_coco.py"
OPTIONS = [
    "model.backbone.depth=2", "model.backbone.embed_dim=48",
    "model.backbone.num_heads=4", "model.backbone.deform_num_heads=4",
    "model.backbone.conv_inplane=16",
    "model.backbone.interaction_indexes=[[0,0],[1,1]]",
    "model.backbone.window_attn=[True,False]",
    "model.backbone.window_size=[3,None]", "model.fpn_channels=32",
    "model.num_classes=3", "model.num_proposals_train=50",
    "model.num_proposals_test=50", "model.num_roi_samples=16",
    "model.max_dets=10", "data.crop_size=[64,96]",
    "data.samples_per_chip=1", "data.max_instances=6", "data.workers=1",
    "data.det_scales=[56,64,72]", "data.det_scales_small=[40,48]",
    "data.det_crop_range=[32,48]", "data.max_long_edge=112",
    "test_cfg.img_scale=[112,64]", "log_config.interval=1",
    "checkpoint_config.interval=2", "evaluation.interval=2",
    "evaluation.save_best=bbox_mAP"]
MASK_RCNN = [
    "configs/mask_rcnn/mask_rcnn_deit_adapter_tiny_fpn_1x_coco.py",
    "configs/mask_rcnn/mask_rcnn_deit_adapter_tiny_fpn_3x_coco.py",
    "configs/mask_rcnn/mask_rcnn_deit_adapter_small_fpn_3x_coco.py",
    "configs/mask_rcnn/mask_rcnn_deit_adapter_small_3x_coco.py",
    "configs/mask_rcnn/mask_rcnn_deit_adapter_base_fpn_3x_coco.py",
    "configs/mask_rcnn/mask_rcnn_augreg_adapter_large_fpn_3x_coco.py",
    "configs/mask_rcnn/mask_rcnn_deit_tiny_fpn_3x_coco.py",
    "configs/mask_rcnn/mask_rcnn_deit_small_fpn_3x_coco.py",
    "configs/mask_rcnn/mask_rcnn_deit_base_fpn_3x_coco.py",
    "configs/mask_rcnn/mask_rcnn_augreg_large_fpn_3x_coco.py",
    "configs/upgraded_mask_rcnn/mask_rcnn_mae_adapter_base_lsj_fpn_25ep_coco.py",
    "configs/upgraded_mask_rcnn/mask_rcnn_mae_adapter_base_lsj_fpn_50ep_coco.py",
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores (see test_torch_upernet)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """2 train steps on the tiny COCO-layout set (checkpoint and the eval
    hook at step 2), then `--resume` to step 3; returns the paths, the
    options and both runs' log lines."""
    tmp = tmp_path_factory.mktemp("det_cli")
    coco = str(tmp / "coco")
    write_coco(coco, ((60, 90), (90, 70), (64, 64), (50, 80)), seed=1)
    options = OPTIONS + [f"data.data_root={coco}"]
    work = str(tmp / "work")
    args = [os.path.join(ROOT, TINY), "--work-dir", work, "--device", "cpu",
            "--cfg-options", *options]
    first, second = [], []
    state = train_cli.main(args + ["--max-iters", "2"], log_fn=first.append)
    assert state.step == 2
    state = train_cli.main(args + ["--max-iters", "3", "--resume"],
                           log_fn=second.append)
    return work, options, first, second, state


def test_det_train_cli_runs_resumes_and_evaluates(trained):
    work, _, first, second, state = trained
    iters = [l for l in first if re.match(r"iter \d+/2 ", l)]
    assert len(iters) == 2
    assert all(np.isfinite(float(re.search(r"loss=(\S+)", l).group(1)))
               for l in iters)
    assert any(l.startswith("checkpoint of step 2:") for l in first)
    assert any(l.startswith("bbox_mAP=") and "segm_mAP=" in l
               for l in first)
    assert any("new best bbox_mAP" in l for l in first)
    assert os.path.isdir(os.path.join(work, "best_bbox_mAP"))
    assert "resumed from step 2" in second and state.step == 3
    assert any(l.startswith("iter 3/3 ") for l in second)


def test_det_test_cli_matches_run_det_eval(trained):
    """`tools.test --eval bbox segm` on the latest checkpoint gives
    `run_det_eval`'s metrics on the same weights; `--aug-test` without a
    `tta` config raises JAX's ValueError."""
    work, options, _, _, _ = trained
    cfg_path = os.path.join(ROOT, TINY)
    args = [cfg_path, os.path.join(work, "ckpt"), "--eval", "bbox", "segm",
            "--device", "cpu", "--cfg-options", *options]
    got = test_cli.main(args, log_fn=lambda *_: None)
    cfg = Config.fromfile(cfg_path)
    cfg.merge_from_options(parse_cfg_options(options))
    model = load_model_weights(os.path.join(work, "ckpt"),
                               build_model(dict(cfg.model), device="cpu"))
    want = run_det_eval(cfg, model, build_det_dataset(cfg.data, "val"),
                        ("bbox", "segm"), log_fn=lambda *_: None)
    assert got["timing"]["images"] == want["timing"]["images"] == 3
    for k in want:
        if k != "timing":
            assert got[k] == want[k] or (np.isnan(got[k])
                                         and np.isnan(want[k])), k
    assert {"bbox_mAP", "segm_mAP", "AR@100"} <= set(got)
    with pytest.raises(ValueError, match="tta"):
        test_cli.main(args + ["--aug-test"], log_fn=lambda *_: None)


def test_det_train_cli_on_synthetic_data(tmp_path):
    logs = []
    state = train_cli.main(
        [os.path.join(ROOT, TINY), "--work-dir", str(tmp_path),
         "--synthetic-data", "--max-iters", "1", "--device", "cpu",
         "--cfg-options", *OPTIONS[:-2]], log_fn=logs.append)
    assert state.step == 1
    assert any(l.startswith("iter 1/1 ") for l in logs)
    assert not any("bbox_mAP" in l for l in logs)   # no eval on synthetic


@pytest.mark.parametrize("path", MASK_RCNN)
def test_mask_rcnn_config_builds_on_meta(path):
    """Each config builds a `MaskRCNN` with its neck and the windowed
    blocks its backbone sets (14x14 windows)."""
    cfg = Config.fromfile(os.path.join(ROOT, path))
    model = builder.build(dict(cfg.model))
    assert isinstance(model, MaskRCNN)
    neck = ChannelMapperWithPooling if cfg.model.get(
        "neck_type") == "channel_mapper" else FPN
    assert isinstance(model.neck, neck)
    windowed = [isinstance(b.attn, WindowedAttention)
                for b in model.backbone.blocks]
    want = cfg.model["backbone"]["window_attn"]
    assert windowed == [bool(w) for w in want]
    assert all(b.attn.window_size == 14 for b in model.backbone.blocks
               if isinstance(b.attn, WindowedAttention))


def test_mask_rcnn_parameter_count_matches_jax():
    """The DeiT-T ViT-Adapter Mask R-CNN: the port's parameters number
    JAX's (`eval_shape` of the JAX build)."""
    cfg = Config.fromfile(os.path.join(ROOT, TINY))
    got = sum(p.numel() for p in builder.build(dict(cfg.model)).parameters())
    jcfg = JConfig.fromfile(os.path.join(ROOT, TINY))
    shapes = jax.eval_shape(jbuild_model(dict(jcfg.model)).init,
                            jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert got == want


@pytest.mark.parametrize("path,error,item", [
    ("configs/mask_rcnn/mask_rcnn_uniperceiver_adapter_base_fpn_3x_coco.py",
     KeyError, "item 8"),
    ("configs/upgraded_mask_rcnn/mask_rcnn_beitv2_adapter_large_fpn_lsj_"
     "coco.py", NotImplementedError, "item 4")])
def test_mask_rcnn_configs_not_ported_raise(path, error, item):
    cfg = Config.fromfile(os.path.join(ROOT, path))
    with pytest.raises(error, match=item):
        builder.build(dict(cfg.model))


def test_zoo_mask_rcnn_vit_adapter_runs_on_the_cpu():
    """`zoo.mask_rcnn_vit_adapter` with the tiny trunk: the configs'
    window pattern cut to its depth, one image through the test path."""
    from vitadapter_torch import zoo

    model = zoo.mask_rcnn_vit_adapter(
        "tiny", num_classes=3, device="cpu", depth=2, embed_dim=48,
        num_heads=4, conv_inplane=16, interaction_indexes=((0, 0), (1, 1)),
        window_attn=(True, False), window_size=(3, None))
    assert isinstance(model.backbone.blocks[0].attn, WindowedAttention)
    with torch.no_grad():
        dets = model(torch.zeros(1, 64, 96, 3))
    assert dets["boxes"].shape == (1, 100, 4)
    assert dets["masks"].shape == (1, 100, 28, 28)
