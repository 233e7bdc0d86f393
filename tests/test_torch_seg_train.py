"""The port's UperNet training and config path on the CPU: one
`train/trainer.py::make_seg_train_step` against the JAX package's, the
repo's UperNet configs built by `builder.py` on the meta device (the
AugReg-L config's parameter count against JAX's `jax.eval_shape`), and a
tiny UperNet config through `tools.train` (two steps and a resume) and
`tools.test`.

The step: both sides start from the same random flax weights and
BatchNorm statistics (carried by `load_flax`) and take one step of the
config optimizer (clip 0.01, layer decay, no warmup) on the same batch,
with drop path and dropout 0 (JAX's random bits cannot be replayed).
Tolerances: the loss and each log 1e-4 relative (fp32 sums in another
order); each parameter's change within 1e-2 of its leaf's largest change
where the gradient is at least 5% of the leaf's largest (Adam's first step
is about lr * sign(g), decided only where the gradient is well resolved;
a missing, reversed or mis-scaled update is off by 100%); BatchNorm
statistics 1e-5."""

import glob
import os
import re

import jax
import numpy as np
import pytest
import torch

from vitadapter.builder import build_model as jbuild_model
from vitadapter.heads.upernet import FCNHead as JFCNHead
from vitadapter.heads.upernet import UPerHead as JUPerHead
from vitadapter.models.segmentor import EncoderDecoder as JSeg
from vitadapter.models.vit_adapter import ViTAdapter as JViTAdapter
from vitadapter.train import optim as joptim
from vitadapter.train import trainer as jtrainer
from vitadapter.utils.config import Config as JConfig
from vitadapter_torch import builder
from vitadapter_torch.heads.upernet import FCNHead, UPerHead
from vitadapter_torch.models.segmentor import EncoderDecoder
from vitadapter_torch.models.vit_adapter import ViTAdapter
from vitadapter_torch.tools import test as test_cli
from vitadapter_torch.tools import train as train_cli
from vitadapter_torch.train import optim as toptim
from vitadapter_torch.train import trainer as ttrainer
from vitadapter_torch.train.loop import build_dataset, eval_config, run_eval
from vitadapter_torch.utils import checkpoint_io
from vitadapter_torch.utils.config import Config
from vitadapter_torch.utils.weights import load_flax, state_dict_from_flax

from test_m2f_cli_learns import write_color_task
from torch_port_util import (TINY_TRAIN_BACKBONE,
                             assert_refer_required_at_first_forward,
                             randomize_flax, to_np)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UPERNET = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs/*/upernet_*.py")))
UNIPERCEIVER = ("configs/ade20k/"
                "upernet_uniperceiver_adapter_large_512_160k_ade20k.py")
PORTABLE = [p for p in UPERNET if p != UNIPERCEIVER]
AUGREG_L = "configs/ade20k/upernet_augreg_adapter_large_512_160k_ade20k.py"

# one block in one interaction (with its extra extractors) keeps JAX's
# compile of the step short
BACKBONE = dict(TINY_TRAIN_BACKBONE, depth=1, interaction_indexes=((0, 0),))
K = 5
HEAD = dict(num_classes=K, channels=16, dropout_ratio=0.0)
AUX = dict(num_classes=K, channels=8, dropout_ratio=0.0)
OPT = dict(base_lr=1e-4, depth=BACKBONE["depth"],
           total_steps=1000, warmup_steps=0, grad_clip=0.01)
LOG_KEYS = {"loss", "grad_norm", "loss_decode", "loss_aux"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make these small eager ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def step_pair():
    """(jax new state, jax logs, jax clipped gradients, port model, port
    logs, initial flax params), after one step on each side."""
    jm = JSeg(backbone=JViTAdapter(**BACKBONE),
              decode_head=JUPerHead(**HEAD), auxiliary_head=JFCNHead(**AUX))
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x,
                                              with_aux=True),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    params = randomize_flax(zeros["params"], 60)
    stats = randomize_flax(zeros["batch_stats"], 61, stats=True)
    rs = np.random.RandomState(62)
    label = rs.randint(0, K, (2, 64, 64))
    label[1, :8] = 255
    batch = {"image": rs.randn(2, 64, 64, 3).astype(np.float32),
             "label": label.astype(np.int32)}

    tx, _ = joptim.make_optimizer(params, **OPT)
    state = jtrainer.TrainState.create(params, stats, tx)
    with jax.default_matmul_precision("highest"):
        jstate, jlogs = jax.jit(jtrainer.make_seg_train_step(jm, 0.4))(
            state, batch, jax.random.PRNGKey(63))
    jstate, jlogs = jax.device_get((jstate, jlogs))
    # the clipped gradient is (1 - b1) times Adam's first moment after one
    # step
    jgrads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                    jstate.opt_state[1].mu)

    dim = BACKBONE["embed_dim"]
    model = EncoderDecoder(ViTAdapter(**BACKBONE),
                           UPerHead([dim] * 4, **HEAD), FCNHead(dim, **AUX))
    load_flax(model, params, stats)
    opt, _ = toptim.make_optimizer(model, **OPT)
    tstate = ttrainer.TrainState.create(model, opt)
    step = ttrainer.make_seg_train_step(model, 0.4)
    tstate, tlogs = step(tstate, {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                         torch.Generator().manual_seed(0))
    assert tstate.step == 1
    return jstate, jlogs, jgrads, model, tlogs, params, stats


def test_seg_train_step_loss_and_logs_match_jax(step_pair):
    """loss, loss_decode, loss_aux and the gradient norm (before
    clipping)."""
    _, jlogs, _, _, tlogs, _, _ = step_pair
    assert set(tlogs) == set(jlogs) == LOG_KEYS
    for k in LOG_KEYS:
        assert tlogs[k].dim() == 0
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]),
                                   rtol=1e-4, err_msg=k)
    assert float(tlogs["loss"]) == pytest.approx(
        float(tlogs["loss_decode"]) + 0.4 * float(tlogs["loss_aux"]),
        rel=1e-6)


def test_seg_train_step_parameters_match_jax(step_pair):
    jstate, _, jgrads, model, _, params, stats = step_pair
    want = state_dict_from_flax(jax.device_get(jstate.params), stats)
    before = state_dict_from_flax(params, stats)
    grads = state_dict_from_flax(jgrads, stats)
    # the biases in front of a BatchNorm on batch statistics have a zero
    # gradient in exact arithmetic: each leaf's scale is floored at 1e-4 of
    # the step's largest gradient
    floor = 1e-4 * max(float(np.abs(to_np(g)).max()) for g in grads.values())
    moved = checked = 0
    for n, p in model.named_parameters():
        got = to_np(p) - to_np(before[n])
        ref = to_np(want[n]) - to_np(before[n])
        g = np.abs(to_np(grads[n]))
        sure = g >= 0.05 * max(g.max(), floor)
        np.testing.assert_allclose(got[sure], ref[sure], rtol=0,
                                   atol=1e-2 * np.abs(ref).max(), err_msg=n)
        checked += int(sure.sum())
        moved += int(not torch.equal(p.detach(), before[n]))
    assert moved > 0.9 * len(list(model.parameters()))
    assert checked > 0.1 * sum(p.numel() for p in model.parameters())


def test_seg_train_step_batch_stats_match_jax(step_pair):
    """Every running statistic the step moved: the backbone's 10
    BatchNorms and the heads' 13 (`UPerHead`'s 4 pool convs, bottleneck, 3
    laterals, 3 FPN convs and FPN bottleneck; `FCNHead`'s conv)."""
    jstate, _, _, model, _, params, _ = step_pair
    want = state_dict_from_flax(params, jax.device_get(jstate.batch_stats))
    sd = model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    assert len(keys) == 2 * n_bn == 2 * (10 + 4 + 1 + 3 + 3 + 1 + 1)
    for k in keys:
        np.testing.assert_allclose(to_np(sd[k]), to_np(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_the_upernet_configs_are_found():
    assert len(UPERNET) == 20 and len(PORTABLE) == 19
    assert AUGREG_L in PORTABLE


@pytest.mark.parametrize("path", PORTABLE)
def test_upernet_config_builds_on_meta(path):
    cfg = Config.fromfile(os.path.join(ROOT, path))
    model = builder.build(dict(cfg.model))
    bb, head = cfg.model["backbone"], cfg.model["decode_head"]
    aux = cfg.model["auxiliary_head"]
    assert type(model).__name__ == "EncoderDecoder"
    assert type(model.backbone).__name__ == bb["type"]
    assert len(model.backbone.blocks) == bb["depth"]
    assert model.backbone.with_cp == bb.get("with_cp", False)
    assert model.aux_in_index == cfg.model["aux_in_index"]
    dim = bb["embed_dim"]
    assert model.decode_head.conv_seg.out_channels == head["num_classes"]
    assert model.decode_head.fpn_bottleneck.conv.in_channels == \
        4 * head["channels"]
    assert model.decode_head.lateral_convs[0].conv.in_channels == dim
    assert model.auxiliary_head.convs[0].conv.in_channels == dim
    assert model.auxiliary_head.conv_seg.out_channels == aux["num_classes"]
    want = builder.DTYPES[head.get("dtype", "float32")]
    assert model.decode_head.bottleneck.conv.compute_dtype == want
    assert all(p.is_meta for p in model.parameters())


def test_uniperceiver_upernet_config_is_refused_naming_item_8():
    """The UperNet Uni-Perceiver config builds since the grounding port
    (ROADMAP.md §1 item 8, done); its segmentor calls the backbone without
    the text and raises the TypeError naming `refer`, as the JAX
    package's does."""
    assert_refer_required_at_first_forward(
        UNIPERCEIVER, ["model.decode_head.channels=32",
                       "model.auxiliary_head.channels=16"])


def test_augreg_large_parameter_count_matches_jax():
    cfg = Config.fromfile(os.path.join(ROOT, AUGREG_L))
    got = sum(p.numel() for p in builder.build(dict(cfg.model)).parameters())
    jm = jbuild_model(dict(JConfig.fromfile(os.path.join(ROOT, AUGREG_L))
                           .model))
    shapes = jax.eval_shape(
        lambda x: jm.init(jax.random.PRNGKey(0), x, with_aux=True),
        jax.ShapeDtypeStruct((1, 512, 512, 3), np.float32))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert got == want == 450_087_404


def test_zoo_upernet_vit_adapter_matches_jax_parameter_count():
    """`zoo.upernet_vit_adapter` at the tiny variant's widths (cut to 2
    blocks) against the JAX zoo's: the parameter count, and the heads'
    widths."""
    from vitadapter import zoo as jzoo
    from vitadapter_torch import zoo as tzoo

    cut = dict(depth=2, interaction_indexes=((0, 0), (1, 1)))
    model = tzoo.upernet_vit_adapter("tiny", num_classes=K, channels=64,
                                     device="cpu", **cut)
    jm = jzoo.upernet_vit_adapter("tiny", num_classes=K, channels=64, **cut)
    shapes = jax.eval_shape(
        lambda x: jm.init(jax.random.PRNGKey(0), x, with_aux=True),
        jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == want
    assert model.decode_head.fpn_bottleneck.conv.out_channels == 64
    assert model.auxiliary_head.convs[0].conv.out_channels == 256
    assert not model.training


CFG = """
model = dict(
    type="EncoderDecoder",
    backbone=dict(
        type="ViTAdapter", dtype="float32", patch_size=16, embed_dim=48,
        depth=2, num_heads=4, deform_num_heads=6, conv_inplane=16,
        drop_path_rate=0.1, img_size=64, with_cp=True,
        interaction_indexes=[[0, 0], [1, 1]]),
    decode_head=dict(type="UPerHead", num_classes=4, channels=16,
                     pool_scales=[1, 2, 3, 6], dropout_ratio=0.1),
    auxiliary_head=dict(type="FCNHead", num_classes=4, channels=8,
                        num_convs=1, dropout_ratio=0.1),
    aux_in_index=2,
)
aux_loss_weight = 0.4
data = dict(
    dataset_type="PascalContextDataset", data_root={root!r},
    train=dict(img_dir="train/img", ann_dir="train/ann"),
    val=dict(img_dir="val/img", ann_dir="val/ann"),
    crop_size=[64, 64], samples_per_chip=2, scale=[64, 64],
    ratio_range=[1.0, 1.0], cat_max_ratio=1.0, workers=2)
runner = dict(max_iters=2)
optimizer = dict(lr=3e-3, weight_decay=1e-4, layer_decay_rate=0.9)
lr_config = dict(policy="poly", warmup_iters=4, power=1.0)
log_config = dict(interval=1)
checkpoint_config = dict(interval=2, max_keep_ckpts=1)
evaluation = dict(interval=2, metric="mIoU", save_best="mIoU", max_images=4)
test_cfg = dict(mode="slide", crop_size=[64, 64], stride=[43, 43])
"""


def test_upernet_config_trains_resumes_and_evaluates(tmp_path):
    """Two steps through the train CLI (a loss and a gradient norm logged
    each step, a checkpoint, the eval hook's best step), `--resume` for a
    third, then the test CLI, whose confusion matrix is `run_eval`'s on
    the same weights, with and without `--aug-test`."""
    root = tmp_path / "data"
    write_color_task(str(root), "train", 6, 0)
    write_color_task(str(root), "val", 3, 100)
    cfg = tmp_path / "upernet_tiny.py"
    cfg.write_text(CFG.format(root=str(root)))
    work = str(tmp_path / "work")
    logs = []
    state = train_cli.main([str(cfg), "--work-dir", work, "--device", "cpu"],
                           log_fn=logs.append)
    iters = [line for line in logs if re.match(r"iter \d+/", line)]
    assert len(iters) == 2 and "grad_norm=" in iters[-1]
    assert state.step == 2 and any("new best mIoU=" in line for line in logs)
    assert checkpoint_io.saved_steps(os.path.join(work, "best_mIoU")) == [2]
    resumed_logs = []
    resumed = train_cli.main([str(cfg), "--work-dir", work, "--device",
                              "cpu", "--resume", "--max-iters", "3"],
                             log_fn=resumed_logs.append)
    assert "resumed from step 2" in resumed_logs and resumed.step == 3
    assert checkpoint_io.saved_steps(os.path.join(work, "ckpt")) == [3]

    config = Config.fromfile(str(cfg))
    model = builder.build_model(dict(config.model), device="cpu")
    checkpoint_io.load_model_weights(os.path.join(work, "ckpt"), model)
    for state_dict_key, t in resumed.model.state_dict().items():
        assert torch.equal(model.state_dict()[state_dict_key], t)
    ds = build_dataset(config.data, "val")
    for flags in ([], ["--aug-test", "--cfg-options",
                       "aug_test.img_ratios=[0.75,1.0]"]):
        got = test_cli.main([str(cfg), os.path.join(work, "ckpt"), "--eval",
                             "mIoU", "--device", "cpu", *flags],
                            log_fn=lambda *_: None)
        ecfg = eval_config(config)
        if flags:
            ecfg["aug_test"] = {"img_ratios": [0.75, 1.0], "flip": True}
        want = run_eval(ecfg, model, ds, aug_test=bool(flags),
                        log_fn=lambda *_: None)
        np.testing.assert_array_equal(got["confusion"], want["confusion"])
        assert got["confusion"].sum() > 0
