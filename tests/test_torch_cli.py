"""The port's config-driven entry points (`vitadapter_torch/tools/train.py`
and `tools/test.py`, through `train/loop.py::run_training` and
`utils/checkpoint_io.py`) on the CPU, with a tiny BEiT-Adapter +
Mask2Former: a checkpoint restores the train state bitwise, `--resume`
starts at the saved step with the schedule's learning rate, the eval hook
keeps the best step, the test CLI reports what `run_eval` gives, and the
model learns the colour task of `tests/test_m2f_cli_learns.py`."""

import os
import re

import numpy as np
import pytest
import torch

from vitadapter_torch.builder import build_model
from vitadapter_torch.tools import test as test_cli
from vitadapter_torch.tools import train as train_cli
from vitadapter_torch.train.loop import (build_dataset, eval_config,
                                         run_eval)
from vitadapter_torch.train.optim import (make_optimizer,
                                          poly_schedule_with_warmup)
from vitadapter_torch.train.trainer import TrainState
from vitadapter_torch.utils import checkpoint_io
from vitadapter_torch.utils.config import Config

from test_m2f_cli_learns import write_color_task
from torch_port_util import UNIPERCEIVER_TINY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make these small eager ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CFG = """
model = dict(
    type="EncoderDecoderMask2Former",
    backbone=dict(
        type="BEiTAdapter", img_size=64, patch_size=16, embed_dim=48,
        depth=4, num_heads=4, mlp_ratio=4.0, qkv_bias=True,
        use_abs_pos_emb=False, use_rel_pos_bias=True, init_values=1e-6,
        drop_path_rate={drop_path}, conv_inplane=16, n_points=4,
        deform_num_heads=6, cffn_ratio=0.25, deform_ratio=0.5,
        with_cp=True, interaction_indexes=[[0, 0], [1, 1], [2, 2], [3, 3]]),
    decode_head=dict(
        type="Mask2FormerHead", num_classes=4, num_queries=8,
        feat_channels=64, out_channels=64, num_decoder_layers=3,
        num_heads=4, decoder_ffn_dim=128, pixel_encoder_ffn_dim=128,
        pixel_encoder_heads=4),
)
train_cfg = dict(max_instances=8, num_points=256)
data = dict(
    dataset_type="PascalContextDataset", data_root={root!r},
    train=dict(img_dir="train/img", ann_dir="train/ann"),
    val=dict(img_dir="val/img", ann_dir="val/ann"),
    crop_size=[64, 64], samples_per_chip=1, scale=[64, 64],
    ratio_range=[1.0, 1.0], cat_max_ratio=1.0, workers=2)
runner = dict(max_iters={iters})
optimizer = dict(lr=3e-3, weight_decay=1e-4, layer_decay_rate=0.9)
lr_config = dict(policy="poly", warmup_iters=4, power=1.0)
log_config = dict(interval={log})
checkpoint_config = dict(interval=2, max_keep_ckpts=1)
evaluation = dict(interval={ev}, metric="mIoU", save_best="mIoU",
                  max_images=4)
test_cfg = dict(mode="slide", crop_size=[64, 64], stride=[43, 43])
"""


def _config(tmp_path, iters=2, log=1, ev=2, drop_path=0.1):
    root = tmp_path / "data"
    if not root.exists():
        write_color_task(str(root), "train", 16, 0)
        write_color_task(str(root), "val", 8, 100)
    path = tmp_path / "beit_m2f_tiny.py"
    path.write_text(CFG.format(root=str(root), iters=iters, log=log, ev=ev,
                               drop_path=drop_path))
    return str(path)


def _fresh_state(cfg_path):
    """A new model and optimizer as `run_training` builds them."""
    cfg = Config.fromfile(cfg_path)
    model = build_model(dict(cfg.model), device="cpu")
    opt, _ = make_optimizer(
        model, base_lr=cfg.optimizer["lr"],
        weight_decay=cfg.optimizer["weight_decay"],
        depth=cfg.model["backbone"]["depth"],
        layer_decay_rate=cfg.optimizer["layer_decay_rate"],
        total_steps=cfg.runner["max_iters"],
        warmup_steps=cfg.lr_config["warmup_iters"])
    return TrainState.create(model, opt)


def _by_name(state):
    """(parameters, AdamW state) of a train state, by parameter name."""
    names = {p: n for n, p in state.model.named_parameters()}
    return ({n: p.detach().clone() for n, p in state.model.named_parameters()},
            {names[p]: {k: v.clone() for k, v in s.items()}
             for p, s in state.optimizer.adamw.state.items()})


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two steps through the train CLI; the saved step restored into a new
    state; then one more step with `--resume`."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg = _config(tmp)
    work = str(tmp / "work")
    logs = []
    state = train_cli.main([cfg, "--work-dir", work, "--device", "cpu"],
                           log_fn=logs.append)
    restored = _fresh_state(cfg)
    checkpoint_io.restore_checkpoint(os.path.join(work, "ckpt"), restored)
    best_steps = checkpoint_io.saved_steps(os.path.join(work, "best_mIoU"))
    resumed_logs = []
    resumed = train_cli.main([cfg, "--work-dir", work, "--device", "cpu",
                              "--resume", "--max-iters", "3"],
                             log_fn=resumed_logs.append)
    return dict(cfg=cfg, work=work, logs=logs, state=state,
                restored=restored, best_steps=best_steps, resumed=resumed,
                resumed_logs=resumed_logs, tmp=tmp)


def test_checkpoint_restores_the_train_state_bitwise(trained):
    """Parameters, BatchNorm statistics, AdamW moments and step counts, the
    scheduler's position and the step, after 2 steps."""
    state, restored = trained["state"], trained["restored"]
    assert state.step == restored.step == 2
    params, moments = _by_name(state)
    got_params, got_moments = _by_name(restored)
    for n, p in params.items():
        assert torch.equal(got_params[n], p), n
    for n, b in state.model.named_buffers():
        assert torch.equal(dict(restored.model.named_buffers())[n], b), n
    assert set(got_moments) == set(moments) and moments
    for n, s in moments.items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got_moments[n][k], s[k]), (n, k)
    assert (restored.optimizer.scheduler.last_epoch
            == state.optimizer.scheduler.last_epoch == 2)
    assert ([g["lr"] for g in restored.optimizer.adamw.param_groups]
            == [g["lr"] for g in state.optimizer.adamw.param_groups])
    assert trained["best_steps"] == [2]


def test_train_cli_logs_checkpoints_and_keeps_the_best(trained):
    """The eval hook keeps the best step in `best_mIoU`; `max_keep_ckpts`
    1 leaves only the resumed run's last step in `ckpt`."""
    logs = trained["logs"]
    assert any(line.startswith("iter 2/2 loss=") for line in logs)
    assert any("new best mIoU=" in line for line in logs)
    assert any(re.search(r"checkpoint of step 2: \d+ bytes", line)
               for line in logs)
    assert checkpoint_io.saved_steps(os.path.join(trained["work"],
                                                  "ckpt")) == [3]


def test_resume_starts_at_the_saved_step_with_the_schedules_lr(trained):
    logs = trained["resumed_logs"]
    assert "resumed from step 2" in logs
    iter_lines = [line for line in logs if re.match(r"iter \d+/", line)]
    assert len(iter_lines) == 1 and iter_lines[0].startswith("iter 3/3")
    # the poly schedule of a 3-step run at step 2 (the log's lr)
    lr = float(re.search(r"lr=(\S+)", iter_lines[0]).group(1))
    assert lr == pytest.approx(poly_schedule_with_warmup(3e-3, 3, 4)(2),
                               rel=1e-3)
    resumed = trained["resumed"]
    assert resumed.step == resumed.optimizer.scheduler.last_epoch == 3
    # the update of step 3 took the schedule's lr times each group's scale
    assert resumed.optimizer.scheduler.get_last_lr() == [
        g["lr"] for g in resumed.optimizer.adamw.param_groups]


def test_test_cli_reports_run_evals_miou(trained):
    cfg, work = trained["cfg"], trained["work"]
    logs = []
    got = test_cli.main([cfg, os.path.join(work, "ckpt"), "--eval", "mIoU",
                         "--device", "cpu"], log_fn=logs.append)
    model = build_model(dict(Config.fromfile(cfg).model), device="cpu")
    checkpoint_io.load_model_weights(os.path.join(work, "ckpt"), model)
    config = Config.fromfile(cfg)
    want = run_eval(eval_config(config), model,
                    build_dataset(config.data, "val"), log_fn=lambda *_: None)
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
    assert got["mIoU"] == want["mIoU"]
    assert f"mIoU {want['mIoU'] * 100:.2f}" in logs[-1]
    # a .pth holding the port's (the reference's) keys gives the same
    pth = os.path.join(str(trained["tmp"]), "weights.pth")
    torch.save({"state_dict": model.state_dict()}, pth)
    again = test_cli.main([cfg, pth, "--device", "cpu", "--aug-test",
                           "--cfg-options", "aug_test.img_ratios=[1.0]"],
                          log_fn=lambda *_: None)
    flip = run_eval({**eval_config(config),
                     "aug_test": {"img_ratios": [1.0], "flip": True}},
                    model, build_dataset(config.data, "val"), aug_test=True,
                    log_fn=lambda *_: None)
    np.testing.assert_array_equal(again["confusion"], flip["confusion"])


def test_cli_refusals(tmp_path, monkeypatch):
    """What is not ported raises and names its ROADMAP item; the UperNet
    Uni-Perceiver config (shrunk) trains into the TypeError naming `refer`
    at its first forward, as the JAX package does; no CUDA and no
    `--device` raises."""
    cfg = _config(tmp_path)
    detector = os.path.join(ROOT, "configs/atss/atss_deit_adapter_small_"
                            "fpn_3x_coco.py")
    with pytest.raises(KeyError, match="item 7"):
        test_cli.main([detector, "x.pth", "--eval", "bbox", "--device",
                       "cpu"])
    with pytest.raises(KeyError, match="item 7"):
        train_cli.main([detector, "--work-dir", str(tmp_path / "d"),
                        "--device", "cpu"])
    upernet = os.path.join(ROOT, "configs/ade20k/upernet_uniperceiver_"
                           "adapter_large_512_160k_ade20k.py")
    with pytest.raises(TypeError, match="refer"):
        train_cli.main([upernet, "--work-dir", str(tmp_path / "u"),
                        "--device", "cpu", "--synthetic-data",
                        "--max-iters", "1", "--cfg-options",
                        *UNIPERCEIVER_TINY, "model.decode_head.channels=32",
                        "model.auxiliary_head.channels=16",
                        "data.crop_size=[64,64]", "data.samples_per_chip=1"],
                       log_fn=lambda *_: None)
    with pytest.raises(SystemExit):
        test_cli.parse_args([cfg, "x.pth", "--eval", "nope"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main([cfg, "--work-dir", str(tmp_path / "w")])


def test_beit_mask2former_learns_the_colour_task(tmp_path):
    """Pixels encode their class: the tiny model trained through the CLI
    must reach an mIoU far above chance (about 0.1 on 4 classes)."""
    cfg = _config(tmp_path, iters=60, log=30, ev=30, drop_path=0.0)
    logs = []
    train_cli.main([cfg, "--work-dir", str(tmp_path / "work"), "--device",
                    "cpu"], log_fn=logs.append)
    bests = [float(m.group(1)) for m in
             (re.search(r"new best mIoU=([0-9.]+)", line) for line in logs)
             if m]
    assert bests and max(bests) > 0.5, logs


def test_profiling_utilities_on_the_cpu(tmp_path):
    """`trace` writes a Chrome trace; `StepTimer` times on the host clock
    where the device is the CPU; no CUDA, no memory statistics."""
    from vitadapter_torch.utils import profiling

    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    timer = profiling.StepTimer("cpu")
    timer.step()
    timer.step()
    timer.data_tick(0.5)
    s = timer.summary(total_steps_left=10)
    assert s["time"] >= 0 and s["data_time"] == 0.25
    assert s["eta_hours"] == pytest.approx(s["time"] * 10 / 3600)
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}
