"""The port's checkpoint tools (`vitadapter_torch/utils/checkpoint.py`,
`tools/convert.py`, `tools/release.py`) against the JAX package's
(`tools/convert_checkpoint.py`, `utils/checkpoint.py`), on the CPU with a
tiny BEiT-Adapter + Mask2Former: the key remap, the EMA strip and the
relative-position resample; a converted reference checkpoint (wrapped,
`module.`-prefixed, with `ema_` copies, resampled to another grid) gives
the weights JAX's converter gives, carried over; a released train
checkpoint holds the EMA or the raw parameters, and both files load
through `tools.test`."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from vitadapter.utils import checkpoint as jck
from vitadapter_torch.builder import build_model
from vitadapter_torch.tools import convert as convert_cli
from vitadapter_torch.tools import release as release_cli
from vitadapter_torch.tools import test as test_cli
from vitadapter_torch.train.loop import build_dataset, eval_config, run_eval
from vitadapter_torch.train.optim import make_optimizer
from vitadapter_torch.train.trainer import TrainState
from vitadapter_torch.utils import checkpoint as tck
from vitadapter_torch.utils.checkpoint_io import (load_model_weights,
                                                  save_checkpoint)
from vitadapter_torch.utils.config import Config
from vitadapter_torch.utils.weights import state_dict_from_flax

from test_torch_cli import _config
from torch_port_util import randomize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = dict(log_fn=lambda *_: None)
EVAL = ["--device", "cpu", "--max-images", "2"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make these small eager ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jtool():
    """The JAX package's `tools/convert_checkpoint.py`, loaded from its
    path."""
    path = os.path.join(ROOT, "tools", "convert_checkpoint.py")
    spec = importlib.util.spec_from_file_location("jax_convert_checkpoint",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tiny config of `tests/test_torch_cli.py` with its colour-task
    data, and a model of it with random weights."""
    tmp = tmp_path_factory.mktemp("ckpt_tools")
    cfg_path = _config(tmp)
    cfg = Config.fromfile(cfg_path)
    model = build_model(dict(cfg.model), device="cpu")
    randomize(model, 3)
    return dict(tmp=tmp, cfg_path=cfg_path, cfg=cfg, model=model)


def _ema_name(k):
    return "ema_" + k.replace(".", "_")


def test_remap_uniperceiver_keys_equals_jax(jtool):
    sd = {k: torch.full((2,), float(i)) for i, k in enumerate((
        "fused_encoder.0.self_attn.in_proj_weight",
        "fused_encoder.0.self_attn.in_proj_bias",
        "video_embed.patch_embed.weight", "layers.1.linear1.weight",
        "visual_embed.x"))}
    got = tck.remap_uniperceiver_keys(sd)
    want = jtool.remap_uniperceiver_keys(sd)
    assert list(got) == list(want) == [
        "layers.0.self_attn.in_proj.weight", "layers.0.self_attn.in_proj.bias",
        "visual_embed.patch_embed.weight", "layers.1.linear1.weight",
        "visual_embed.x"]
    assert all(got[k] is want[k] for k in got)


def test_strip_ema_equals_jax_where_names_survive(jtool, setup):
    """Where no name holds an underscore JAX's rule names the EMA weights
    back, and both functions agree; without EMA weights both drop the
    optimizer and meta entries. On a real model's keys JAX's rule mangles
    every name with an underscore (`backbone.cls_token` ->
    `backbone.cls.token`); the port replaces each bare entry by its own
    EMA copy, and where only the parameters have one (mmcv's `EMAHook`)
    keeps the buffers' bare entries."""
    t = [torch.full((1,), float(i)) for i in range(6)]
    sd = {"a.b": t[0], "ema_a_b": t[1], "c.d.weight": t[2],
          "ema_c_d_weight": t[3], "optimizer.state": t[4], "meta": t[5]}
    for case in (sd, {k: v for k, v in sd.items()
                      if not k.startswith("ema_")}):
        got, want = tck.strip_ema(case), jtool.strip_ema(case)
        assert list(got) == list(want)
        assert all(got[k] is want[k] for k in got)
    assert list(tck.strip_ema(sd)) == ["a.b", "c.d.weight"]
    real = setup["model"].state_dict()
    wrapped = {**real, **{_ema_name(k): v for k, v in real.items()}}
    assert "backbone.cls.token" in jtool.strip_ema(wrapped)
    got = tck.strip_ema(wrapped)
    assert list(got) == list(real)
    assert all(got[k] is real[k] for k in real)
    avg = {k: p.detach() + 1 for k, p in
           setup["model"].named_parameters()}
    assert any(k.endswith("running_mean") for k in real)
    got = tck.strip_ema({**real, **{_ema_name(k): v for k, v in avg.items()}})
    assert list(got) == list(real)
    assert all(got[k] is avg.get(k, real[k]) for k in real)


@pytest.mark.parametrize("n_extra", [3, 0])
def test_resample_rel_pos_table_equals_jax(setup, n_extra):
    """A tiny BEiT's tables (grid 4, 4 heads) to grid 6, with and without
    the 3 cls entries, to 1e-6; the converter's grid and cls detection."""
    table = setup["model"].backbone.blocks[1].attn.\
        relative_position_bias_table.detach().numpy()
    if n_extra == 0:
        table = table[:-3]
    got = tck.resample_rel_pos_table(table, 4, 6, n_extra)
    want = jck.resample_rel_pos_table(table, 4, 6, n_extra)
    assert got.shape == (11 * 11 + n_extra, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tck.resample_table_to(torch.from_numpy(table), 6).numpy(), want,
        rtol=0, atol=1e-6)


def _convert_against_jax(setup, tmp_path, ema_keys):
    """`tools.convert --target-grid 6` on a reference-style file of the
    model's weights (under `state_dict`, `module.` prefixes, the entries of
    `ema_keys` under `ema_` names with zero decoys under their bare names,
    the rest bare) against JAX's `convert_segmentor_checkpoint` of those
    weights at grid 6, carried over by `state_dict_from_flax`; the result
    loads into the model at 96 px."""
    sd = setup["model"].state_dict()
    bare = {k: (torch.zeros_like(v) if k in ema_keys else v)
            for k, v in sd.items()}
    ref = {"state_dict": {**{"module." + k: v for k, v in bare.items()},
                          **{"module." + _ema_name(k): sd[k]
                             for k in ema_keys}},
           "meta": {"iter": 7}}
    src, dst = str(tmp_path / "ref.pth"), str(tmp_path / "port.pth")
    torch.save(ref, src)
    assert convert_cli.main([src, dst, "--target-grid", "6"], **QUIET) == dst
    got = torch.load(dst, weights_only=True)["state_dict"]
    flax = jck.convert_segmentor_checkpoint({"state_dict": sd}, target_grid=6)
    want = state_dict_from_flax(flax["params"], flax["batch_stats"])
    assert set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    assert got["backbone.blocks.0.attn.relative_position_bias_table"].shape \
        == (124, 4)
    cfg = setup["cfg"]
    model = build_model({**dict(cfg.model), "backbone": dict(
        cfg.model["backbone"], img_size=96)}, device="cpu")
    load_model_weights(dst, model)
    for k, v in model.state_dict().items():
        if k in want:
            assert torch.equal(v, got[k]), k
    return want


def test_convert_gives_jax_conversion_carried_over(setup, tmp_path):
    """Every entry, buffers included, under an `ema_` name."""
    _convert_against_jax(setup, tmp_path, set(setup["model"].state_dict()))


def test_convert_keeps_bare_buffers_beside_parameter_ema(setup, tmp_path):
    """Only the parameters under `ema_` names, as mmcv's `EMAHook` saves
    them: the BatchNorm running statistics come from their bare entries."""
    params = {k for k, _ in setup["model"].named_parameters()}
    want = _convert_against_jax(setup, tmp_path, params)
    assert any(k.endswith("running_var") and k not in params for k in want)


def test_converted_file_loads_through_the_test_cli(setup, tmp_path):
    """Without a target grid the converted file gives the bare weights'
    confusion matrix through `tools.test`; `--kind uniperceiver` maps an
    official release's names."""
    sd = setup["model"].state_dict()
    src, dst = str(tmp_path / "ref.pth"), str(tmp_path / "port.pth")
    torch.save({"model": {**{"module." + k: torch.zeros_like(v)
                             for k, v in sd.items()},
                          **{"module." + _ema_name(k): v
                             for k, v in sd.items()}}}, src)
    convert_cli.main([src, dst], **QUIET)
    bare = str(tmp_path / "bare.pth")
    torch.save(sd, bare)
    cfg = setup["cfg_path"]
    got = test_cli.main([cfg, dst, *EVAL], **QUIET)
    want = test_cli.main([cfg, bare, *EVAL], **QUIET)
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
    torch.save({"fused_encoder.0.in_proj_weight": torch.ones(2)}, src)
    convert_cli.main([src, dst, "--kind", "uniperceiver"], **QUIET)
    assert list(torch.load(dst)["state_dict"]) == ["layers.0.in_proj.weight"]


@pytest.mark.parametrize("use_ema", [False, True])
def test_release_gives_ema_or_raw_weights(setup, tmp_path, use_ema):
    """`tools.release` of a `save_checkpoint` of a train state with an EMA:
    the EMA parameters or the raw ones, the model's buffers either way, no
    optimizer state; the file loads through `tools.test`, which gives the
    confusion matrix of `run_eval` on those weights."""
    cfg = setup["cfg"]
    model = setup["model"]
    opt, _ = make_optimizer(model, base_lr=1e-3, weight_decay=0.0, depth=4,
                            layer_decay_rate=0.9, total_steps=4,
                            warmup_steps=0)
    state = TrainState.create(model, opt, ema_decay=0.9)
    g = torch.Generator().manual_seed(11)
    state.ema_params = {n: p + 0.05 * torch.randn(p.shape, generator=g)
                        for n, p in state.ema_params.items()}
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, 3, state)
    out = str(tmp_path / "released.pth")
    args = [ckpt, out] + (["--use-ema"] if use_ema else [])
    assert release_cli.main(args, **QUIET) == out
    released = torch.load(out, weights_only=True)
    assert list(released) == ["state_dict"]
    sd = released["state_dict"]
    raw = model.state_dict()
    assert list(sd) == list(raw)
    params = dict(model.named_parameters())
    for k, v in sd.items():
        want = (state.ema_params[k] if use_ema and k in params else raw[k])
        assert torch.equal(v, want), k
    assert use_ema == any(not torch.equal(sd[k], raw[k]) for k in params)
    ref = build_model(dict(cfg.model), device="cpu")
    ref.load_state_dict(sd)
    want = run_eval(eval_config(cfg), ref, build_dataset(cfg.data, "val"),
                    max_images=2, log_fn=lambda *_: None)
    got = test_cli.main([setup["cfg_path"], out, *EVAL], **QUIET)
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        release_cli.main([str(tmp_path / "none"), out], **QUIET)
