"""The port's MaskFormer head (`heads/maskformer.py`, `utils/weights.py::
maskformer_head_from_flax`) against the JAX package on the CPU, in fp32
within 2e-4 of each output's scale: every decoder layer's class and mask
logits with the plain and with the encoder pixel decoder; the converter's
round trip through JAX's `convert_maskformer_head` and the routing of
`convert_segmentor_checkpoint`; one `make_m2f_train_step` of the tiny
segmentor with the MaskFormer head (the loss and its logs 1e-4, as
`test_torch_train_step.py`); and the shipped config: as in JAX its plain
decoder's memory is the 1024-wide BEiT map and its first forward raises
`memory dim mismatch`, and with `use_encoder_decoder=True` it builds with
JAX's parameter count."""

import os

import jax
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from vitadapter.builder import build_model as jbuild_model
from vitadapter.heads import mask2former_loss as jloss
from vitadapter.heads.maskformer import MaskFormerHead as JHead
from vitadapter.models.mask2former_segmentor import \
    EncoderDecoderMask2Former as JSeg
from vitadapter.models.vit_adapter import ViTAdapter as JViTAdapter
from vitadapter.ops import matching as jmatching
from vitadapter.train import optim as joptim
from vitadapter.train import trainer as jtrainer
from vitadapter.utils.checkpoint import (convert_maskformer_head,
                                         convert_segmentor_checkpoint)
from vitadapter.utils.config import Config as JConfig
from vitadapter_torch import builder
from vitadapter_torch.builder import build_model
from vitadapter_torch.heads import mask2former_loss as tloss
from vitadapter_torch.heads.maskformer import MaskFormerHead
from vitadapter_torch.models.mask2former_segmentor import \
    EncoderDecoderMask2Former
from vitadapter_torch.models.vit_adapter import ViTAdapter
from vitadapter_torch.train import optim as toptim
from vitadapter_torch.train import trainer as ttrainer
from vitadapter_torch.utils.config import Config, parse_cfg_options
from vitadapter_torch.utils.weights import (load_flax,
                                            maskformer_head_from_flax)

from torch_port_util import (TINY_TRAIN, TINY_TRAIN_BACKBONE, ReplaySampler,
                             assert_close, jax_loss_draws, randomize_flax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4
C = 64
HEAD = dict(num_classes=7, num_queries=5, feat_channels=C, out_channels=C,
            num_decoder_layers=3, num_heads=4, decoder_ffn_dim=96,
            pixel_encoder_layers=2, pixel_encoder_ffn_dim=96)
CONFIG = "configs/ade20k/maskformer_beit_adapter_large_640_160k_ade20k_ss.py"
# JAX's `eval_shape` of the shipped config with `use_encoder_decoder=True`
PARAMETERS = 350_383_959


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores (see test_torch_upernet)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flax_head(encoder: bool, feats, seed: int):
    jm = JHead(use_encoder_decoder=encoder, **HEAD)
    p = randomize_flax(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), feats))["params"], seed)
    return jm, p


@pytest.mark.parametrize("encoder", [False, True])
def test_head_outputs_match_jax(encoder):
    """Every layer's class logits (B, Q, K+1) and stride-4 mask logits on
    a 4-level pyramid of 64 channels (the plain decoder's memory is the
    coarsest map itself)."""
    rs = np.random.RandomState(1)
    feats = [rs.randn(2, h, h + 2, C).astype(np.float32)
             for h in (16, 8, 4, 2)]
    jm, p = flax_head(encoder, feats, 2)
    want = jax.jit(lambda p, f: jm.apply({"params": p}, f))(p, feats)
    port = MaskFormerHead([C] * 4, use_encoder_decoder=encoder, **HEAD)
    port.load_state_dict(maskformer_head_from_flax(p))
    with torch.no_grad():
        got = port([torch.from_numpy(f) for f in feats])
    assert len(got[0]) == len(got[1]) == HEAD["num_decoder_layers"]
    for i, (gc, gm, wc, wm) in enumerate(zip(*got, *want)):
        assert_close(gc, wc, TOL, f"cls {i}")
        assert_close(gm, wm, TOL, f"mask {i}")
    assert tuple(got[1][0].shape) == (2, 5, 16, 18)


@pytest.mark.parametrize("encoder", [False, True])
def test_converter_round_trip_and_segmentor_routing(encoder):
    """The port's keys read by JAX's `convert_maskformer_head` give back
    the flax head; a whole segmentor's `state_dict()` goes to that
    converter through `convert_segmentor_checkpoint`'s routing."""
    feats = [np.zeros((1, h, h, C), np.float32) for h in (16, 8, 4, 2)]
    _, p = flax_head(encoder, feats, 3)
    port = MaskFormerHead([C] * 4, use_encoder_decoder=encoder, **HEAD)
    port.load_state_dict(maskformer_head_from_flax(p))
    sd = {"decode_head." + k: v for k, v in port.state_dict().items()}
    key = ("encoder_out_proj" if encoder else "last_feat_conv")
    assert f"decode_head.pixel_decoder.{key}.conv.weight" in sd
    back = convert_maskformer_head(sd)
    flat_w = jax.tree_util.tree_flatten_with_path(p)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_b) == len(flat_w)
    for path, leaf in flat_w:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf))
    seg = EncoderDecoderMask2Former(
        ViTAdapter(**TINY_TRAIN_BACKBONE, device="meta"),
        MaskFormerHead([48] * 4, **HEAD, use_encoder_decoder=True,
                       device="meta") if encoder else
        MaskFormerHead([48, 48, 48, C], **HEAD, device="meta"))
    full = {k: torch.zeros(v.shape) for k, v in seg.state_dict().items()}
    routed = convert_segmentor_checkpoint(full)["params"]["decode_head"]
    assert "post_norm" in routed and "query_feat" not in routed
    assert ("encoder_in_proj" in routed["pixel_decoder"]) == encoder


def assignment_margin(cost: np.ndarray, n: int) -> float:
    """The optimal assignment's total cost on the `n` valid gts against
    the next best one's (each optimal pair forbidden in turn)."""
    c = cost[:, :n]
    r, col = linear_sum_assignment(c)
    gaps = []
    for i, j in zip(r, col):
        f = c.copy()
        f[i, j] = 1e9
        r2, c2 = linear_sum_assignment(f)
        gaps.append(f[r2, c2].sum() - c[r, col].sum())
    return min(gaps)


def test_m2f_train_step_with_the_maskformer_head_matches_jax():
    """One `make_m2f_train_step` of the tiny ViT-Adapter segmentor with the
    MaskFormer head (encoder decoder, 3 outputs through the point-sampled
    loss), the port's sampler replaying JAX's draws and both sides matched
    by scipy's exact solver (JAX's `callback` matching; the two packages'
    eps-auctions split this seed's near-optimal matches of an early layer
    differently), each matching asserted 1e-4 clear of its next best: the
    loss, its parts and the gradient norm within 1e-4."""
    head = dict(HEAD, use_encoder_decoder=True, pixel_encoder_layers=1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jloss, "hungarian_assign",
               lambda c, n: jmatching.hungarian_assign(c, n, "callback"))
    jm = JSeg(backbone=JViTAdapter(**TINY_TRAIN_BACKBONE),
              decode_head=JHead(**head))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            np.zeros((1, 64, 64, 3), np.float32))
    params = randomize_flax(shapes["params"], 50)
    stats = randomize_flax(shapes["batch_stats"], 51, stats=True)
    rs = np.random.RandomState(52)
    label = rs.randint(0, head["num_classes"], (2, 64, 64))
    label[1, :8] = 255
    batch = {"image": rs.randn(2, 64, 64, 3).astype(np.float32),
             "label": label.astype(np.int32)}
    opt = dict(base_lr=1e-4, depth=2, total_steps=1000, warmup_steps=0)
    tx, _ = joptim.make_optimizer(params, **opt)
    step = jax.jit(jtrainer.make_m2f_train_step(
        jm, head["num_classes"], **TINY_TRAIN))
    rng = jax.random.PRNGKey(53)
    _, jlogs = step(jtrainer.TrainState.create(params, stats, tx), batch,
                    rng)

    model = EncoderDecoderMask2Former(ViTAdapter(**TINY_TRAIN_BACKBONE),
                                      MaskFormerHead([48] * 4, **head))
    load_flax(model, params, stats)
    optimizer, _ = toptim.make_optimizer(model, **opt)
    costs = []

    def scipy_assign(cost, n_valid):
        costs.append((cost.double().numpy(), n_valid.tolist()))
        out = torch.full(cost.shape[:2], -1, dtype=torch.long)
        for b, (c, n) in enumerate(zip(*costs[-1])):
            r, col = linear_sum_assignment(c[:, :n])
            out[b, torch.from_numpy(r)] = torch.from_numpy(col)
        return out

    mp.setattr(tloss, "hungarian_assign", scipy_assign)
    _, r_loss = jax.random.split(rng)
    sampler = ReplaySampler(jax_loss_draws(
        r_loss, head["num_decoder_layers"], 2, head["num_queries"],
        TINY_TRAIN["num_points"]))
    _, tlogs = ttrainer.make_m2f_train_step(
        model, head["num_classes"], **TINY_TRAIN)(
        ttrainer.TrainState.create(model, optimizer),
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0), sampler)
    mp.undo()
    assert sampler.done()
    assert min(assignment_margin(c, n) for cb, nb in costs
               for c, n in zip(cb, nb)) > 1e-4
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


TINY_BEIT = ["model.backbone.depth=2", "model.backbone.embed_dim=48",
             "model.backbone.num_heads=4",
             "model.backbone.deform_num_heads=4",
             "model.backbone.conv_inplane=16", "model.backbone.img_size=64",
             "model.backbone.interaction_indexes=[[0,0],[1,1]]"]


def test_shipped_config_memory_mismatch_raises_as_in_jax():
    """The shipped config's plain pixel decoder hands the backbone's own
    coarsest map to the decoder as memory: with any backbone wider than
    the head's 256 channels (here a 48-wide BEiT-Adapter) both packages
    raise `memory dim mismatch` at the first forward (JAX's at `init`)."""
    path = os.path.join(ROOT, CONFIG)
    cfg = Config.fromfile(path)
    cfg.merge_from_options(parse_cfg_options(TINY_BEIT))
    model = build_model(dict(cfg.model), device="cpu")
    with pytest.raises(ValueError, match="memory dim mismatch"):
        model(torch.zeros(1, 64, 64, 3))
    jcfg = JConfig.fromfile(path)
    jcfg.merge_from_options(parse_cfg_options(TINY_BEIT))
    jm = jbuild_model(dict(jcfg.model))
    with pytest.raises(ValueError, match="memory dim mismatch"):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32))


def test_config_with_the_encoder_decoder_parameter_count_matches_jax():
    """With `model.decode_head.use_encoder_decoder=True` (the encoder's
    1x1 input projection takes the 1024-wide map to 256) the config builds
    with JAX's parameter count."""
    path = os.path.join(ROOT, CONFIG)
    opt = {"model.decode_head.use_encoder_decoder": True}
    cfg = Config.fromfile(path)
    cfg.merge_from_options(opt)
    model = builder.build(dict(cfg.model))
    assert isinstance(model.decode_head, MaskFormerHead)
    got = sum(p.numel() for p in model.parameters())
    jcfg = JConfig.fromfile(path)
    jcfg.merge_from_options(opt)
    shapes = jax.eval_shape(jbuild_model(dict(jcfg.model)).init,
                            jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 640, 640, 3),
                                                 np.float32))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert got == want == PARAMETERS
