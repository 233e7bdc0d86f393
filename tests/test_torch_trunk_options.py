"""The trunk options of the JAX package that no shipped config sets, in the
port (`vitadapter_torch/models/vit.py::ResBottleneckBlock`,
`models/beit.py`, `layers/patch_embed.py::HybridEmbed`), against their
JAX modules on the CPU in fp32 at 2e-4 of scale, the weights carried over
by `utils/weights.py`: the residual bottleneck alone and after blocks of a
ViT-Adapter (`residual_indices`, its zero-initialised last norm set to
random values so that the branch counts), and BEiT without the qkv bias,
with an absolute position embedding resampled from another grid, without
the relative-position bias, and on a two-conv hybrid stem."""

import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

from vitadapter.models import beit as jbeit
from vitadapter.models import vit as jvit
from vitadapter.models.vit_adapter import ViTAdapter as JViTAdapter
from vitadapter_torch.layers.linear import Conv2d, conv_nhwc
from vitadapter_torch.models import beit as tbeit
from vitadapter_torch.models import vit as tvit
from vitadapter_torch.models.vit_adapter import ViTAdapter
from vitadapter_torch.utils import weights
from vitadapter_torch.utils.init import init_weights

from torch_port_util import (TINY_BACKBONE, assert_close, flax_variables,
                             port_like, randomize_flax)

TOL = 2e-4
BEIT = dict(img_size=64, patch_size=16, embed_dim=48, depth=2, num_heads=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make these small eager ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(h, w, seed=0):
    return np.random.RandomState(seed).randn(1, h, w, 3).astype(np.float32)


def _norm3_random(tree, seed):
    """Every ResBottleneckBlock's zero-initialised last norm set to
    N(0, 1), so that the branch counts."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _norm3_random(v, seed + 1)
        elif k in ("norm3_weight", "norm3_bias"):
            out[k] = rng.randn(*np.shape(v)).astype(np.float32)
        else:
            out[k] = v
    return out


def test_res_bottleneck_block_matches_jax():
    x = np.random.RandomState(0).randn(1, 4, 6, 48).astype(np.float32)
    jm = jvit.ResBottleneckBlock(out_channels=48, bottleneck_channels=24)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x), x)
    params = _norm3_random(randomize_flax(shapes["params"], 1), 2)
    want = jax.jit(jm.apply)({"params": params}, x)
    tm = init_weights(tvit.ResBottleneckBlock(48, 24, device="meta")
                      .to_empty(device="cpu"),
                      torch.Generator().manual_seed(0))
    assert not tm.norm3.weight.detach().any()
    tm.load_state_dict(weights.state_dict_from_flax(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert_close(got - torch.from_numpy(x), np.asarray(want) - x, TOL)
    assert_close(got, want, TOL)


def test_vit_adapter_with_residual_blocks_matches_jax():
    x = _image(64, 96)
    kw = dict(TINY_BACKBONE, residual_indices=(1, 3))
    jm = JViTAdapter(**kw)
    v = flax_variables(jm, x, 3)
    v["params"] = _norm3_random(v["params"], 4)
    want = jax.jit(jm.apply)(v, x)
    tm = port_like(ViTAdapter(**kw, device="meta"), v)
    assert [i for i, b in enumerate(tm.blocks) if b.use_residual] == [1, 3]
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert_close(g, w, TOL)


class JStem(fnn.Module):
    """A two-conv NHWC stem, stride 16, returning both maps."""

    @fnn.compact
    def __call__(self, x):
        a = jax.nn.relu(fnn.Conv(16, (4, 4), strides=(4, 4), padding="VALID",
                                 name="conv1")(x))
        return [a, fnn.Conv(32, (4, 4), strides=(4, 4), padding="VALID",
                            name="conv2")(a)]


class TStem(torch.nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.conv1 = Conv2d(3, 16, 4, stride=4, device=device)
        self.conv2 = Conv2d(16, 32, 4, stride=4, device=device)

    def forward(self, x):
        a = torch.relu(conv_nhwc(self.conv1, x))
        return [a, conv_nhwc(self.conv2, a)]


BEIT_OPTIONS = {
    "no_qkv_bias": (dict(qkv_bias=False), (64, 64)),
    # a 4x4 pretrain grid resampled to the 6x6 patch grid of 96 px
    "abs_pos_emb": (dict(use_abs_pos_emb=True, pretrain_size=64,
                         img_size=96), (96, 96)),
    # no table, so a non-square grid
    "no_rel_pos_bias": (dict(use_rel_pos_bias=False), (64, 96)),
    "hybrid_stem": (dict(hybrid_backbone="stem"), (64, 64)),
    "all_but_the_stem": (dict(qkv_bias=False, use_abs_pos_emb=True,
                              pretrain_size=64, use_rel_pos_bias=False),
                         (64, 96)),
}


@pytest.mark.parametrize("name", sorted(BEIT_OPTIONS))
def test_beit_option_matches_jax(name):
    opts, (h, w) = BEIT_OPTIONS[name]
    jopts, topts = dict(opts), dict(opts)
    if opts.get("hybrid_backbone"):
        jopts["hybrid_backbone"] = JStem()
        topts["hybrid_backbone"] = TStem(device="meta")
    x = _image(h, w, 5)
    jm = jbeit.BEiT(**{**BEIT, **jopts})
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x), x)
    params = randomize_flax(shapes["params"], 6)
    want = jax.jit(jm.apply)({"params": params}, x)
    tm = tbeit.BEiT(**{**BEIT, **topts}, device="meta")
    tm = init_weights(tm.to_empty(device="cpu"),
                      torch.Generator().manual_seed(0)).eval()
    sd = weights._beit_trunk(params)
    if opts.get("hybrid_backbone"):
        stem = params["hybrid_backbone"]
        for conv in ("conv1", "conv2"):
            sd.update(weights._prefixed(f"patch_embed.backbone.{conv}",
                                        weights._conv(stem[conv])))
    tm.load_state_dict(sd)
    attn = tm.blocks[0].attn
    assert hasattr(attn, "q_bias") == opts.get("qkv_bias", True)
    assert (attn.rel_pos_grid is None) == (not opts.get("use_rel_pos_bias",
                                                        True))
    assert hasattr(tm, "pos_embed") == opts.get("use_abs_pos_emb", False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (1, 1 + h * w // 256, 48)
    assert_close(got, want, TOL)
