"""Module parity of the port against the JAX package, fp32 on the CPU.

Each JAX module is initialized by flax, its weights are randomized with a
numpy seed (so zero-initialized gammas and MSDA heads carry signal), carried
into the port module by `state_dict_from_flax`, and both run on the same
numpy inputs; tol 2e-4 as PARITY.md holds the JAX package to its torch
oracles.
"""

import jax
import numpy as np
import pytest
import torch

from vitadapter.heads.mask2former import Mask2FormerHead as JHead
from vitadapter.heads.pixel_decoder import MSDeformAttnPixelDecoder as JPix
from vitadapter.layers.norm import LayerNorm2d as JLayerNorm2d
from vitadapter.models import adapter as jadapter
from vitadapter.models.vit import Block as JBlock
from vitadapter.models.vit_adapter import ViTAdapter as JViTAdapter
from vitadapter.ops.msda import MSDeformAttn as JMSDA
from vitadapter_torch.heads.mask2former import Mask2FormerHead
from vitadapter_torch.heads.pixel_decoder import MSDeformAttnPixelDecoder
from vitadapter_torch.layers.norm import LayerNorm2d
from vitadapter_torch.models import adapter as tadapter
from vitadapter_torch.models.vit import Block
from vitadapter_torch.models.vit_adapter import ViTAdapter
from vitadapter_torch.ops.msda import MSDeformAttn
from vitadapter_torch.utils.weights import load_flax

from torch_port_util import (TINY_BACKBONE, TINY_HEAD, randomize_flax,
                             to_np)

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make the small eager ops here many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(jax_module, port_module, seed, *args, **kwargs):
    """flax init -> random weights -> the port module (eval, weights
    loaded). Returns (jax variables, port module)."""
    variables = jax.jit(lambda key: jax_module.init(key, *args, **kwargs))(
        jax.random.PRNGKey(0))
    params = randomize_flax(jax.device_get(variables["params"]), seed)
    stats = None
    if "batch_stats" in variables:
        stats = randomize_flax(jax.device_get(variables["batch_stats"]),
                               seed + 1, stats=True)
    load_flax(port_module, params, stats)
    jvars = {"params": params}
    if stats is not None:
        jvars["batch_stats"] = stats
    return jvars, port_module.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_msdeformattn_parity(ref_dim):
    rng = np.random.RandomState(0)
    shapes = ((6, 5), (3, 3))
    S = sum(h * w for h, w in shapes)
    query = rng.randn(2, 10, 48).astype(np.float32)
    feat = rng.randn(2, S, 48).astype(np.float32)
    ref = rng.rand(2, 10, 2, ref_dim).astype(np.float32)
    mask = rng.rand(2, S) < 0.2
    jm = JMSDA(d_model=48, n_levels=2, n_heads=4, n_points=3, ratio=0.5)
    tm = MSDeformAttn(48, 2, 4, 3, ratio=0.5)
    jvars, tm = _port(jm, tm, 1, query, ref, feat, shapes, mask)
    want = jm.apply(jvars, query, ref, feat, shapes, mask)
    with torch.no_grad():
        got = tm(_t(query), _t(ref), _t(feat), shapes, _t(mask))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_layernorm2d_parity():
    rng = np.random.RandomState(9)
    x = rng.randn(2, 5, 7, 48).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(48)).astype(np.float32)
    b = (0.1 * rng.randn(48)).astype(np.float32)
    want = JLayerNorm2d().apply({"params": {"weight": w, "bias": b}}, x)
    tm = LayerNorm2d(48)
    with torch.no_grad():
        tm.weight.copy_(_t(w))
        tm.bias.copy_(_t(b))
        got = tm(_t(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_vit_block_parity():
    x = np.random.RandomState(1).randn(2, 16, 48).astype(np.float32)
    jm = JBlock(num_heads=4, qkv_bias=True, layer_scale=True)
    jvars, tm = _port(jm, Block(48, 4, qkv_bias=True, layer_scale=True), 2,
                      x, 4, 4)
    with torch.no_grad():
        got = tm(_t(x), 4, 4)
    np.testing.assert_allclose(to_np(got), np.asarray(jm.apply(jvars, x, 4, 4)),
                               **TOL)


def test_spatial_prior_module_parity():
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    jm = jadapter.SpatialPriorModule(inplanes=16, embed_dim=48)
    jvars, tm = _port(jm, tadapter.SpatialPriorModule(16, 48), 3, x)
    want = jm.apply(jvars, x)
    with torch.no_grad():
        got = tm(_t(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)


def test_interaction_block_with_extra_extractors_parity():
    rng = np.random.RandomState(3)
    H = W = 4                       # a 64 x 64 image
    x = rng.randn(2, H * W, 48).astype(np.float32)
    c = rng.randn(2, 21 * H * W // 4, 48).astype(np.float32)
    jm = jadapter.InteractionBlock(num_heads=6, n_points=4,
                                   extra_extractor=True)
    tm = tadapter.InteractionBlock(48, num_heads=6, n_points=4,
                                   extra_extractor=True)
    j_inj, j_ext = jadapter.deform_inputs(64, 64)
    t_inj, t_ext = tadapter.deform_inputs(64, 64)
    jvars, tm = _port(jm, tm, 4, x, c, lambda t: 1.5 * t, j_inj, j_ext, H, W)
    jx, jc = jm.apply(jvars, x, c, lambda t: 1.5 * t, j_inj, j_ext, H, W)
    with torch.no_grad():
        tx, tc = tm(_t(x), _t(c), lambda t: 1.5 * t, t_inj, t_ext, H, W)
    np.testing.assert_allclose(to_np(tx), np.asarray(jx), **TOL)
    np.testing.assert_allclose(to_np(tc), np.asarray(jc), **TOL)


def test_vit_adapter_pyramid_parity():
    x = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    jm = JViTAdapter(**TINY_BACKBONE)
    jvars, tm = _port(jm, ViTAdapter(**TINY_BACKBONE), 5, x)
    want = jax.jit(jm.apply)(jvars, x)
    with torch.no_grad():
        got = tm(_t(x))
    assert [tuple(f.shape) for f in got] == [(2, 16, 16, 48), (2, 8, 8, 48),
                                             (2, 4, 4, 48), (2, 2, 2, 48)]
    for lvl, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL,
                                   err_msg=f"pyramid level {lvl}")


def _feats(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, r, r, 48).astype(np.float32) for r in (16, 8, 4, 2)]


def test_pixel_decoder_parity():
    feats = _feats(5)
    jm = JPix(feat_channels=64, out_channels=64, num_heads=4, ffn_dim=96,
              num_feats=32)
    tm = MSDeformAttnPixelDecoder([48] * 4, 64, 64, num_heads=4, ffn_dim=96,
                                  num_feats=32)
    jvars, tm = _port(jm, tm, 6, feats)
    jmf, jmem = jax.jit(jm.apply)(jvars, feats)
    with torch.no_grad():
        tmf, tmem = tm([_t(f) for f in feats])
    np.testing.assert_allclose(to_np(tmf), np.asarray(jmf), **TOL)
    for g, w in zip(tmem, jmem):
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)


def test_mask2former_head_all_outputs_parity():
    """All 10 cls/mask outputs of the eval forward, with the knife-edge
    guard of test_torch_parity: the attention-mask logits nearest 0 must
    clear fp32 cross-implementation noise."""
    feats = _feats(6)
    jm = JHead(**TINY_HEAD)
    tm = Mask2FormerHead([48] * 4, **TINY_HEAD)
    jvars, tm = _port(jm, tm, 8, feats)
    jcls, jmask = jax.jit(jm.apply)(jvars, feats)

    margins = []
    forward_head = tm._forward_head

    def spy(decoder_out, mask_feature, mf_small, full):
        x = tm.transformer_decoder.post_norm(decoder_out)
        am = torch.einsum("bqc,bhwc->bqhw", tm.mask_embed(x), mf_small)
        margins.append(float(am.abs().min()))
        return forward_head(decoder_out, mask_feature, mf_small, full)

    tm._forward_head = spy
    with torch.no_grad():
        tcls, tmask = tm([_t(f) for f in feats], all_masks=True)
    assert len(tcls) == len(jcls) == 10
    for i in range(10):
        np.testing.assert_allclose(to_np(tcls[i]), np.asarray(jcls[i]),
                                   **TOL, err_msg=f"cls layer {i}")
        np.testing.assert_allclose(to_np(tmask[i]), np.asarray(jmask[i]),
                                   rtol=2e-4, atol=3e-4,
                                   err_msg=f"mask layer {i}")
    # the last layer's attention mask is not used
    assert min(margins[:-1]) > 1e-4, margins
