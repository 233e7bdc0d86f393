"""The port's Mask2Former + ViT-Adapter segmentor against the JAX package:
end-to-end logits from uint8 images (fp32, CPU, tiny widths; square and
non-square), and the
weight round trip through the JAX package's converters."""

import jax
import numpy as np
import pytest
import torch

from vitadapter.data.preprocess import normalize as jnormalize
from vitadapter.heads.mask2former import Mask2FormerHead as JHead
from vitadapter.models.mask2former_segmentor import \
    EncoderDecoderMask2Former as JSegmentor
from vitadapter.models.vit_adapter import ViTAdapter as JViTAdapter
from vitadapter.utils.checkpoint import (convert_mask2former_head,
                                         convert_vit_adapter_backbone)
from vitadapter_torch.data.preprocess import normalize
from vitadapter_torch.heads.mask2former import Mask2FormerHead
from vitadapter_torch.models.mask2former_segmentor import \
    EncoderDecoderMask2Former
from vitadapter_torch.models.vit_adapter import ViTAdapter
from vitadapter_torch.utils.weights import load_flax, state_dict_from_flax

from torch_port_util import TINY_BACKBONE, TINY_HEAD, randomize


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make the small eager ops here many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_segmentor(seed):
    model = EncoderDecoderMask2Former(
        ViTAdapter(**TINY_BACKBONE),
        Mask2FormerHead([TINY_BACKBONE["embed_dim"]] * 4, **TINY_HEAD))
    randomize(model, seed)
    return model.eval()


def _to_flax(sd):
    pb, sb = convert_vit_adapter_backbone(sd, "backbone.")
    ph, _ = convert_mask2former_head(sd, "decode_head.")
    return {"backbone": pb, "decode_head": ph}, {"backbone": sb}


def _paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(np.shape(v))
    return out


def test_weight_round_trip_through_jax_converters():
    """port state_dict -> JAX converters -> state_dict_from_flax gives back
    the identical state_dict, every key but BN's num_batches_tracked; the
    flax tree covers the JAX model's own init tree exactly."""
    model = _port_segmentor(11)
    sd = model.state_dict()
    params, stats = _to_flax(sd)
    back = state_dict_from_flax(params, stats)
    want = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert set(back) == want
    for k in want:
        assert back[k].dtype == sd[k].dtype, k
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0, msg=k)

    jm = JSegmentor(backbone=JViTAdapter(**TINY_BACKBONE),
                    decode_head=JHead(**TINY_HEAD))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            np.zeros((1, 64, 64, 3), np.float32))
    assert _paths(params) == _paths(shapes["params"])
    assert _paths(stats) == _paths(shapes["batch_stats"])


def test_segmentor_logits_match_jax_from_uint8():
    model = _port_segmentor(12)
    params, stats = _to_flax(model.state_dict())
    # the port also loads what the converters produced
    load_flax(model, params, stats)
    img = np.random.RandomState(13).randint(0, 256, (2, 64, 64, 3),
                                            dtype=np.uint8)
    jm = JSegmentor(backbone=JViTAdapter(**TINY_BACKBONE),
                    decode_head=JHead(**TINY_HEAD))
    want = jax.jit(lambda v, x: jm.apply(v, jnormalize(x)))(
        {"params": params, "batch_stats": stats}, img)
    with torch.no_grad():
        got = model(normalize(torch.from_numpy(img)))
    assert tuple(got.shape) == (2, 64, 64, TINY_HEAD["num_classes"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("hw", [(64, 96), (96, 64)])
def test_segmentor_logits_match_jax_non_square(hw):
    """Non-square inputs (whole-image evaluation feeds 1024x2048): any H/W
    mix-up in the pos-embed resize, the reference points, the MSDA
    normalizer or the pixel decoder's level shapes shows here."""
    model = _port_segmentor(16)
    params, stats = _to_flax(model.state_dict())
    img = np.random.RandomState(17).randint(0, 256, (1, *hw, 3),
                                            dtype=np.uint8)
    jm = JSegmentor(backbone=JViTAdapter(**TINY_BACKBONE),
                    decode_head=JHead(**TINY_HEAD))
    want = jax.jit(lambda v, x: jm.apply(v, jnormalize(x)))(
        {"params": params, "batch_stats": stats}, img)
    with torch.no_grad():
        got = model(normalize(torch.from_numpy(img)))
    assert tuple(got.shape) == (1, *hw, TINY_HEAD["num_classes"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_segmentor_return_queries_match_jax():
    model = _port_segmentor(14)
    params, stats = _to_flax(model.state_dict())
    img = np.random.RandomState(15).randn(1, 64, 64, 3).astype(np.float32)
    jm = JSegmentor(backbone=JViTAdapter(**TINY_BACKBONE),
                    decode_head=JHead(**TINY_HEAD))
    jcls, jmasks = jax.jit(lambda v, x: jm.apply(v, x, return_queries=True))(
        {"params": params, "batch_stats": stats}, img)
    with torch.no_grad():
        cls, masks = model(torch.from_numpy(img), return_queries=True)
    assert tuple(masks.shape) == (1, TINY_HEAD["num_queries"], 64, 64)
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(masks.numpy(), np.asarray(jmasks), rtol=2e-4,
                               atol=3e-4)
