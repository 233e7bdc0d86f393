"""The port's BEiT detection variant (`models/beit.py`: windowed blocks
whose tables span the window, global blocks whose tables span the
`img_size / patch_size` grid, no cls token) and BEiT-Adapter's `version`
"new" (the final trunk map broadcast to the four scales) and "old" against
the JAX package, on the CPU at a tiny size (48 wide, 64 px, windows of 3
and 7 padding the 4x4 token grid), fp32 within 2e-4 of each output's
scale; and the HTC++ state dict (BEiT-Adapter, ExtraAttention, the three
stages' heads with `conv_res_feat`, the semantic branch) through the JAX
`convert_detector_checkpoint` and back, bitwise, into the JAX model's own
tree."""

import jax
import numpy as np
import pytest
import torch

from vitadapter.det.cascade import CascadeRCNN as JCascadeRCNN
from vitadapter.models.beit import BEiT as JBEiT
from vitadapter.models.beit_adapter import BEiTAdapter as JBEiTAdapter
from vitadapter.utils.checkpoint import convert_detector_checkpoint
from vitadapter_torch.det.cascade import CascadeRCNN
from vitadapter_torch.models.beit import BEiT
from vitadapter_torch.models.beit_adapter import BEiTAdapter
from vitadapter_torch.utils.init import init_weights
from vitadapter_torch.utils.weights import (_beit_trunk, load_flax,
                                            state_dict_from_flax)

from torch_port_util import assert_close, flax_variables, port_like

TOL = 2e-4
# windows of 3 pad the 4x4 grid to 6x6, a window of 7 to 7x7 (as the
# HTC++ configs' 56 pads the 100x88 grid to 112x112); block 2 is global
TRUNK = dict(img_size=64, patch_size=16, embed_dim=48, num_heads=4,
             use_cls_token=False)
WINDOWS = dict(window_attn=(True, True, False, True),
               window_size=(3, 7, None, 3))
ADAPTER = dict(TRUNK, depth=4, deform_num_heads=4, conv_inplane=16,
               deform_ratio=0.5, **WINDOWS,
               interaction_indexes=((0, 0), (1, 1), (2, 2), (3, 3)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores (see test_torch_upernet)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def image(seed, b=2):
    return np.random.RandomState(seed).randn(b, 64, 64, 3).astype(np.float32)


def test_windowed_beit_trunk_matches_jax():
    """The trunk alone: tokens after windowed (padded) and global blocks
    without a cls token; the tables' shapes are the JAX module's."""
    jm = JBEiT(depth=4, **TRUNK, **WINDOWS)
    x = image(7)
    v = flax_variables(jm, x, 8)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jm.apply)(v, x)
    port = init_weights(BEiT(depth=4, **TRUNK, **WINDOWS).eval(),
                        torch.Generator().manual_seed(0))
    port.load_state_dict(_beit_trunk(v["params"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, 16, 48)
    assert_close(got, want, TOL, "tokens")
    tables = [tuple(b.attn.relative_position_bias_table.shape)
              for b in port.blocks]
    assert tables == [(25, 4), (169, 4), (49, 4), (25, 4)]


@pytest.mark.parametrize("version", ["new", "old"])
def test_beit_adapter_det_variant_matches_jax(version):
    """BEiT-Adapter without a cls token: the four maps at eval, within
    TOL; "new" adds the last trunk map to every scale, "old" each
    interaction's (so the two differ)."""
    jm = JBEiTAdapter(**ADAPTER, version=version)
    x = image(9)
    v = flax_variables(jm, x, 10)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jm.apply)(v, x)
    port = port_like(BEiTAdapter(**ADAPTER, version=version, device="meta"),
                     v)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert [tuple(f.shape) for f in got] == [
        (2, 16, 16, 48), (2, 8, 8, 48), (2, 4, 4, 48), (2, 2, 2, 48)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, TOL, f"{version} level {i}")
    other = "old" if version == "new" else "new"
    port.version = other
    with torch.no_grad():
        moved = port(torch.from_numpy(x))
    assert not torch.allclose(moved[0], got[0], atol=1e-3)


def test_htc_weight_round_trip_through_convert_detector_checkpoint():
    """port state_dict -> the JAX `convert_detector_checkpoint` (which
    finds the BEiT backbone by `blocks.0.attn.q_bias`, the ExtraAttention
    at `neck.0`) -> `state_dict_from_flax` gives back every key bitwise
    (BatchNorm's num_batches_tracked aside), and the tree is the JAX
    HTC++ model's own; it loads into the port."""
    heads = dict(num_classes=5, fpn_channels=32, num_proposals=20,
                 num_roi_samples=8, max_dets=5, use_extra_attention=True,
                 with_semantic=True)
    port = CascadeRCNN(BEiTAdapter(**ADAPTER, version="new", device="meta"),
                       device="meta", **heads)
    port = init_weights(port.to_empty(device="cpu"),
                        torch.Generator().manual_seed(12))
    sd = port.state_dict()
    assert any(k.startswith("neck.0.attn.qkv") for k in sd)
    assert "roi_head.mask_head.2.conv_res_feat.conv.weight" in sd
    conv = convert_detector_checkpoint(sd)
    back = state_dict_from_flax(conv["params"], conv["batch_stats"])
    want = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert set(back) == want
    for k in want:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0, msg=k)
    jm = JCascadeRCNN(backbone=JBEiTAdapter(**ADAPTER, version="new"),
                      **heads)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), image(0, 1))
    for tree in ("params", "batch_stats"):
        assert (jax.tree_util.tree_map(np.shape, conv[tree])
                == jax.tree_util.tree_map(np.shape, shapes[tree]))
    load_flax(port, conv["params"], conv["batch_stats"])
