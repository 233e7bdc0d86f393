"""The windowed ViT trunks, the detection necks and the RoI heads of the
port (`vitadapter_torch/models/vit.py`, `det/necks.py`,
`det/roi_heads.py`) against the JAX package, on the CPU, in fp32, at tiny
sizes: weights flax -> `utils/weights.py`, inputs from numpy seeds,
outputs within 2e-4 of each one's scale; the decode's kept labels and
the losses' labels equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitadapter.det import necks as jnecks
from vitadapter.det import roi_heads as jheads
from vitadapter.models.baselines import ViTBaseline as JViTBaseline
from vitadapter.models.vit_adapter import ViTAdapter as JViTAdapter
from vitadapter_torch.det import necks as tnecks
from vitadapter_torch.det import roi_heads as theads
from vitadapter_torch.det.assign import SampleResult
from vitadapter_torch.models.baselines import ViTBaseline
from vitadapter_torch.models.vit_adapter import ViTAdapter
from vitadapter_torch.utils.init import init_weights
from vitadapter_torch.utils.weights import (bbox_head_from_flax,
                                            mask_head_from_flax,
                                            neck_from_flax)

from torch_port_util import (DET_BACKBONE, assert_close, flax_variables,
                             port_like, randomize_flax, to_np)



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores (see test_torch_upernet)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x))


def image(seed, hw, B=1):
    return np.random.RandomState(seed).randn(B, *hw, 3).astype(np.float32)


# -------------------------------------------------------------- trunks


@pytest.mark.parametrize("kind,hw", [("adapter", (64, 96)),
                                     ("adapter", (96, 96)),
                                     ("baseline", (64, 80))])
def test_windowed_trunk_matches_jax(kind, hw):
    """ViT-Adapter with windows that pad the token grid (4x6 -> 6x6) and
    that do not (6x6), and the windowed ViTBaseline (4x5 -> 6x6): the four
    maps, weights through `vit_adapter_from_flax` /
    `vit_baseline_from_flax`."""
    x = image(2, hw, B=2)
    if kind == "adapter":
        jm = JViTAdapter(**DET_BACKBONE)
        port = ViTAdapter(**DET_BACKBONE, device="meta")
    else:
        cfg = dict(embed_dim=32, depth=2, num_heads=4,
                   window_attn=(True, False), window_size=(3, None))
        jm, port = JViTBaseline(**cfg), ViTBaseline(**cfg, device="meta")
    v = flax_variables(jm, x, 3)
    port = port_like(port, v)
    with torch.no_grad():
        got = port(t(x))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jm.apply)(v, x)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, msg=f"scale {i}")


# ---------------------------------------------------- necks and heads


@pytest.mark.parametrize("neck", ["fpn", "channel_mapper"])
def test_necks_match_jax(neck):
    rs = np.random.RandomState(4)
    feats = [rs.randn(2, 16 // s, 24 // s, 12).astype(np.float32)
             for s in (1, 2, 4, 8)]
    if neck == "fpn":
        jm = jnecks.FPN(out_channels=16, num_outs=5)
        port = tnecks.FPN([12] * 4, 16, 5, device="meta")
    else:
        jm = jnecks.ChannelMapperWithPooling(out_channels=16, num_outs=5,
                                             groups=4)
        port = tnecks.ChannelMapperWithPooling([12] * 4, 16, 5, groups=4,
                                               device="meta")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), feats)
    p = randomize_flax(shapes["params"], 5)
    port = init_weights(port.to_empty(device="cpu"),
                        torch.Generator().manual_seed(0))
    port.load_state_dict(neck_from_flax(p))
    with torch.no_grad():
        got = port([t(f) for f in feats])
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jm.apply)({"params": p}, feats)
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, msg=f"level {i}")


def test_roi_heads_and_losses_match_jax():
    """`Shared2FCBBoxHead` (its first fc reads the RoI features channel
    first, as mmdet) and `FCNMaskHead` on random RoI features; their
    losses on one sample; `decode_detections` on shared inputs (kept
    labels and NMS indices equal)."""
    rs = np.random.RandomState(7)
    K, R = 5, 24
    roi7 = rs.randn(R, 7, 7, 16).astype(np.float32)
    roi14 = rs.randn(R, 14, 14, 16).astype(np.float32)
    jb = jheads.Shared2FCBBoxHead(num_classes=K, fc_dim=32)
    jk = jheads.FCNMaskHead(num_classes=K, channels=16, num_convs=2)
    vb = {"params": randomize_flax(jax.eval_shape(
        jb.init, jax.random.PRNGKey(0), roi7)["params"], 8)}
    vk = {"params": randomize_flax(jax.eval_shape(
        jk.init, jax.random.PRNGKey(0), roi14)["params"], 9)}
    pb = init_weights(theads.Shared2FCBBoxHead(K, 16, fc_dim=32,
                                               device="meta").to_empty(
        device="cpu"), torch.Generator().manual_seed(0))
    pb.load_state_dict(bbox_head_from_flax(vb["params"]))
    pk = init_weights(theads.FCNMaskHead(K, 16, 16, num_convs=2,
                                         device="meta").to_empty(
        device="cpu"), torch.Generator().manual_seed(0))
    pk.load_state_dict(mask_head_from_flax(vk["params"]))
    with torch.no_grad():
        cls, deltas = pb(t(roi7))
        masks = pk(t(roi14))
    with jax.default_matmul_precision("highest"):
        jcls, jdeltas = jax.jit(jb.apply)(vb, roi7)
        jmasks = jax.jit(jk.apply)(vk, roi14)
    assert_close(cls, jcls)
    assert_close(deltas, jdeltas)
    assert_close(masks.permute(0, 2, 3, 1), jmasks)

    # losses on one sample over proposals and gts
    props = np.concatenate([rs.rand(R, 2) * 40, rs.rand(R, 2) * 40 + 45],
                           1).astype(np.float32)
    gtb = props[:4] + rs.randn(4, 4).astype(np.float32)
    gtl = rs.randint(0, K, 4).astype(np.int32)
    sample = SampleResult(t(np.arange(R)), t(rs.rand(R) < 0.4),
                          t(rs.rand(R) < 0.9), t(rs.randint(0, 4, R)))
    targets = (rs.rand(R, 28, 28) > 0.5).astype(np.float32)
    got = theads.bbox_head_loss(t(jcls), t(jdeltas), sample, t(props),
                                t(gtb), t(gtl), K)
    jsample = type(sample)(*(jnp.asarray(s.numpy()) for s in sample))
    want = jheads.bbox_head_loss(jcls, jdeltas, jsample, props, gtb, gtl, K)
    assert_close(got[0], want[0])
    assert_close(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert_close(theads.mask_head_loss(t(jmasks).permute(0, 3, 1, 2),
                                       sample, got[2], t(targets)),
                 jheads.mask_head_loss(jmasks, jsample, want[2], targets))

    # the decode on shared inputs
    valid = rs.rand(R) > 0.1
    got = theads.decode_detections(t(jcls), t(jdeltas), t(props), (90, 90),
                                   max_per_img=10, valid=t(valid))
    want = jax.jit(lambda *a: jheads.decode_detections(
        *a, (90, 90), max_per_img=10, valid=valid))(jcls, jdeltas, props)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int((got[2] >= 0).sum()) == 10
    assert_close(got[0], want[0])
    assert_close(np.where(np.isfinite(to_np(got[1])), to_np(got[1]), 0),
                 np.where(np.isfinite(want[1]), want[1], 0))
