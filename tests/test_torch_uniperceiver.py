"""The port's Uni-Perceiver trunk and UniPerceiver-Adapter
(`models/uniperceiver.py`, `models/uniperceiver_adapter.py`) against the
JAX package on the CPU at a tiny size, in fp32 within 2e-4 of each
output's scale: the joint attention, global and in windows (3-token
windows padding the 4x6 token grid, the text copied into each), with the
text padded and masked; the joint layer, the grounding cross-attention
block with their gradients; the adapter (a windowed and a global layer,
one grounding block, strides 8-32 out); and the adapter's state dict
through the JAX `convert_uniperceiver_backbone` and back, bitwise, into
the JAX model's own tree."""

import jax
import numpy as np
import pytest
import torch

from vitadapter.models import uniperceiver as ju
from vitadapter.models.uniperceiver_adapter import \
    UniPerceiverAdapter as JUniPerceiverAdapter
from vitadapter.utils.checkpoint import convert_uniperceiver_backbone
from vitadapter_torch.models import uniperceiver as tu
from vitadapter_torch.models.uniperceiver_adapter import UniPerceiverAdapter
from vitadapter_torch.utils.weights import (_linear, _prefixed,
                                            grounding_block_from_flax,
                                            state_dict_from_flax,
                                            uniperceiver_layer_from_flax)

from torch_port_util import (assert_close, flax_variables, port_like,
                             randomize_flax, to_np)

TOL = 2e-4
C, HEADS, H, W, T = 32, 4, 4, 6, 5
ADAPTER = dict(patch_size=16, embed_dim=48, depth=2, num_heads=4,
               vocab_size=100, deform_num_heads=4, conv_inplane=16,
               deform_ratio=0.5, interaction_indexes=((0, 0), (1, 1)),
               window_attn=(True, False), window_size=(3, None),
               num_grounding_blocks=1, out_indices=(1, 2, 3))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores (see test_torch_upernet)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tokens(seed, n, b=2):
    return np.random.RandomState(seed).randn(b, n, C).astype(np.float32)


def text_mask(b=2):
    """The first sample's text whole, the second's last two tokens pad."""
    m = np.ones((b, T), np.int32)
    m[1, 3:] = 0
    return m


def flax_params(module, seed, *args):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    return randomize_flax(shapes["params"], seed)


def outputs_and_grads(fn, params, weights):
    """fn's outputs and JAX's gradient of sum(output_i * weights_i), in
    one compiled program."""
    def loss(p):
        outs = fn(p)
        return sum((o * w).sum() for o, w in zip(outs, weights)), outs

    with jax.default_matmul_precision("highest"):
        (_, outs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params)
    return ([np.asarray(o) for o in outs],
            jax.tree_util.tree_map(np.asarray, grads))


def check_grads(module, sd_grads):
    """Each port parameter's gradient within TOL of the largest |JAX
    gradient| of that parameter (of all of them where JAX's is zero)."""
    named = dict(module.named_parameters())
    top = max(float(g.abs().max()) for g in sd_grads.values())
    for n, p in named.items():
        w = sd_grads[n].numpy()
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        got = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        err = float(np.abs(got - w).max())
        assert err <= TOL * scale, (n, err, scale)


@pytest.mark.parametrize("windowed", [False, True])
def test_joint_attention_matches_jax(windowed):
    """Image and text outputs; the padded text keys are masked, so
    changing those tokens changes no image output and no real text
    output."""
    jm = ju.JointAttention(HEADS, windowed=windowed, window_size=3)
    x, q, m = tokens(1, H * W), tokens(2, T), text_mask()
    p = flax_params(jm, 3, x, q, m, H, W)
    with jax.default_matmul_precision("highest"):
        want = jm.apply({"params": p}, x, q, m, H, W)
    port = tu.JointAttention(C, HEADS, windowed, 3)
    port.load_state_dict({**_prefixed("in_proj", _linear(p["in_proj"])),
                          **_prefixed("out_proj", _linear(p["out_proj"]))})
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(q),
                   torch.from_numpy(m), H, W)
        q2 = q.copy()
        q2[1, 3:] = 50.0
        moved = port(torch.from_numpy(x), torch.from_numpy(q2),
                     torch.from_numpy(m), H, W)
    for g, w in zip(got, want):
        assert_close(g, w, TOL)
    assert torch.equal(moved[0], got[0])
    assert torch.equal(moved[1][:, :3], got[1][:, :3])


@pytest.mark.parametrize("windowed", [False, True])
def test_multimodel_bert_layer_and_gradients_match_jax(windowed):
    """The joint layer (shared norms and FFN, gamma-scaled residuals; the
    gammas random, so the branches carry signal): both outputs and every
    parameter's gradient."""
    jm = ju.MultiModelBertLayer(HEADS, windowed=windowed, window_size=3)
    x, q, m = tokens(4, H * W), tokens(5, T), text_mask()
    p = flax_params(jm, 6, x, q, m, H, W)
    wx, wq = tokens(7, H * W), tokens(8, T)
    want, grads = outputs_and_grads(
        lambda pp: jm.apply({"params": pp}, x, q, m, H, W), p, (wx, wq))
    port = tu.MultiModelBertLayer(C, HEADS, windowed=windowed, window_size=3)
    port.load_state_dict(uniperceiver_layer_from_flax(p))
    got = port(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(m),
               H, W)
    for g, w in zip(got, want):
        assert_close(g, w, TOL)
    ((got[0] * torch.from_numpy(wx)).sum()
     + (got[1] * torch.from_numpy(wq)).sum()).backward()
    check_grads(port, uniperceiver_layer_from_flax(grads))


def test_grounding_cross_attention_and_gradients_match_jax():
    """One shared norm1 on image and text, q from the image, the fused kv
    from the text (padded keys masked), then the MLP."""
    jm = ju.GroundingCrossAttention(HEADS)
    x, t, m = tokens(9, H * W), tokens(10, T), text_mask()
    p = flax_params(jm, 11, x, t, m)
    wx = tokens(12, H * W)
    (want,), grads = outputs_and_grads(
        lambda pp: (jm.apply({"params": pp}, x, t, m),), p, (wx,))
    port = tu.GroundingCrossAttention(C, HEADS)
    port.load_state_dict(grounding_block_from_flax(p))
    got = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(m))
    assert_close(got, want, TOL)
    (got * torch.from_numpy(wx)).sum().backward()
    check_grads(port, grounding_block_from_flax(grads))


@pytest.fixture(scope="module")
def adapter_side():
    """JAX's adapter: random variables and the eval outputs on a 64x96
    image with a padded question."""
    jm = JUniPerceiverAdapter(**ADAPTER)
    rs = np.random.RandomState(13)
    img = rs.randn(2, 64, 96, 3).astype(np.float32)
    ids = rs.randint(0, 100, (2, T)).astype(np.int32)
    m = text_mask()
    v = flax_variables(jm, img, 14, refer=ids, r_mask=m)
    with jax.default_matmul_precision("highest"):
        feats = jax.jit(lambda v: jm.apply(v, img, ids, m))(v)
    return dict(v=v, img=img, ids=ids, m=m,
                feats=[np.asarray(f) for f in feats])


def test_uniperceiver_adapter_matches_jax(adapter_side):
    """The three maps at strides 8-32 (the adapter's gradients are held
    with the whole detector's in `test_torch_grounding_train.py`); the
    `up` map and its norm reach no output."""
    s = adapter_side
    port = port_like(UniPerceiverAdapter(**ADAPTER, device="meta"), s["v"])
    feats = port(torch.from_numpy(s["img"]), torch.from_numpy(s["ids"]),
                 torch.from_numpy(s["m"]))
    assert [tuple(f.shape) for f in feats] == [
        (2, 8, 12, 48), (2, 4, 6, 48), (2, 2, 3, 48)]
    for g, w in zip(feats, s["feats"]):
        assert_close(g, w, TOL)
    sum(f.sum() for f in feats).backward()
    assert port.up.weight.grad is None and port.norm1.weight.grad is None


def _adapter_run(model, s, seed):
    """Train-mode outputs, every gradient of sum(mean(out^2)) and the
    generator's state after the backward, from generator seed `seed`."""
    model.zero_grad()
    model.train()
    g = torch.Generator().manual_seed(seed)
    feats = model(torch.from_numpy(s["img"]), torch.from_numpy(s["ids"]),
                  torch.from_numpy(s["m"]), generator=g)
    sum(f.square().mean() for f in feats).backward()
    return ([f.detach() for f in feats],
            {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}, g.get_state())


def test_with_cp_replays_drop_path_draws_in_joint_layers(adapter_side):
    """`with_cp` recomputes the joint layers (image and text state) in the
    backward; with one generator seed and drop path 0.4 the outputs, the
    gradients of the image and the text paths and the generator's state
    afterwards equal those of the layers run plainly, and another seed
    gives other gradients, so the masks matter."""
    s = adapter_side
    cfg = dict(ADAPTER, drop_path_rate=0.4)
    plain = port_like(UniPerceiverAdapter(**cfg, device="meta"), s["v"])
    cp = port_like(UniPerceiverAdapter(**cfg, with_cp=True, device="meta"),
                   s["v"])
    want_out, want, want_state = _adapter_run(plain, s, 93)
    got_out, got, got_state = _adapter_run(cp, s, 93)
    for g, w in zip(got_out, want_out):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert set(got) == set(want)
    assert {"token_embed.embeddings.weight",
            "visual_embed.patch_embed.proj.weight",
            "layers.0.self_attn.in_proj.weight"} <= set(want)
    for n in want:
        torch.testing.assert_close(got[n], want[n], rtol=1e-6, atol=1e-7,
                                   msg=n)
    assert torch.equal(got_state, want_state)
    _, other, _ = _adapter_run(plain, s, 94)
    assert any(not torch.allclose(other[n], want[n]) for n in want
               if n.startswith("layers."))


def test_refer_is_required_as_in_jax():
    """A caller that passes the image alone (a segmentor or an R-CNN)
    raises the TypeError naming `refer`."""
    port = UniPerceiverAdapter(**ADAPTER, device="meta")
    with pytest.raises(TypeError, match="refer"):
        port(torch.zeros(1, 64, 64, 3, device="meta"),
             generator=None)


def _paths(tree, pre=()):
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out |= _paths(v, pre + (k,))
        else:
            out.add(pre + (k,))
    return out


def test_weight_round_trip_through_jax_converter(adapter_side):
    """port state_dict (the reference's keys) -> the JAX
    `convert_uniperceiver_backbone` -> `state_dict_from_flax` gives back
    the identical state_dict, and the flax tree is the JAX model's own."""
    port = port_like(UniPerceiverAdapter(**ADAPTER, device="meta"),
                     adapter_side["v"])
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, stats = convert_uniperceiver_backbone(sd)
    back = state_dict_from_flax(params, stats)
    want = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert set(back) == want
    for k in want:
        np.testing.assert_array_equal(to_np(back[k]), sd[k], err_msg=k)
    v = adapter_side["v"]
    assert _paths(params) == _paths(v["params"])
    assert _paths(stats) == _paths(v["batch_stats"])
