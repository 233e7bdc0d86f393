"""The port's BEiT trunk and BEiT-Adapter (`vitadapter_torch/models/beit.py`,
`beit_adapter.py`) against the JAX package, on the CPU at a tiny size
(48 wide, 4 blocks, 64 px, a 2-layer Mask2Former head): the
relative-position index, the weight transfer both ways, the segmentor's
eval logits and its train-mode gradients (drop path 0) at 2e-4, the
layer-decay scales and weight-decay mask per parameter, and block
checkpointing (`with_cp`) under DropPath drawing from an explicit
generator."""

import jax
import numpy as np
import pytest
import torch

from vitadapter.heads.mask2former import Mask2FormerHead as JHead
from vitadapter.models import beit as jbeit
from vitadapter.models.beit_adapter import BEiTAdapter as JBEiTAdapter
from vitadapter.models.mask2former_segmentor import \
    EncoderDecoderMask2Former as JSegmentor
from vitadapter.train import optim as joptim
from vitadapter.utils.checkpoint import (convert_beit_backbone,
                                         convert_mask2former_head)
from vitadapter_torch.heads.mask2former import Mask2FormerHead
from vitadapter_torch.models import beit as tbeit
from vitadapter_torch.models.beit_adapter import BEiTAdapter
from vitadapter_torch.models.mask2former_segmentor import \
    EncoderDecoderMask2Former
from vitadapter_torch.train import optim as toptim
from vitadapter_torch.utils.init import init_weights
from vitadapter_torch.utils.weights import load_flax, state_dict_from_flax

from torch_port_util import TINY_TRAIN_HEAD, randomize, randomize_flax

BACKBONE = dict(img_size=64, patch_size=16, embed_dim=48, depth=4,
                num_heads=4, deform_num_heads=6, conv_inplane=16,
                deform_ratio=0.5, interaction_indexes=((0, 0), (1, 1),
                                                       (2, 2), (3, 3)))
HEAD = TINY_TRAIN_HEAD
TOL = 2e-4
# biases added just before a BatchNorm in training mode (c1's 1x1 conv and
# the transposed conv, both into `norm1`): their gradient is zero in exact
# arithmetic, so both sides give float noise around it
BEFORE_BN = ("backbone.spm.fc1.bias", "backbone.up.bias")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make these small eager ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(seed=None, **backbone):
    model = EncoderDecoderMask2Former(
        BEiTAdapter(**{**BACKBONE, **backbone}, device="meta"),
        Mask2FormerHead([BACKBONE["embed_dim"]] * 4, **HEAD, device="meta"))
    model = init_weights(model.to_empty(device="cpu"),
                         torch.Generator().manual_seed(0))
    if seed is not None:
        randomize(model, seed)
    return model.eval()


def _jax():
    return JSegmentor(backbone=JBEiTAdapter(**BACKBONE),
                      decode_head=JHead(**HEAD))


def _paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(np.shape(v))
    return out


@pytest.fixture(scope="module")
def jax_side():
    """Random flax weights and statistics of the tiny segmentor, a batch,
    JAX's eval logits and its train-mode gradients of a fixed random
    projection of every decoder output."""
    jm = _jax()
    rs = np.random.RandomState(3)
    x = rs.randn(2, 64, 64, 3).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    params = randomize_flax(zeros["params"], 4)
    stats = randomize_flax(zeros["batch_stats"], 5, stats=True)
    n_out = HEAD["num_decoder_layers"] + 1
    q, k = HEAD["num_queries"], HEAD["num_classes"] + 1
    w_cls = rs.randn(n_out, 2, q, k).astype(np.float32)
    w_mask = rs.randn(n_out, 2, q, 16, 16).astype(np.float32)

    def loss(p):
        (cls_list, mask_list), _ = jm.apply(
            {"params": p, "batch_stats": stats}, x, train=True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)})
        return sum((c * w_cls[i]).sum() + (m * w_mask[i]).sum()
                   for i, (c, m) in enumerate(zip(cls_list, mask_list)))

    with jax.default_matmul_precision("highest"):
        logits = jax.jit(lambda p: jm.apply(
            {"params": p, "batch_stats": stats}, x))(params)
        grads = jax.jit(jax.grad(loss))(params)
    return dict(shapes=shapes, params=params, stats=stats, x=x, w_cls=w_cls,
                w_mask=w_mask, logits=np.asarray(logits),
                grads=jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("grid", [(4, 4), (3, 5), (5, 3), (40, 40)])
@pytest.mark.parametrize("with_cls", [True, False])
def test_relative_position_index_matches_jax(grid, with_cls):
    np.testing.assert_array_equal(
        tbeit.relative_position_index(*grid, with_cls),
        jbeit.relative_position_index(*grid, with_cls))


def test_weight_round_trip_through_jax_converters(jax_side):
    """port state_dict -> the JAX `convert_beit_backbone` and
    `convert_mask2former_head` -> `state_dict_from_flax` gives back the
    identical state_dict (every key but BatchNorm's num_batches_tracked),
    and the flax tree is the JAX model's own."""
    model = _port(6)
    sd = model.state_dict()
    pb, sb = convert_beit_backbone(sd, "backbone.")
    ph, _ = convert_mask2former_head(sd, "decode_head.")
    params, stats = {"backbone": pb, "decode_head": ph}, {"backbone": sb}
    back = state_dict_from_flax(params, stats)
    want = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert set(back) == want
    for k in want:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0, msg=k)
    shapes = jax_side["shapes"]
    assert _paths(params) == _paths(shapes["params"])
    assert _paths(stats) == _paths(shapes["batch_stats"])


def test_eval_logits_match_jax(jax_side):
    model = load_flax(_port(), jax_side["params"], jax_side["stats"])
    with torch.no_grad():
        got = model(torch.from_numpy(jax_side["x"])).numpy()
    want = jax_side["logits"]
    assert got.shape == (2, 64, 64, HEAD["num_classes"])
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_train_mode_gradients_match_jax(jax_side):
    """Training mode (BatchNorm on batch statistics, drop path 0): the
    gradient of a fixed random projection of every decoder output, each
    parameter within 2e-4 of its largest |value| in JAX (the `BEFORE_BN`
    biases, whose gradient is zero, within 2e-4 of the largest of all)."""
    model = load_flax(_port(), jax_side["params"], jax_side["stats"])
    model.train()
    cls_list, mask_list = model(torch.from_numpy(jax_side["x"]),
                                generator=torch.Generator().manual_seed(0))
    loss = sum((c * torch.from_numpy(jax_side["w_cls"][i])).sum()
               + (m * torch.from_numpy(jax_side["w_mask"][i])).sum()
               for i, (c, m) in enumerate(zip(cls_list, mask_list)))
    loss.backward()
    want = state_dict_from_flax(jax_side["grads"], jax_side["stats"])
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    top = max(float(want[n].abs().max()) for n in named)
    for n, p in named.items():
        w = want[n].numpy()
        scale = top if n in BEFORE_BN else max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= TOL * scale, (n, err, scale)


def _flax_to_port_values(tree, jax_side):
    """A per-leaf value tree of the JAX parameters -> {port name: value},
    through the weight converter (constant arrays keep their value under
    every transpose, stack and split it makes)."""
    full = jax.tree_util.tree_map(
        lambda v, s: np.full(np.shape(v), float(s), np.float32),
        jax_side["params"], tree)
    sd = state_dict_from_flax(full, jax_side["stats"])
    out = {}
    for n, t in sd.items():
        if "running_" in n:          # BatchNorm statistics, not parameters
            continue
        vals = np.unique(t.numpy())
        assert len(vals) == 1, (n, vals)
        out[n] = float(vals[0])
    return out


def test_layer_decay_and_weight_decay_match_jax(jax_side):
    """Per parameter of the segmentor: the layer-decay scale (cls_token and
    patch_embed id 0, `blocks.N.` N + 1, the rest depth + 1) and the
    weight-decay mask (the 2-D relative-position tables decay; the 1-D
    q/v biases and gammas do not) equal JAX's."""
    depth, rate = BACKBONE["depth"], 0.9
    model = _port()
    named = list(model.named_parameters())
    want_scale = _flax_to_port_values(
        joptim.layer_decay_scales(jax_side["params"], depth, rate), jax_side)
    want_decay = _flax_to_port_values(
        joptim.weight_decay_mask(jax_side["params"]), jax_side)
    got_scale = toptim.layer_decay_scales(named, depth, rate)
    got_decay = toptim.weight_decay_mask(named)
    for n, _ in named:
        assert got_scale[n] == pytest.approx(want_scale[n], rel=1e-6), n
        assert float(got_decay[n]) == want_decay[n], n
    assert got_scale["backbone.cls_token"] == rate ** (depth + 1)
    assert got_scale["backbone.blocks.2.attn.q_bias"] == rate ** (depth - 2)
    assert got_decay["backbone.blocks.0.attn.relative_position_bias_table"]
    assert not got_decay["backbone.blocks.0.attn.q_bias"]
    assert not got_decay["backbone.blocks.0.gamma_1"]


def _grads(model, x, seed):
    model.zero_grad()
    model.train()
    cls_list, mask_list = model(x, generator=torch.Generator().manual_seed(
        seed))
    sum(c.square().sum() + m.square().mean()
        for c, m in zip(cls_list, mask_list)).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def test_checkpointed_blocks_replay_drop_path_draws():
    """`with_cp` recomputes each block in the backward; its DropPath masks
    come from the caller's generator, which has moved on by then. With the
    same seed and drop path 0.3, checkpointed and plain blocks give equal
    gradients (and another seed other ones, so the masks matter)."""
    plain = _port(7, drop_path_rate=0.3)
    cp = _port(drop_path_rate=0.3, with_cp=True)
    cp.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.RandomState(8).randn(
        2, 64, 64, 3).astype(np.float32))
    want = _grads(plain, x, 9)
    got = _grads(cp, x, 9)
    for n in want:
        torch.testing.assert_close(got[n], want[n], rtol=1e-6, atol=1e-7,
                                   msg=n)
    other = _grads(plain, x, 10)
    assert any(not torch.allclose(other[n], want[n]) for n in want
               if ".blocks." in n)


def test_a_grid_other_than_the_tables_raises():
    """The relative-position tables span img_size / patch_size: a smaller
    crop raises, in the port as in JAX (`--aug-test` ratios below 1 make
    such crops; ROADMAP.md §3)."""
    model = _port(11)
    with pytest.raises(ValueError, match="patch grid"):
        with torch.no_grad():
            model(torch.zeros(1, 32, 64, 3))
