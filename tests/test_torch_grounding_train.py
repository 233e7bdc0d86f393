"""One GroundingDINO train step of the port (`det/grounding_dino.py::
GroundingDINO.forward_train` through `train/trainer.py::
make_det_train_step`) against the JAX package's, on the CPU in fp32: the
tiny UniPerceiver-Adapter (two joint layers in one interaction, one
grounding block, strides 8-32 out; windows are held in
`test_torch_uniperceiver.py`), the ChannelMapper, the DINO transformer (one
encoder and two decoder layers, 12 queries, 2 denoising groups) and the
box-rectangle dice branch, on JAX's denoising draws (replayed from the
key splits of `vitadapter/det/dino.py::cdn_queries`), on a 128x192 image
(the stride-64 level's 2x3 cells: a GroupNorm of one channel over two
cells, as 64x96 gives, only keeps the signs and amplifies rounding).

Held: every loss within 2e-4 relative; each gradient within 2e-4 of its
tensor's scale (of the largest of all where a gradient is zero up to
rounding) and the float64 gradient norm within 2e-4; after one AdamW step
with clipping and weight decay, the parameters that moved are optax's and
the update agrees where the gradient is not negligible. The margins that
keep float noise from changing the discrete choices are asserted: the
encoder's top-12 cut of its proposals and each matrix's assignment (the
best query against the next). And every parameter's layer-decay scale and
weight-decay mask equal JAX's on the port's reference names (the
Uni-Perceiver patch projection and text position table are named apart
from JAX's).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitadapter.det.grounding_dino import GroundingDINO as JGroundingDINO
from vitadapter.models.uniperceiver_adapter import \
    UniPerceiverAdapter as JUniPerceiverAdapter
from vitadapter.train import optim as joptim
from vitadapter_torch.det.dino import DnDraws
from vitadapter_torch.det.grounding_dino import GroundingDINO
from vitadapter_torch.models.uniperceiver_adapter import UniPerceiverAdapter
from vitadapter_torch.ops.matching import hungarian_assign
from vitadapter_torch.train import optim as toptim
from vitadapter_torch.train.optim import make_optimizer
from vitadapter_torch.train.trainer import TrainState, make_det_train_step
from vitadapter_torch.utils.weights import state_dict_from_flax

from torch_port_util import flax_variables, port_like

TOL = 2e-4
BACKBONE = dict(patch_size=16, embed_dim=48, depth=2, num_heads=4,
                vocab_size=100, deform_num_heads=4, conv_inplane=16,
                deform_ratio=0.5, interaction_indexes=((0, 1),),
                num_grounding_blocks=1, out_indices=(1, 2, 3))
HEAD = dict(num_classes=1, num_queries=12, embed_dim=32, num_heads=4,
            ffn_dim=64, num_encoder_layers=1, num_decoder_layers=2,
            dn_groups=2, max_dets=5, with_aux_seg=True)
B, G, T, HW = 2, 1, 6, (128, 192)
BEFORE_GN = {f"backbone.norm{i}.bias" for i in (2, 3, 4)}
OPT = dict(base_lr=1e-3, weight_decay=0.05, depth=2, layer_decay_rate=0.8,
           total_steps=10, warmup_steps=0, grad_clip=0.1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores (see test_torch_upernet)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch(seed):
    """Images, a question each (the second padded), one gt box each."""
    rs = np.random.RandomState(seed)
    H, W = HW
    xy = rs.rand(B, G, 2) * np.array([W - 40, H - 40])
    wh = rs.rand(B, G, 2) * 30 + 8
    r_mask = np.ones((B, T), np.int32)
    r_mask[1, 4:] = 0
    return {"image": rs.randn(B, H, W, 3).astype(np.float32),
            "refer": rs.randint(0, 100, (B, T)).astype(np.int32),
            "r_mask": r_mask,
            "gt_boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
            "gt_labels": np.zeros((B, G), np.int32),
            "gt_valid": np.ones((B, G), bool)}


def jax_dn_draws(rng, n_dn: int) -> DnDraws:
    """The draws of the JAX `cdn_queries(rng, ...)`, as the port's."""
    r_lbl, r_sign, r_box = jax.random.split(rng, 3)
    flip = jax.random.uniform(r_lbl, (B, n_dn)) < 0.25
    label = jax.random.randint(r_lbl, (B, n_dn), 0, HEAD["num_classes"])
    sign = jnp.where(jax.random.uniform(r_sign, (B, n_dn, 4)) > 0.5, 1.0,
                     -1.0)
    u = jax.random.uniform(r_box, (B, n_dn, 4))
    return DnDraws(*(torch.from_numpy(np.array(a)) for a in
                     (flip, label, sign, u)))


def _jax_model():
    return JGroundingDINO(backbone=JUniPerceiverAdapter(**BACKBONE), **HEAD)


@functools.lru_cache(maxsize=1)
def _variables():
    """Random JAX variables (shapes by `jax.eval_shape`), once a run."""
    d = batch(0)
    return flax_variables(_jax_model(), d["image"], 31, refer=d["refer"],
                          r_mask=d["r_mask"])


@pytest.fixture(scope="module")
def trained():
    """One port train step on JAX's dn draws, the assignments' cost
    matrices and the encoder's proposal scores it saw, and JAX's losses,
    gradients and optax step on the same batch and weights."""
    jm = _jax_model()
    v = _variables()
    data = batch(7)
    rng = jax.random.PRNGKey(5)

    def loss_fn(params):
        losses, _ = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            data["image"], data["refer"], data["r_mask"], train=True,
            gt_boxes=data["gt_boxes"], gt_labels=data["gt_labels"],
            gt_valid=data["gt_valid"], rng=rng, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(4)})
        return losses["loss"], losses

    with jax.default_matmul_precision("highest"):
        (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v["params"])
    tx, _ = joptim.make_optimizer(v["params"], **OPT)
    stepped = jax.jit(lambda g, p: jax.tree_util.tree_map(
        lambda a, u: a + u, p, tx.update(g, tx.init(p), p)[0]))(
            grads, v["params"])

    port = port_like(GroundingDINO(UniPerceiverAdapter(**BACKBONE,
                                                       device="meta"),
                                   device="meta", **HEAD), v)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    costs, enc_scores = [], []

    def assigner(cost, n_valid):
        costs.append(cost.clone())
        return hungarian_assign(cost, n_valid)

    n_dec = HEAD["num_decoder_layers"]
    hook = port.bbox_head.cls_branches[n_dec].register_forward_hook(
        lambda m, i, o: enc_scores.append(o.detach().float()))
    optimizer, _ = make_optimizer(port, **OPT)
    b = {k: torch.from_numpy(x) for k, x in data.items()}
    b["gt_labels"] = b["gt_labels"].long()
    _, logs = make_det_train_step(port)(
        TrainState.create(port, optimizer), b,
        torch.Generator().manual_seed(0),
        dn_draws=jax_dn_draws(rng, 2 * G * HEAD["dn_groups"]),
        assigner=assigner)
    hook.remove()
    return dict(port=port, before=before, logs=logs, want=want, grads=grads,
                stepped=stepped, v=v, costs=costs, enc_scores=enc_scores)


def test_margins_of_the_discrete_choices(trained):
    """The encoder's top-12 of its proposal scores, and in each
    assignment the best query's cost against the next best (one gt)."""
    s = trained["enc_scores"][0].amax(-1)                    # (B, S)
    top = torch.sort(s, -1, descending=True).values
    k = HEAD["num_queries"]
    assert float((top[:, k - 1] - top[:, k]).min()) > 1e-4
    # the 2 decoder layers' and the encoder's assignments
    assert len(trained["costs"]) == HEAD["num_decoder_layers"] + 1
    for c in trained["costs"]:
        col = torch.sort(c[..., 0], -1).values
        assert float((col[:, 1] - col[:, 0]).min()) > 1e-4


def test_grounding_train_losses_and_grad_norm_match_jax(trained):
    t = trained
    want, logs = t["want"], t["logs"]
    assert set(want) == set(logs) - {"grad_norm"}
    assert "loss_aux_seg" in want and "d0.loss_cls_dn" in want
    for k in want:
        assert abs(float(logs[k]) - float(want[k])) <= TOL * abs(
            float(want[k])), (k, float(logs[k]), float(want[k]))
    want_norm = np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum()
                            for g in jax.tree_util.tree_leaves(t["grads"])))
    assert abs(float(logs["grad_norm"]) - want_norm) <= TOL * want_norm


def clip_coef(trained) -> float:
    """The factor the optimizer's clip scaled the step's gradients by."""
    norm = float(trained["logs"]["grad_norm"])
    return min(1.0, OPT["grad_clip"] / (norm + 1e-6))


def test_grounding_train_gradients_match_jax(trained):
    """Each gradient (before the step's clipping) within 2e-4 of its
    tensor's largest |JAX gradient|, or of 1e-3 of the largest of all
    where a tensor's is near zero (biases before a GroupNorm, whose exact
    gradient is zero); the output norms' biases, whose maps enter only the
    ChannelMapper's GroupNorms (a per-channel shift there mostly cancels,
    leaving a gradient of rounding-sized residue), within 2e-4 of the
    largest of all."""
    t = trained
    want = state_dict_from_flax(t["grads"], t["v"]["batch_stats"])
    named = dict(t["port"].named_parameters())
    assert set(named) <= set(want)
    top = max(float(want[n].abs().max()) for n in named)
    coef = clip_coef(t)
    assert coef < 1.0        # the clipping acted
    for n, p in named.items():
        w = want[n].numpy()
        scale = (top if n in BEFORE_GN
                 else max(float(np.abs(w).max()), 1e-3 * top))
        err = float(np.abs(p.grad.numpy() / coef - w).max())
        assert err <= TOL * scale, (n, err, scale)


def test_grounding_optimizer_step_matches_optax(trained):
    """The parameters that moved are optax's; the unused `up` map and
    `norm1` got zero gradients (the 4-d `up` kernel decayed, as optax
    decays it); where a clipped gradient is above 1e-2 of its tensor's
    largest and 100 times Adam's eps the AdamW step equals optax's within
    1e-3 of the learning rate."""
    t = trained
    want = state_dict_from_flax(t["stepped"], t["v"]["batch_stats"])
    start = state_dict_from_flax(t["v"]["params"], t["v"]["batch_stats"])
    grads = state_dict_from_flax(t["grads"], t["v"]["batch_stats"])
    named = dict(t["port"].named_parameters())
    moved = {n for n, p in named.items()
             if not torch.equal(p.detach(), t["before"][n])}
    want_moved = {n for n in named if not torch.equal(want[n], start[n])}
    assert moved == want_moved, sorted(moved ^ want_moved)[:8]
    assert "backbone.up.weight" in moved
    assert "backbone.norm1.weight" not in moved
    lr, coef = OPT["base_lr"], clip_coef(t)
    for n, p in named.items():
        g = grads[n].abs() * coef
        big = (g > 1e-2 * float(g.max())) & (g > 1e-6)
        if not big.any():
            continue
        err = float((p.detach() - want[n])[big].abs().max())
        assert err <= 1e-3 * lr, (n, err)


def test_layer_decay_and_weight_decay_match_jax():
    """Per parameter: the layer-decay scale and the weight-decay mask of
    JAX's rules on JAX's names (`trunk/visual_embed/proj` scale 1,
    `token_embed/pos_embed` id 0 without decay, the trunk's `layers_N`
    the last id) equal the port's on its reference names."""
    v = _variables()
    depth, rate = 4, 0.8
    named = list(GroundingDINO(UniPerceiverAdapter(**BACKBONE,
                                                   device="meta"),
                               device="meta", **HEAD).named_parameters())

    def by_port_name(tree):
        full = jax.tree_util.tree_map(
            lambda p, s: np.full(np.shape(p), float(s), np.float32),
            v["params"], tree)
        sd = state_dict_from_flax(full, v["batch_stats"])
        out = {}
        for n, t in sd.items():
            if "running_" in n:
                continue
            vals = np.unique(t.numpy())
            assert len(vals) == 1, (n, vals)
            out[n] = float(vals[0])
        return out

    want_scale = by_port_name(joptim.layer_decay_scales(v["params"], depth,
                                                        rate))
    want_decay = by_port_name(joptim.weight_decay_mask(v["params"]))
    got_scale = toptim.layer_decay_scales(named, depth, rate)
    got_decay = toptim.weight_decay_mask(named)
    assert {n for n, _ in named} == set(want_scale)
    for n, _ in named:
        assert got_scale[n] == pytest.approx(want_scale[n], rel=1e-6), n
        assert float(got_decay[n]) == want_decay[n], n
    proj = "backbone.visual_embed.patch_embed.proj.weight"
    text_pos = "backbone.token_embed.embeddings_pos.position_embeddings.weight"
    assert got_scale[proj] == 1.0 and got_decay[proj]
    assert got_scale[text_pos] == rate ** (depth + 1)
    assert not got_decay[text_pos]
    assert got_scale["backbone.layers.0.linear1.weight"] == 1.0
    assert got_scale[
        "backbone.visual_embed.patch_embed.spatial_pos_embed.weight"] == \
        rate ** (depth + 1)
