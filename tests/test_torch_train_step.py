"""One whole Mask2Former train step of the port against the JAX package's
`make_m2f_train_step`, on the tiny model of `torch_port_util` cut to 2
blocks and 2 decoder layers (3 outputs; `test_torch_train_ops` covers all
10 outputs of the head and the loss), fp32, CPU.

Both sides start from the same random weights and BatchNorm statistics
(carried by `load_flax`) and take one step on the same batch: the forward in
training mode (BatchNorm on batch statistics, drop path 0 because JAX's
dropout bits cannot be replayed), the loss over all decoder outputs with the
port's sampler replaying JAX's draws and JAX pinned to the Pallas auction in
interpret mode (the port's CPU auction makes the same matches), the
backward, and one update of the bench's optimizer (clip 0.01, layer decay;
no warmup, so the first step moves the parameters).

Tolerances: loss and logs 1e-4 (fp32 sums in another order); each clipped
gradient leaf within 2e-3 of that leaf's max |value| (the backward through
the decoder layers and the bf16-sampled mask logits reorders and rounds
more); each parameter's change within 1e-2 of the leaf's largest change,
where the gradient is at least 5% of the leaf's largest (Adam's first step
is about lr * sign(g), so it is decided only where the gradient is well
resolved; a missing, reversed or mis-scaled update is off by 100%);
BatchNorm statistics 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from vitadapter.heads import mask2former_loss as jloss
from vitadapter.heads.mask2former import Mask2FormerHead as JHead
from vitadapter.models.mask2former_segmentor import \
    EncoderDecoderMask2Former as JSeg
from vitadapter.models.vit_adapter import ViTAdapter as JViTAdapter
from vitadapter.ops import matching as jmatching
from vitadapter.train import optim as joptim
from vitadapter.train import trainer as jtrainer
from vitadapter_torch.heads.mask2former import Mask2FormerHead
from vitadapter_torch.models.mask2former_segmentor import \
    EncoderDecoderMask2Former
from vitadapter_torch.models.vit_adapter import ViTAdapter
from vitadapter_torch.train import optim as toptim
from vitadapter_torch.train import trainer as ttrainer
from vitadapter_torch.utils.weights import load_flax, state_dict_from_flax

from torch_port_util import (TINY_TRAIN, TINY_TRAIN_BACKBONE,
                             TINY_TRAIN_HEAD, ReplaySampler, jax_loss_draws,
                             randomize_flax, to_np)

BACKBONE, HEAD = TINY_TRAIN_BACKBONE, TINY_TRAIN_HEAD
N_OUT = HEAD["num_decoder_layers"] + 1

OPT = dict(base_lr=1e-4, depth=BACKBONE["depth"], total_steps=1000,
           warmup_steps=0, grad_clip=0.01)
LOG_KEYS = {"loss", "grad_norm", "loss_cls", "loss_mask", "loss_dice"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make the small eager ops here many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def step_pair():
    """(jax new state, jax logs, jax grads, port model, port logs, initial
    flax params), after one step on each side."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jloss, "hungarian_assign",
               lambda c, n: jmatching.hungarian_assign(c, n, "auction_pallas"))
    jm = JSeg(backbone=JViTAdapter(**BACKBONE),
              decode_head=JHead(**HEAD))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            np.zeros((1, 64, 64, 3), np.float32))
    params = randomize_flax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 50)
    stats = randomize_flax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["batch_stats"]), 51,
        stats=True)
    rs = np.random.RandomState(52)
    label = rs.randint(0, HEAD["num_classes"], (2, 64, 64))
    label[1, :8] = 255
    batch = {"image": rs.randn(2, 64, 64, 3).astype(np.float32),
             "label": label.astype(np.int32)}

    tx, _ = joptim.make_optimizer(params, **OPT)
    state = jtrainer.TrainState.create(params, stats, tx)
    step = jax.jit(jtrainer.make_m2f_train_step(
        jm, HEAD["num_classes"], **TINY_TRAIN))
    rng = jax.random.PRNGKey(53)
    jstate, jlogs = step(state, batch, rng)
    jstate, jlogs = jax.device_get((jstate, jlogs))
    mp.undo()
    # the clipped gradient is (1 - b1) times Adam's first moment after one
    # step (the port's step leaves the clipped gradient in p.grad)
    jgrads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                    jstate.opt_state[1].mu)

    model = EncoderDecoderMask2Former(
        ViTAdapter(**BACKBONE),
        Mask2FormerHead([BACKBONE["embed_dim"]] * 4, **HEAD))
    load_flax(model, params, stats)
    opt, _ = toptim.make_optimizer(model, **OPT)
    tstate = ttrainer.TrainState.create(model, opt)
    tstep = ttrainer.make_m2f_train_step(model, HEAD["num_classes"],
                                         **TINY_TRAIN)
    _, r_loss = jax.random.split(rng)
    sampler = ReplaySampler(jax_loss_draws(
        r_loss, N_OUT, 2, HEAD["num_queries"], TINY_TRAIN["num_points"]))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tstate, tlogs = tstep(tstate, tbatch, torch.Generator().manual_seed(0),
                          sampler)
    assert sampler.done()
    assert tstate.step == 1
    return jstate, jlogs, jgrads, model, tlogs, params, stats


def test_train_step_loss_and_logs_match_jax(step_pair):
    _, jlogs, _, _, tlogs, _, _ = step_pair
    assert set(tlogs) == set(jlogs) == LOG_KEYS
    for k in LOG_KEYS:
        assert tlogs[k].dim() == 0
        np.testing.assert_allclose(float(tlogs[k]), float(jlogs[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def _grad_floor(grads):
    """The biases of the two convolutions in front of norm1 (a BatchNorm on
    batch statistics) have an analytic gradient of zero and carry only
    rounding noise: each leaf's scale is floored at 1e-4 of the step's
    largest gradient, which no other leaf comes near."""
    return 1e-4 * max(float(np.abs(to_np(w)).max()) for w in grads.values())


def test_train_step_gradients_match_jax(step_pair):
    _, _, jgrads, model, _, _, stats = step_pair
    want = state_dict_from_flax(jgrads, stats)
    floor = _grad_floor(want)
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    for n, p in named.items():
        assert p.grad is not None, n
        w = to_np(want[n])
        np.testing.assert_allclose(to_np(p.grad), w, rtol=0,
                                   atol=2e-3 * max(np.abs(w).max(), floor),
                                   err_msg=n)


def test_train_step_parameters_match_jax(step_pair):
    jstate, _, jgrads, model, _, params, stats = step_pair
    want = state_dict_from_flax(jax.device_get(jstate.params), stats)
    before = state_dict_from_flax(params, stats)
    grads = state_dict_from_flax(jgrads, stats)
    floor = _grad_floor(grads)
    moved = checked = 0
    for n, p in model.named_parameters():
        got = to_np(p) - to_np(before[n])
        ref = to_np(want[n]) - to_np(before[n])
        g = np.abs(to_np(grads[n]))
        sure = g >= 0.05 * max(g.max(), floor)
        np.testing.assert_allclose(got[sure], ref[sure], rtol=0,
                                   atol=1e-2 * np.abs(ref).max(), err_msg=n)
        checked += int(sure.sum())
        moved += int(not torch.equal(p.detach(), before[n]))
    n_params = len(list(model.parameters()))
    assert moved > 0.9 * n_params
    assert checked > 0.1 * sum(p.numel() for p in model.parameters())


def test_train_step_batch_stats_match_jax(step_pair):
    jstate, _, _, model, _, params, _ = step_pair
    want = state_dict_from_flax(params, jax.device_get(jstate.batch_stats))
    sd = model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 10        # 6 spatial-prior BNs + norm1-4
    for k in keys:
        np.testing.assert_allclose(to_np(sd[k]), to_np(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
