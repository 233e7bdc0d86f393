"""The port's data parallelism on the CPU (`vitadapter_torch/parallel/`):
two gloo ranks, one image each, against the JAX package's step over a
2-device mesh (`vitadapter.parallel.mesh`: the state replicated, the
batch of two sharded, under `jax.jit`), which is the global-batch step the
ranks must reproduce.

The ranks are spawned once for the module (`ddp_workers.spawn_ranks`) and
run, while this process traces and runs JAX's steps: the UperNet step and
the Mask2Former step of `test_torch_seg_train.py` and
`test_torch_train_step.py` (their tiny geometry and weights; batches
with `label[1, :8] = 255`, the ignored pixels in one rank's image only,
and for Mask2Former a second image of 2 classes, which matches fewer
masks than the first: each normalizer then differs between the ranks;
each rank's loss sampler replaying its share of JAX's draws); SyncBN
alone;
`run_eval` over three images; the step-keyed train batches; and the
train CLI with `--multi-host`, two steps and a resume. The ranks import
no JAX.

Tolerances are those of the one-process tests: logs 1e-4 relative; each
clipped gradient leaf within 2e-3 of the leaf's largest; each parameter's
change within 1e-2 of the leaf's largest change where JAX's gradient is at
least 5% of the leaf's largest; running statistics 1e-5. SyncBN against
BatchNorm on the concatenated batch 1e-5; the confusion matrix and the
batches exactly; the two ranks' parameters bitwise equal."""

import jax
import numpy as np
import pytest
import torch

from vitadapter.heads import mask2former_loss as jloss
from vitadapter.heads.mask2former import Mask2FormerHead as JHead
from vitadapter.heads.upernet import FCNHead as JFCNHead
from vitadapter.heads.upernet import UPerHead as JUPerHead
from vitadapter.models.mask2former_segmentor import \
    EncoderDecoderMask2Former as JM2F
from vitadapter.models.segmentor import EncoderDecoder as JSeg
from vitadapter.models.vit_adapter import ViTAdapter as JViTAdapter
from vitadapter.ops import matching as jmatching
from vitadapter.parallel.mesh import make_mesh, replicate, shard_batch
from vitadapter.train import optim as joptim
from vitadapter.train import trainer as jtrainer
from vitadapter_torch.utils.weights import load_flax, state_dict_from_flax

import ddp_workers as W
from torch_port_util import (TINY_TRAIN, TINY_TRAIN_BACKBONE,
                             TINY_TRAIN_HEAD, jax_loss_draws, randomize_flax,
                             to_np)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make these small eager ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flax_init(jm, seed, **kw):
    """Random flax parameters and BatchNorm statistics of `jm` on 64x64
    inputs (seeds `seed` and `seed + 1`)."""
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, **kw),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    return (randomize_flax(zeros["params"], seed),
            randomize_flax(zeros["batch_stats"], seed + 1, stats=True))


def seg_batch(seed, K, few=False):
    """Two images with random labels of K classes (with `few`, the second
    image's of 2 classes only, so that the images match different numbers
    of masks); the second image's first 8 rows ignored."""
    rs = np.random.RandomState(seed)
    label = rs.randint(0, K, (2, 64, 64))
    if few:
        label[1] %= 2
    label[1, :8] = 255
    return {"image": rs.randn(2, 64, 64, 3).astype(np.float32),
            "label": label.astype(np.int32)}


def mesh_step(step_fn, params, stats, batch, opt, rng):
    """JAX's step over a 2-device mesh: (new state, logs, the clipped
    gradients, which are Adam's first moment over 1 - b1 after one
    step)."""
    mesh = make_mesh(jax.devices()[:2])
    tx, _ = joptim.make_optimizer(params, **opt)
    state = replicate(mesh, jtrainer.TrainState.create(params, stats, tx))
    with jax.default_matmul_precision("highest"):
        jstate, jlogs = jax.jit(step_fn)(state, shard_batch(mesh, batch),
                                         rng)
    jstate, jlogs = jax.device_get((jstate, jlogs))
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                   jstate.opt_state[1].mu)
    return jstate, jlogs, grads


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results and the references: JAX's mesh steps (UperNet
    and Mask2Former, with their initial weights) and the one-process
    SyncBN, batches and `run_eval`."""
    work = tmp_path_factory.mktemp("ddp")
    K = W.UPERNET_K
    jup = JSeg(backbone=JViTAdapter(**W.UPERNET_BACKBONE),
               decode_head=JUPerHead(**W.UPERNET_HEAD),
               auxiliary_head=JFCNHead(**W.UPERNET_AUX))
    up_params, up_stats = flax_init(jup, 60, with_aux=True)
    up_batch = seg_batch(62, K)
    up_model = W.upernet_model()
    load_flax(up_model, up_params, up_stats)

    jm2f = JM2F(backbone=JViTAdapter(**TINY_TRAIN_BACKBONE),
                decode_head=JHead(**TINY_TRAIN_HEAD))
    m2f_params, m2f_stats = flax_init(jm2f, 50)
    m2f_batch = seg_batch(52, TINY_TRAIN_HEAD["num_classes"], few=True)
    rng = jax.random.PRNGKey(53)
    draws = jax_loss_draws(jax.random.split(rng)[1], W.M2F_OUTPUTS, 2,
                           TINY_TRAIN_HEAD["num_queries"],
                           TINY_TRAIN["num_points"])
    m2f_model = W.m2f_model()
    load_flax(m2f_model, m2f_params, m2f_stats)

    W.save(work / "inputs.pkl", {
        "upernet": {"state_dict": up_model.state_dict(), "batch": up_batch},
        "m2f": {"state_dict": m2f_model.state_dict(), "batch": m2f_batch,
                "draws": draws}})
    (work / "upernet_tiny.py").write_text(W.CLI_CFG)
    finish = W.spawn_ranks("seg", work)
    try:
        jax_up = mesh_step(jtrainer.make_seg_train_step(jup, 0.4), up_params,
                           up_stats, up_batch, W.UPERNET_OPT,
                           jax.random.PRNGKey(63))
        mp = pytest.MonkeyPatch()
        # the Pallas auction (interpret mode), whose matches the port's CPU
        # auction makes (`test_torch_train_step.py`)
        mp.setattr(jloss, "hungarian_assign", lambda c, n: (
            jmatching.hungarian_assign(c, n, "auction_pallas")))
        try:
            jax_m2f = mesh_step(jtrainer.make_m2f_train_step(
                jm2f, TINY_TRAIN_HEAD["num_classes"], **TINY_TRAIN),
                m2f_params, m2f_stats, m2f_batch, W.M2F_OPT, rng)
        finally:
            mp.undo()
        refs = {"syncbn": W.syncbn_case(), "sampler": W.sampler_batches(),
                "eval": W.seg_eval(up_model.state_dict())}
    finally:
        ranks = finish()
    return {"ranks": ranks, "refs": refs,
            "upernet": (jax_up, up_params, up_stats),
            "m2f": (jax_m2f, m2f_params, m2f_stats)}


LOG_KEYS = {"upernet": {"loss", "grad_norm", "loss_decode", "loss_aux"},
            "m2f": {"loss", "grad_norm", "loss_cls", "loss_mask",
                    "loss_dice"}}


def test_the_ranks_import_no_jax(run):
    assert [r["loaded"] for r in run["ranks"]] == [[], []]


@pytest.mark.parametrize("kind", ["upernet", "m2f"])
def test_two_ranks_log_jax_mesh_step(run, kind):
    """The logged loss, its parts and the gradient norm (before clipping)
    on each rank: the global batch's, as JAX logs them."""
    (_, jlogs, _), _, _ = run[kind]
    for rank in run["ranks"]:
        logs = rank[kind][0]
        assert set(logs) == set(jlogs) == LOG_KEYS[kind]
        for k in LOG_KEYS[kind]:
            np.testing.assert_allclose(logs[k], float(jlogs[k]), rtol=1e-4,
                                       atol=1e-4 if kind == "m2f" else 0,
                                       err_msg=k)


def _grad_floor(grads):
    """Biases in front of a BatchNorm on batch statistics have a zero
    gradient in exact arithmetic: each leaf's scale is floored at 1e-4 of
    the step's largest gradient."""
    return 1e-4 * max(float(np.abs(to_np(g)).max()) for g in grads.values())


@pytest.mark.parametrize("kind", ["upernet", "m2f"])
def test_two_ranks_average_jax_mesh_gradients(run, kind):
    """Each rank's clipped gradient (the ranks' gradients averaged, then
    clipped by the global norm) against JAX's."""
    (_, _, jgrads), _, stats = run[kind]
    want = state_dict_from_flax(jgrads, stats)
    floor = _grad_floor(want)
    for rank in run["ranks"]:
        grads = rank[kind][2]
        assert set(grads) <= set(want) and len(grads) > 0.9 * len(
            [k for k in want if not k.endswith(("running_mean",
                                                "running_var",
                                                "num_batches_tracked"))])
        for n, g in grads.items():
            w = to_np(want[n])
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-3 * max(
                np.abs(w).max(), floor), err_msg=n)


@pytest.mark.parametrize("kind", ["upernet", "m2f"])
def test_two_ranks_take_jax_mesh_update(run, kind):
    """Each rank's parameters after the step: the same on both ranks
    (bitwise), and JAX's change where its gradient is well resolved."""
    (jstate, _, jgrads), params, stats = run[kind]
    want = state_dict_from_flax(jax.device_get(jstate.params), stats)
    before = state_dict_from_flax(params, stats)
    grads = state_dict_from_flax(jgrads, stats)
    floor = _grad_floor(grads)
    got0, got1 = (r[kind][1] for r in run["ranks"])
    names = list(run["ranks"][0][kind][2])
    for n in got0:
        np.testing.assert_array_equal(got0[n], got1[n], err_msg=n)
    moved = checked = 0
    for n in names:
        got = got0[n] - to_np(before[n])
        ref = to_np(want[n]) - to_np(before[n])
        g = np.abs(to_np(grads[n]))
        sure = g >= 0.05 * max(g.max(), floor)
        np.testing.assert_allclose(got[sure], ref[sure], rtol=0,
                                   atol=1e-2 * np.abs(ref).max(), err_msg=n)
        checked += int(sure.sum())
        moved += int(np.any(got != 0))
    assert moved > 0.9 * len(names)
    assert checked > 0.1 * sum(got0[n].size for n in names)


@pytest.mark.parametrize("kind", ["upernet", "m2f"])
def test_two_ranks_move_jax_mesh_running_statistics(run, kind):
    """SyncBN: every running statistic on each rank is the one JAX takes
    over the global batch (UperNet: the backbone's 10 BatchNorms and the
    heads' 13; Mask2Former: the backbone's 10)."""
    (jstate, _, _), params, _ = run[kind]
    want = state_dict_from_flax(params, jax.device_get(jstate.batch_stats))
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * (23 if kind == "upernet" else 10)
    for rank in run["ranks"]:
        sd = rank[kind][1]
        for k in keys:
            np.testing.assert_allclose(sd[k], to_np(want[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_syncbn_equals_batchnorm_on_the_whole_batch(run):
    """Each rank's rows of the output and of the input's gradient, the
    running statistics, and the weight and bias gradients summed over the
    ranks (each rank's share of the loss), against BatchNorm in one
    process on the concatenated batch."""
    ref = run["refs"]["syncbn"]
    for r, rank in enumerate(run["ranks"]):
        got = rank["syncbn"]
        for k in ("y", "dx"):
            np.testing.assert_allclose(got[k], ref[k][W.rows(r, 4)],
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    for k in ("dweight", "dbias"):
        np.testing.assert_allclose(
            sum(rank["syncbn"][k] for rank in run["ranks"]), ref[k],
            rtol=1e-5, atol=1e-5, err_msg=k)


def test_run_eval_on_two_ranks_equals_one_process(run):
    """Three images over two ranks (rank 0 scores two, rank 1 one): each
    rank's confusion matrix is one process's, exactly."""
    ref = run["refs"]["eval"]
    assert ref.sum() > 0
    for rank in run["ranks"]:
        np.testing.assert_array_equal(rank["eval"], ref)


def test_step_batches_split_the_one_process_batches(run):
    """Over an epoch (3 steps of a global batch of 2 from 6 images) the two
    ranks take every index once, and step k's rows of rank 0 then rank 1
    are the one-process batch of step k, images and labels exactly."""
    taken = [i for k in range(W.SAMPLER_STEPS) for rank in run["ranks"]
             for i in rank["sampler"][1][k]]
    assert sorted(taken) == list(range(W.SAMPLER_N))
    ref_batches, ref_taken = run["refs"]["sampler"]
    assert [i for t in ref_taken for i in t] == taken
    for k, ref in enumerate(ref_batches):
        for key in ("image", "label"):
            got = np.concatenate([rank["sampler"][0][k][key]
                                  for rank in run["ranks"]])
            np.testing.assert_array_equal(got, ref[key])


def test_train_cli_with_multi_host_resumes_on_both_ranks(run):
    """`tools.train --multi-host` on two ranks: both end step 2 with the
    same parameters, rank 0 alone logs (a global batch of 2, the eval
    hook over the ranks), and `--resume` takes both ranks from step 2 to
    3, the only checkpoint left."""
    (s0, p0, logs0), (s1, p1, logs1) = (r["cli"]["first"]
                                        for r in run["ranks"])
    assert s0 == s1 == 2 and logs1 == []
    assert "data parallel over 2 ranks: 2 images a step" in logs0
    assert any("new best mIoU=" in line for line in logs0)
    for n in p0:
        np.testing.assert_array_equal(p0[n], p1[n], err_msg=n)
    (t0, q0, rlogs0), (t1, q1, rlogs1) = (r["cli"]["resumed"]
                                          for r in run["ranks"])
    assert t0 == t1 == 3 and "resumed from step 2" in rlogs0
    assert rlogs1 == []
    for n in q0:
        np.testing.assert_array_equal(q0[n], q1[n], err_msg=n)
    assert not all(np.array_equal(p0[n], q0[n]) for n in p0)
    assert [r["cli"]["saved"] for r in run["ranks"]] == [[3], [3]]
