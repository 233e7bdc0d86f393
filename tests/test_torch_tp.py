"""The port's tensor parallelism on the CPU (`vitadapter_torch/parallel/
tp.py`): four gloo ranks on a (data 2, model 2) grid take one train step of
the tiny Mask2Former of `test_torch_train_step.py`, held against the JAX
package's step under `vitadapter.parallel.tp.shard_state` on the same
(2, 2) mesh of CPU devices, with the same weights, batch and loss draws
(each data rank's sampler replays its share of JAX's draws, the same on
both ranks of its model group).

The ranks are spawned once for the module (`ddp_workers.spawn_ranks`,
bodies in `parallel_workers`) and import no JAX; this process traces and
runs JAX's step meanwhile. Tolerances: the loss within 2e-4 relative and
the gradient norm within 2e-3 (JAX's own bounds between its TP and data
parallel steps, `test_multichip_tp.py`); each gathered parameter's change
within 1e-2 of the leaf's largest change where JAX's gradient is at least
5% of the leaf's largest (`test_torch_ddp.py`'s rule); every rank's
gathered parameters bitwise equal."""

import jax
import numpy as np
import pytest
import torch

from vitadapter.heads import mask2former_loss as jloss
from vitadapter.heads.mask2former import Mask2FormerHead as JHead
from vitadapter.models.mask2former_segmentor import \
    EncoderDecoderMask2Former as JM2F
from vitadapter.models.vit_adapter import ViTAdapter as JViTAdapter
from vitadapter.ops import matching as jmatching
from vitadapter.parallel import tp as jtp
from vitadapter.train import optim as joptim
from vitadapter.train import trainer as jtrainer
from vitadapter_torch.parallel import tp
from vitadapter_torch.utils.weights import load_flax, state_dict_from_flax

import ddp_workers as W
import parallel_workers as PW
from test_torch_ddp import flax_init, one_torch_thread, seg_batch  # noqa: F401
from torch_port_util import (TINY_TRAIN, TINY_TRAIN_BACKBONE,
                             TINY_TRAIN_HEAD, jax_loss_draws, to_np)


def tp_mesh_step(step_fn, params, stats, batch, rng):
    """JAX's step with the state split by `shard_state` over a (2, 2) mesh
    and the batch by `shard_batch_2d`: (new state, logs, the clipped
    gradients, Adam's first moment over 1 - b1 after one step)."""
    mesh = jtp.make_tp_mesh(jax.devices()[:PW.WORLD], tp=PW.TP)
    tx, _ = joptim.make_optimizer(params, **W.M2F_OPT)
    state = jtp.shard_state(mesh, jtrainer.TrainState.create(params, stats,
                                                             tx))
    with jax.default_matmul_precision("highest"):
        jstate, jlogs = jax.jit(step_fn)(state, jtp.shard_batch_2d(mesh,
                                                                   batch),
                                         rng)
    jstate, jlogs = jax.device_get((jstate, jlogs))
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                   jstate.opt_state[1].mu)
    return jstate, jlogs, grads


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp")
    jm2f = JM2F(backbone=JViTAdapter(**TINY_TRAIN_BACKBONE),
                decode_head=JHead(**TINY_TRAIN_HEAD))
    params, stats = flax_init(jm2f, 50)
    batch = seg_batch(52, TINY_TRAIN_HEAD["num_classes"], few=True)
    rng = jax.random.PRNGKey(53)
    draws = jax_loss_draws(jax.random.split(rng)[1], W.M2F_OUTPUTS, 2,
                           TINY_TRAIN_HEAD["num_queries"],
                           TINY_TRAIN["num_points"])
    model = W.m2f_model()
    load_flax(model, params, stats)
    W.save(work / "inputs.pkl", {"state_dict": model.state_dict(),
                                 "batch": batch, "draws": draws})
    finish = W.spawn_ranks("parallel_workers:tp_step", work, PW.WORLD)
    try:
        mp = pytest.MonkeyPatch()
        # the Pallas auction (interpret mode), whose matches the port's CPU
        # auction makes (`test_torch_train_step.py`)
        mp.setattr(jloss, "hungarian_assign", lambda c, n: (
            jmatching.hungarian_assign(c, n, "auction_pallas")))
        try:
            ref = tp_mesh_step(jtrainer.make_m2f_train_step(
                jm2f, TINY_TRAIN_HEAD["num_classes"], **TINY_TRAIN),
                params, stats, batch, rng)
        finally:
            mp.undo()
        one = W.seg_step("m2f", model.state_dict(), batch, draws)
    finally:
        ranks = finish()
    return {"ranks": ranks, "ref": ref, "params": params, "stats": stats,
            "jm2f": jm2f, "one_process": one}


def test_the_tp_ranks_import_no_jax(run):
    assert [r["loaded"] for r in run["ranks"]] == [[]] * PW.WORLD


def test_tp_step_logs_jax_tp_step(run):
    """Every rank logs the global batch's loss within 2e-4 and the
    gradient norm (JAX's norm of the logical arrays) within 2e-3."""
    _, jlogs, _ = run["ref"]
    for rank in run["ranks"]:
        logs = rank["logs"]
        np.testing.assert_allclose(logs["loss"], float(jlogs["loss"]),
                                   rtol=2e-4)
        np.testing.assert_allclose(logs["grad_norm"],
                                   float(jlogs["grad_norm"]), rtol=2e-3)


def test_tp_step_takes_jax_tp_update(run):
    """The gathered parameters after the step: bitwise equal on the four
    ranks, and JAX's change where its gradient is well resolved."""
    jstate, _, jgrads = run["ref"]
    stats = run["stats"]
    want = state_dict_from_flax(jax.device_get(jstate.params), stats)
    before = state_dict_from_flax(run["params"], stats)
    grads = state_dict_from_flax(jgrads, stats)
    floor = 1e-4 * max(float(np.abs(to_np(g)).max()) for g in grads.values())
    got = [r["params"] for r in run["ranks"]]
    for other in got[1:]:
        for n in got[0]:
            np.testing.assert_array_equal(other[n], got[0][n], err_msg=n)
    names = list(run["ranks"][0]["grads"])
    moved = checked = 0
    for n in names:
        d = got[0][n] - to_np(before[n])
        ref = to_np(want[n]) - to_np(before[n])
        g = np.abs(to_np(grads[n]))
        sure = g >= 0.05 * max(g.max(), floor)
        np.testing.assert_allclose(d[sure], ref[sure], rtol=0,
                                   atol=1e-2 * np.abs(ref).max(), err_msg=n)
        checked += int(sure.sum())
        moved += int(np.any(d != 0))
    assert moved > 0.9 * len(names)
    assert checked > 0.1 * sum(got[0][n].size for n in names)


# JAX's own TP step gives the adapter's depthwise-conv kernels (ConvFFN's
# `dwconv`, replicated) twice the gradient its data-parallel step gives
# them (XLA's partitioning of the grouped convolution's weight gradient
# over the (data, model) mesh); the port's TP step gives the data-parallel
# gradient, which `test_torch_ddp.py` holds against JAX's
JAX_TP_DOUBLES = "ffn.dwconv.dwconv.weight"


def test_tp_gathered_gradients_are_one_process_gradients(run):
    """The clipped gradients gathered from the shards against the port's
    one-process step on the whole batch (all draws), and against JAX's TP
    step but for `JAX_TP_DOUBLES`, within 2e-3 of each leaf's largest
    (`test_torch_ddp.py`'s bound)."""
    _, _, jgrads = run["ref"]
    jax_tp = state_dict_from_flax(jgrads, run["stats"])
    one = run["one_process"][2]
    for want in (one, {n: g for n, g in jax_tp.items()
                       if not n.endswith(JAX_TP_DOUBLES)}):
        floor = 1e-4 * max(float(np.abs(to_np(g)).max())
                           for g in want.values())
        for rank in run["ranks"]:
            assert set(rank["grads"]) == set(one)
            for n, g in rank["grads"].items():
                if n not in want:
                    continue
                w = to_np(want[n])
                assert g.shape == w.shape, n
                np.testing.assert_allclose(g, w, rtol=0, atol=2e-3 * max(
                    np.abs(w).max(), floor), err_msg=n)
    assert sum(n.endswith(JAX_TP_DOUBLES) for n in one) == 4


def _marked(shape, spec, tp_size):
    """An array of `shape` whose entries are 1 + the model rank that holds
    them under `spec` (a `PartitionSpec` in JAX's layout), 0 if whole."""
    axes = [i for i, a in enumerate(spec) if a == "model"]
    if not axes:
        return np.zeros(shape, np.float32)
    a = axes[0] + len(shape) - len(spec)
    idx = np.arange(shape[a]) * tp_size // shape[a] + 1
    return np.broadcast_to(np.expand_dims(
        idx, tuple(i for i in range(len(shape)) if i != a)),
        shape).astype(np.float32)


def test_partition_specs_split_what_jax_splits(run):
    """Each port parameter's split, read through the weight converter:
    JAX's specs mark each leaf's entries with the model rank that holds
    them, the converter carries the marks to the port's names and layout,
    and `partition_specs` must split the same parameters along the same
    dim, marking the same entries (q, k and v each cut by heads in the
    packed `in_proj_weight`). JAX's packed ViT `qkv` kernel is one leaf cut
    contiguously (rank 0 holds q and half of k), which GSPMD can compute
    but a rank that attends on its own cannot: there the port cuts q, k
    and v by heads along the same dim."""
    shapes = jax.eval_shape(
        lambda x: run["jm2f"].init(jax.random.PRNGKey(0), x),
        jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32))["params"]
    jspecs = jtp.partition_specs(shapes)
    marks = jax.tree_util.tree_map(
        lambda s, spec: _marked(s.shape, spec, PW.TP), shapes, jspecs,
        is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    stats = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   run["stats"])
    want = state_dict_from_flax(marks, stats)
    specs = run["ranks"][0]["specs"]
    assert all(r["specs"] == specs for r in run["ranks"])
    split = 0
    for n, spec in specs.items():
        w = to_np(want[n])
        got = np.zeros_like(w)
        if spec is not None:
            split += 1
            for b, block in enumerate(np.split(np.arange(w.shape[spec.dim]),
                                               spec.blocks)):
                for m, rows in enumerate(np.array_split(block, PW.TP)):
                    sl = [slice(None)] * w.ndim
                    sl[spec.dim] = rows
                    got[tuple(sl)] = m + 1
        if n.endswith(("attn.qkv.weight", "attn.qkv.bias")):
            dims = [d for d in range(w.ndim) if np.ptp(w, axis=d).any()]
            assert dims == [spec.dim] and spec.blocks == 3, n
        else:
            np.testing.assert_array_equal(got, w, err_msg=n)
    assert split == sum(1 for w in want.values() if to_np(w).any()) > 0
    assert sum(1 for n, spec in specs.items() if spec is not None
               and n.endswith("in_proj_weight")) == 4


def test_each_rank_holds_its_heads(run):
    """A rank's `qkv` weight and its AdamW first moment are the (3C/tp, C)
    shard of its heads, and a block whose heads the model group does not
    divide is refused, naming the layer."""
    C = TINY_TRAIN_BACKBONE["embed_dim"]
    heads = TINY_TRAIN_BACKBONE["num_heads"]
    for rank in run["ranks"]:
        assert rank["shapes"] == {"qkv": (3 * C // PW.TP, C),
                                  "exp_avg": (3 * C // PW.TP, C),
                                  "heads": heads // PW.TP}
        assert rank["refused"] == (f"attn: {PW.BAD_HEADS} heads do not split "
                                   f"over a model group of {PW.WORLD}")


def test_shard_model_cuts_qkv_by_heads():
    """In one process: the packed qkv cut for model rank m holds rows
    [j C + m C/tp, j C + (m+1) C/tp) of q, k and v (j = 0, 1, 2), and the
    shards put back together are the whole."""
    w = torch.arange(24.0).reshape(12, 2)
    split = tp.Split(0, 3)
    shards = [tp._cut(w, split, m, 2) for m in range(2)]
    assert shards[0][:, 0].tolist() == [0, 2, 8, 10, 16, 18]
    assert shards[1][:, 0].tolist() == [4, 6, 12, 14, 20, 22]
    blocks = [s.chunk(3) for s in shards]
    whole = torch.cat([torch.cat([b[j] for b in blocks]) for j in range(3)])
    assert torch.equal(whole, w)
