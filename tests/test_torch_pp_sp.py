"""The port's pipeline and sequence parallelism on the CPU
(`vitadapter_torch/parallel/{pp,sp}.py`), four gloo ranks against the JAX
package's `pipeline_apply` and `msda_token_sharded` on four CPU devices,
with JAX's cases (`test_pipeline_pp.py`, `test_multichip_sp.py`):

  * GPipe: 8 MLP layers (dim 16, hidden 32) and 8 ViT blocks (dim 48, 4
    heads, 4x4 tokens), 4 microbatches, over 4 stages: the outputs (1e-5
    and 2e-5) and every layer's gradient of the outputs' sum (rtol 1e-4,
    atol 1e-5 of the leaf's largest magnitude where that is over 1: the
    ViT blocks' reach 150, where one fp32 rounding is 1e-5), which every
    rank takes, so that a broadcast whose backward summed the ranks'
    gradients would show as S times them;
  * MSDA with the 336 queries split over 4 ranks and the value whole: each
    rank's rows of the output (rtol 1e-5, atol 1e-6) and the gradients of
    the value (summed over the ranks), the locations and the weights (rtol
    1e-4, atol 1e-5); 338 queries are refused.

The ranks are spawned once for the module and import no JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vitadapter.models.vit import Block as JBlock
from vitadapter.parallel.pp import (make_pp_mesh, pipeline_apply,
                                    shard_stacked, stack_layer_params)
from vitadapter.parallel.sp import msda_token_sharded
from vitadapter_torch.utils.weights import block_from_flax

import ddp_workers as W
import parallel_workers as PW
from test_torch_ddp import one_torch_thread  # noqa: F401


def mlp_stack(seed=0):
    rng = np.random.RandomState(seed)
    return [{"w1": (rng.randn(PW.MLP_DIM, PW.MLP_HIDDEN) * 0.1
                    ).astype(np.float32),
             "b1": np.zeros(PW.MLP_HIDDEN, np.float32),
             "w2": (rng.randn(PW.MLP_HIDDEN, PW.MLP_DIM) * 0.1
                    ).astype(np.float32),
             "b2": np.zeros(PW.MLP_DIM, np.float32)}
            for _ in range(PW.MLP_DEPTH)]


def mlp_layer(p, x):
    y = jnp.tanh(x @ p["w1"] + p["b1"])
    return x + y @ p["w2"] + p["b2"]


def jax_pipeline(layer_fn, layers, xs):
    """JAX's `pipeline_apply` over 4 devices: the outputs and the
    gradients of their sum, one tree per layer."""
    mesh = make_pp_mesh(jax.devices()[:PW.WORLD])
    stacked = shard_stacked(mesh, stack_layer_params(layers))
    xs = jax.device_put(jnp.asarray(xs), NamedSharding(mesh, P()))

    def stage(params, x):
        return jax.lax.scan(lambda c, p: (layer_fn(p, c), None), x,
                            params)[0]

    def run(p, x):
        return pipeline_apply(stage, p, x, mesh)

    out = jax.jit(run)(stacked, xs)
    grads = jax.jit(jax.grad(lambda p, x: run(p, x).sum()))(stacked, xs)
    grads = jax.device_get(grads)
    return np.asarray(out), [jax.tree_util.tree_map(lambda g: np.asarray(
        g[i]), grads) for i in range(len(layers))]


def sp_inputs():
    """`test_multichip_sp.py::_inputs`."""
    shapes = ((16, 16), (8, 8), (4, 4))
    S = sum(h * w for h, w in shapes)
    B, Lq, M, L, Pn, D = 2, 336, 4, 3, 4, 8
    rng = np.random.RandomState(0)
    value = rng.randn(B, S, M, D).astype(np.float32)
    loc = (rng.rand(B, Lq, M, L, Pn, 2) * 1.2 - 0.1).astype(np.float32)
    attn = np.asarray(jax.nn.softmax(jnp.asarray(
        rng.randn(B, Lq, M, L * Pn), jnp.float32))).reshape(B, Lq, M, L, Pn)
    return shapes, value, loc, attn


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("pp_sp")
    layers = mlp_stack()
    mlp_xs = np.random.RandomState(1).randn(PW.N_MICRO, 2, PW.MLP_DIM
                                            ).astype(np.float32)
    blk = JBlock(num_heads=PW.VIT_HEADS, mlp_ratio=2.0)
    hw = PW.VIT_HW
    x0 = jnp.asarray(np.random.RandomState(2).randn(2, hw * hw, PW.VIT_DIM),
                     jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), PW.VIT_DEPTH)
    blocks = [jax.device_get(blk.init(k, x0, hw, hw)["params"]) for k in keys]
    vit_xs = np.random.RandomState(3).randn(PW.N_MICRO, 2, hw * hw,
                                            PW.VIT_DIM).astype(np.float32)
    shapes, value, loc, attn = sp_inputs()
    W.save(work / "inputs.pkl", {
        "mlp": {"layers": layers, "xs": mlp_xs},
        "vit": {"blocks": [block_from_flax(p) for p in blocks],
                "xs": vit_xs},
        "sp": {"shapes": shapes, "value": value, "loc": loc,
               "attn": attn}})
    finish = W.spawn_ranks("parallel_workers:pp_sp", work, PW.WORLD)
    try:
        with jax.default_matmul_precision("highest"):
            refs = {"mlp": jax_pipeline(mlp_layer, layers, mlp_xs),
                    "vit": jax_pipeline(
                        lambda p, x: blk.apply({"params": p}, x, hw, hw),
                        blocks, vit_xs),
                    "sp": jax_sp(shapes, value, loc, attn)}
            seq = jax.grad(lambda ls: mlp_sequential(ls, mlp_xs).sum())(
                layers)
    finally:
        ranks = finish()
    return {"ranks": ranks, "refs": refs, "mlp_sequential": seq}


def mlp_sequential(layers, xs):
    y = jnp.asarray(xs)
    for p in layers:
        y = mlp_layer(p, y)
    return y


def jax_sp(shapes, value, loc, attn):
    """JAX's `msda_token_sharded` over a 4-device `model` axis: the output
    and the gradients of its sum."""
    mesh = Mesh(np.asarray(jax.devices()[:PW.WORLD]), ("model",))

    def f(v, lo, a):
        return msda_token_sharded(v, shapes, lo, a, mesh)

    out = jax.jit(f)(value, loc, attn)
    grads = jax.jit(jax.grad(lambda *a: f(*a).astype(jnp.float32).sum(),
                             argnums=(0, 1, 2)))(value, loc, attn)
    return np.asarray(out), [np.asarray(g) for g in grads]


def test_the_pp_sp_ranks_import_no_jax(run):
    assert [r["loaded"] for r in run["ranks"]] == [[]] * PW.WORLD


@pytest.mark.parametrize("case,rtol", [("mlp", 1e-5), ("vit", 2e-5)])
def test_pipeline_outputs_are_jax_pipeline_outputs(run, case, rtol):
    """Every rank holds the last stage's outputs of every microbatch."""
    want = run["refs"][case][0]
    for rank in run["ranks"]:
        np.testing.assert_allclose(rank[case]["out"], want, rtol=rtol,
                                   atol=rtol)


@pytest.mark.parametrize("case", ["mlp", "vit"])
def test_pipeline_gradients_are_jax_pipeline_gradients(run, case):
    """Each stage's layers' gradients of the outputs' sum (every rank's
    loss the same logical loss) against JAX's, layer by layer, and each
    layer held by exactly one stage."""
    grads = run["refs"][case][1]
    held = {}
    for rank in run["ranks"]:
        for i, g in rank[case]["grads"].items():
            assert i not in held
            held[i] = g
    assert sorted(held) == list(range(len(grads)))
    for i, want in enumerate(grads):
        if case == "vit":
            want = {k: v.numpy() for k, v in block_from_flax(want).items()}
        assert set(held[i]) == set(want)
        for k, g in held[i].items():
            np.testing.assert_allclose(g, want[k], rtol=1e-4, atol=1e-5 * max(
                1.0, np.abs(want[k]).max()), err_msg=f"layer {i} {k}")


def test_pipeline_gradients_are_not_stage_count_times(run):
    """The MLP's pipeline gradients equal the sequential stack's (JAX on
    one device), not S = 4 times them: the outputs' broadcast passes back
    only the last stage's own gradient."""
    held = {i: g for rank in run["ranks"]
            for i, g in rank["mlp"]["grads"].items()}
    for i, want in enumerate(run["mlp_sequential"]):
        for k in ("w1", "w2"):
            w = np.asarray(want[k])
            np.testing.assert_allclose(held[i][k], w, rtol=1e-4, atol=1e-5)
            assert not np.allclose(held[i][k], PW.WORLD * w, rtol=1e-2)


def test_msda_token_sharded_is_jax_msda_token_sharded(run):
    """Each rank's rows of the output and of d loc and d attn, and the
    value's gradient summed over the ranks, on every rank."""
    out, (dv, dloc, dattn) = run["refs"]["sp"]
    Lq = out.shape[1]
    starts = []
    for rank in run["ranks"]:
        r = rank["sp"]
        a, b = r["rows"]
        starts.append(a)
        assert b - a == Lq // PW.WORLD
        np.testing.assert_allclose(r["out"], out[:, a:b], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["dloc"], dloc[:, a:b], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r["dattn"], dattn[:, a:b], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r["dvalue"], dv, rtol=1e-4, atol=1e-5)
    assert starts == [i * Lq // PW.WORLD for i in range(PW.WORLD)]


def test_msda_token_sharded_refuses_uneven_queries(run):
    assert [r["sp"]["refused"] for r in run["ranks"]] == [
        f"338 queries do not split over {PW.WORLD} ranks"] * PW.WORLD
