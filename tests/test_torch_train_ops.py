"""The port's training ops against the JAX package, on the CPU (plain
versions), fp32 unless a test says otherwise.

Gradients: `ms_deform_attn_plain_backward`, `attention_plain_backward` and
`point_sample_plain_backward` against `jax.vjp` of the Pallas kernels in
TPU interpret mode and of the XLA versions, for the same random output
gradient. Then point selection, DropPath and BatchNorm in training mode, the
head's train forward, the assignment costs and the auction, the loss, and
the optimizer.
Finally the autograd wrappers that carry the kernels' gradients on the card,
exercised here with their kernels swapped for the plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vitadapter.heads import mask2former_loss as jloss
from vitadapter.heads.mask2former import Mask2FormerHead as JHead
from vitadapter.layers.attention import mha as jax_mha
from vitadapter.layers.drop import DropPath as JDropPath
from vitadapter.layers.norm import BatchNorm as JBatchNorm
from vitadapter.ops import matching as jmatching
from vitadapter.ops import msda_pallas
from vitadapter.ops.auction_pallas import auction_assign_pallas
from vitadapter.ops import point_sample as jps
from vitadapter.ops.attention_pallas import fused_mha
from vitadapter.ops.msda import ms_deform_attn_core
from vitadapter.ops.point_sample_pallas import (point_sample_pallas,
                                                sort_points_by_y as jsort)
from vitadapter.train import optim as joptim
from vitadapter_torch.heads import mask2former_loss as tloss
from vitadapter_torch.heads.mask2former import Mask2FormerHead
from vitadapter_torch.layers.drop import DropPath, drop_path
from vitadapter_torch.layers.norm import BatchNorm
from vitadapter_torch.ops import attention as tattn
from vitadapter_torch.ops import cuda_ext
from vitadapter_torch.ops import matching as tmatching
from vitadapter_torch.ops import msda as tmsda
from vitadapter_torch.ops import point_sample as tps
from vitadapter_torch.train import optim as toptim
from vitadapter_torch.utils.weights import load_flax, state_dict_from_flax

from torch_port_util import (TINY_HEAD, ReplaySampler, jax_loss_draws,
                             randomize_flax, to_np)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make the small eager ops here many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


# --- MSDA gradients ---------------------------------------------------------

def _msda_inputs(case, seed, shapes, B=2, Lq=11, M=3, D=32, P=4):
    """The three input cases of `test_torch_ops._msda_inputs`: multi-level
    in-range points, points far off the map, and points on integer pixel
    coordinates (borders included)."""
    rng = np.random.RandomState(seed)
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    value = rng.randn(B, S, M, D).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (B, Lq, M, L, P, 2))
    size = np.array([[w, h] for h, w in shapes], np.float64)[
        None, None, None, :, None, :]
    if case == "out_of_range":
        far = rng.rand(B, Lq, M, L, P, 1) < 0.5
        loc = np.where(far, rng.uniform(-3.0, 4.0, loc.shape), loc)
    elif case == "integer":
        k = rng.randint(-1, 1 + size.astype(np.int64).max(), loc.shape)
        k = np.minimum(k, size.astype(np.int64))
        loc = (k + 0.5) / size
    attn = rng.rand(B, Lq, M, L, P).astype(np.float32)
    g = rng.randn(B, Lq, M * D).astype(np.float32)
    return value, loc.astype(np.float32), attn, g


MSDA_SHAPES = ((13, 17), (7, 9))
# d loc carries the factors attn * W and attn * H, so its entries are ~W
# times larger than the others and take 1e-4
MSDA_TOLS = (TOL, dict(rtol=1e-4, atol=1e-4), TOL)


def _msda_port_grads(value, loc, attn, g):
    return tmsda.ms_deform_attn_plain_backward(
        _t(value), MSDA_SHAPES, _t(loc), _t(attn), _t(g))


@pytest.mark.parametrize("case", ["multi_level", "out_of_range", "integer"])
def test_msda_plain_backward_matches_pallas_interpret(case):
    value, loc, attn, g = _msda_inputs(case, 20, MSDA_SHAPES)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda v, l, a: msda_pallas.ms_deform_attn_pallas(
                v, MSDA_SHAPES, l, a), *map(jnp.asarray, (value, loc, attn)))
        want = vjp(jnp.asarray(g))
    got = _msda_port_grads(value, loc, attn, g)
    for name, gt, w, tol in zip(("value", "loc", "attn"), got, want,
                                MSDA_TOLS):
        np.testing.assert_allclose(to_np(gt), np.asarray(w), **tol,
                                   err_msg=f"d {name}")


@pytest.mark.parametrize("case", ["multi_level", "out_of_range", "integer"])
def test_msda_plain_backward_matches_jax_core(case):
    value, loc, attn, g = _msda_inputs(case, 21, MSDA_SHAPES, D=8)
    _, vjp = jax.vjp(lambda v, l, a: ms_deform_attn_core(v, MSDA_SHAPES, l, a),
                     *map(jnp.asarray, (value, loc, attn)))
    want = vjp(jnp.asarray(g))
    got = _msda_port_grads(value, loc, attn, g)
    for name, gt, w, tol in zip(("value", "loc", "attn"), got, want,
                                MSDA_TOLS):
        np.testing.assert_allclose(to_np(gt), np.asarray(w), **tol,
                                   err_msg=f"d {name}")


def test_msda_plain_backward_bf16_value_sums_in_fp32():
    """A bf16 value gets a bf16 d value: the fp32 sum rounded once."""
    value, loc, attn, g = _msda_inputs("multi_level", 22, MSDA_SHAPES, D=8)
    vb = _t(value).bfloat16()
    dv, dloc, dattn = tmsda.ms_deform_attn_plain_backward(
        vb, MSDA_SHAPES, _t(loc), _t(attn), _t(g).bfloat16())
    ref = tmsda.ms_deform_attn_plain_backward(
        vb.float(), MSDA_SHAPES, _t(loc), _t(attn), _t(g).bfloat16().float())
    assert dv.dtype == torch.bfloat16 and dloc.dtype == torch.float32
    torch.testing.assert_close(dv, ref[0].bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(dloc, ref[1], rtol=0, atol=0)


# --- attention gradients ----------------------------------------------------

def _qkvg(seed, shape=(1, 2, 128, 64)):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("ref", ["fused_mha_interpret", "mha"])
def test_attention_plain_backward_matches_jax(ref):
    q, k, v, g = _qkvg(23)
    scale = 64 ** -0.5
    if ref == "mha":
        fn = lambda a, b, c: jax_mha(a, b, c, scale)  # noqa: E731
    else:
        fn = lambda a, b, c: fused_mha(a, b, c, scale, True)  # noqa: E731
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = tattn.attention_plain_backward(*map(_t, (q, k, v, g)), scale)
    for name, gt, w in zip("qkv", got, want):
        np.testing.assert_allclose(to_np(gt), np.asarray(w), **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("n", [128, 77])
def test_attention_plain_backward_lse_matches_autograd(n):
    """The backward kernel's function, from the saved output and
    log-sum-exp, against autograd of the plain forward (ragged N too)."""
    q, k, v, g = map(_t, _qkvg(24, (1, 2, n, 32)))
    scale = 32 ** -0.5
    _, lse, out32 = tattn.attention_plain_lse(q, k, v, scale)
    got = tattn.attention_plain_backward_lse(q, k, v, out32, lse, g, scale)
    want = tattn.attention_plain_backward(q, k, v, g, scale)
    for name, gt, w in zip("qkv", got, want):
        torch.testing.assert_close(gt, w, **TOL, msg=f"d{name}")


# --- point sampling ---------------------------------------------------------

def _ps_inputs(seed, N=3, H=24, W=40, P=300, dtype=np.float32):
    """Masks, points (a fifth of them off the map) and an output gradient."""
    rng = np.random.RandomState(seed)
    masks = rng.randn(N, H, W).astype(np.float32)
    pts = rng.rand(N, P, 2) * 1.2 - 0.1
    far = rng.rand(N, P, 1) < 0.05
    pts = np.where(far, rng.uniform(-2.0, 3.0, pts.shape), pts)
    g = rng.randn(N, P).astype(np.float32)
    if dtype != np.float32:
        masks = np.asarray(jnp.asarray(masks, dtype))
    return masks, pts.astype(np.float32), g


def _port_sample_and_grad(masks, pts, g):
    m = _t(masks).requires_grad_()
    p = _t(pts).requires_grad_()
    out = tps.point_sample(m, p)
    out.backward(_t(g))
    return out, m.grad, p.grad


@pytest.mark.parametrize("P", [300, 2100])
def test_point_sample_forward_and_grad_match_pallas_interpret(P):
    """Pallas tiles 2048 points: 2100 is not a multiple of its tile."""
    masks, pts, g = _ps_inputs(24, P=P)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(point_sample_pallas, jnp.asarray(masks),
                           jnp.asarray(pts))
        dm, dpts = vjp(jnp.asarray(g))
    got, gm, gp = _port_sample_and_grad(masks, pts, g)
    np.testing.assert_allclose(to_np(got), np.asarray(out), **TOL)
    np.testing.assert_allclose(to_np(gm), np.asarray(dm), **TOL)
    # the Pallas contract: no gradient for the points
    assert float(jnp.abs(dpts).max()) == 0.0
    assert gp is None


def test_point_sample_forward_and_grad_match_xla():
    masks, pts, g = _ps_inputs(25)
    out, vjp = jax.vjp(lambda m: jps.point_sample(m, jnp.asarray(pts)),
                       jnp.asarray(masks))
    (dm,) = vjp(jnp.asarray(g))
    got, gm, _ = _port_sample_and_grad(masks, pts, g)
    np.testing.assert_allclose(to_np(got), np.asarray(out), **TOL)
    np.testing.assert_allclose(to_np(gm), np.asarray(dm), **TOL)
    np.testing.assert_allclose(
        to_np(tps.point_sample_plain_backward(_t(masks), _t(pts), _t(g))),
        np.asarray(dm), **TOL)


def test_point_sample_bf16_masks():
    """bf16 masks: the port's fp32 weights and sums equal the XLA path's
    (which promotes the mask values to fp32) to fp32 rounding; the Pallas
    kernel rounds its weights to bf16 first, so it agrees to ~2^-8 of the
    values. d mask is bf16."""
    masks, pts, g = _ps_inputs(26, dtype=jnp.bfloat16)
    mj = jnp.asarray(masks, jnp.bfloat16)
    out, vjp = jax.vjp(lambda m: jps.point_sample(m, jnp.asarray(pts)), mj)
    (dm,) = vjp(jnp.asarray(g))
    mt = torch.from_numpy(np.asarray(masks, np.float32)).bfloat16()
    mt.requires_grad_()
    got = tps.point_sample(mt, _t(pts))
    got.backward(_t(g))
    assert got.dtype == torch.float32 and mt.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(got), np.asarray(out), **TOL)
    np.testing.assert_allclose(to_np(mt.grad), np.asarray(dm, np.float32),
                               rtol=1e-2, atol=1e-2)
    with pltpu.force_tpu_interpret_mode():
        pal = point_sample_pallas(mj, jnp.asarray(pts))
    scale = float(np.abs(np.asarray(out)).max())
    np.testing.assert_allclose(to_np(got), np.asarray(pal), rtol=0,
                               atol=2e-2 * scale)


def test_sort_points_by_y_matches_jax():
    pts = np.random.RandomState(27).rand(2, 3, 50, 2).astype(np.float32)
    np.testing.assert_array_equal(to_np(tps.sort_points_by_y(_t(pts))),
                                  np.asarray(jsort(jnp.asarray(pts))))


def test_get_uncertain_point_coords_matches_jax_with_replayed_draws():
    """JAX's CPU path takes the exact top-k; the port replays its draws."""
    logits = np.random.RandomState(28).randn(6, 16, 16).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    want = jps.get_uncertain_point_coords(rng, jnp.asarray(logits), 40)
    r1, r2 = jax.random.split(rng)
    sampler = ReplaySampler([jax.random.uniform(r1, (6, 120, 2)),
                             jax.random.uniform(r2, (6, 10, 2))])
    got = tps.get_uncertain_point_coords(sampler, _t(logits), 40)
    assert sampler.done()
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


def test_uniform_sampler_draws_from_its_generator():
    a = tps.uniform_sampler(torch.Generator().manual_seed(5))((3, 4, 2))
    b = tps.uniform_sampler(torch.Generator().manual_seed(5))((3, 4, 2))
    assert a.dtype == torch.float32 and tuple(a.shape) == (3, 4, 2)
    assert bool((a >= 0).all() and (a < 1).all())
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# --- DropPath and BatchNorm in training mode --------------------------------

def test_drop_path_matches_jax_with_the_same_keep_mask():
    x = np.random.RandomState(29).randn(8, 5, 6).astype(np.float32)
    want = JDropPath(0.4).apply({}, x, deterministic=False,
                                rngs={"dropout": jax.random.PRNGKey(1)})
    want = np.asarray(want)
    keep = np.abs(want).reshape(8, -1).max(-1) > 0   # JAX's keep mask
    assert 0 < keep.sum() < 8
    got = drop_path(_t(x), _t(keep), 0.6)
    np.testing.assert_allclose(to_np(got), want, **TOL)


def test_drop_path_module_draws_per_sample_from_its_generator():
    dp = DropPath(0.5).train()
    x = torch.ones(64, 3, 2)
    y = dp(x, torch.Generator().manual_seed(0))
    per_sample = y.reshape(64, -1)
    assert set(per_sample.unique().tolist()) <= {0.0, 2.0}
    assert bool((per_sample == per_sample[:, :1]).all())
    torch.testing.assert_close(
        y, dp(x, torch.Generator().manual_seed(0)), rtol=0, atol=0)
    assert dp.eval()(x, None) is x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_jax_mutable_batch_stats(dtype):
    rng = np.random.RandomState(30)
    x = (1.5 + 2.0 * rng.randn(2, 5, 7, 6)).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(6)).astype(np.float32)
    bias = (0.1 * rng.randn(6)).astype(np.float32)
    mean = (0.3 * rng.randn(6)).astype(np.float32)
    var = (0.5 + rng.rand(6)).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    want, upd = JBatchNorm().apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}},
        xj, use_running_average=False, mutable=["batch_stats"])
    bn = BatchNorm(6).train()
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
        bn.running_mean.copy_(_t(mean))
        bn.running_var.copy_(_t(var))
        xt = torch.from_numpy(np.asarray(xj, np.float32)).to(
            getattr(torch, dtype))
        got = bn(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == xt.dtype
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                               **tol)
    np.testing.assert_allclose(to_np(bn.running_mean),
                               np.asarray(upd["batch_stats"]["mean"]), **TOL)
    np.testing.assert_allclose(to_np(bn.running_var),
                               np.asarray(upd["batch_stats"]["var"]), **TOL)


# --- the head's train forward -----------------------------------------------

def test_mask2former_head_train_forward_matches_jax():
    """All 10 (cls, mask) outputs of the train forward, whose attention
    masks come from each layer's full-resolution mask logits resized to the
    next memory's scale; the resized logits nearest 0 must clear fp32
    cross-implementation noise (a flip there is not a port error)."""
    rng = np.random.RandomState(31)
    feats = [rng.randn(2, r, r, 48).astype(np.float32) for r in (16, 8, 4, 2)]
    jm = JHead(**TINY_HEAD)
    variables = jax.jit(lambda key: jm.init(key, feats, train=True))(
        jax.random.PRNGKey(0))
    params = randomize_flax(jax.device_get(variables["params"]), 32)
    jcls, jmask = jax.jit(lambda p, f: jm.apply({"params": p}, f,
                                                train=True))(params, feats)
    tm = Mask2FormerHead([48] * 4, **TINY_HEAD)
    load_flax(tm, params)
    tm.train()
    margins = []
    attn_mask = tm._attn_mask

    def spy(am):
        margins.append(float(am.abs().min()))
        return attn_mask(am)

    tm._attn_mask = spy
    with torch.no_grad():
        tcls, tmask = tm([_t(f) for f in feats])
    assert len(tcls) == len(tmask) == len(jcls) == 10
    for i in range(10):
        assert tuple(tmask[i].shape) == (2, TINY_HEAD["num_queries"], 16, 16)
        np.testing.assert_allclose(to_np(tcls[i]), np.asarray(jcls[i]),
                                   rtol=2e-4, atol=2e-4,
                                   err_msg=f"cls layer {i}")
        np.testing.assert_allclose(to_np(tmask[i]), np.asarray(jmask[i]),
                                   rtol=2e-4, atol=3e-4,
                                   err_msg=f"mask layer {i}")
    assert min(margins[:-1]) > 1e-4, margins


# --- matching and the loss --------------------------------------------------

def _preds(seed, L=3, B=2, Q=5, K=7, h=8, w=8, H=32, W=32):
    rng = np.random.RandomState(seed)
    cls = [(2 * rng.randn(B, Q, K + 1)).astype(np.float32) for _ in range(L)]
    masks = [(3 * rng.randn(B, Q, h, w)).astype(np.float32) for _ in range(L)]
    label = rng.randint(0, K, (B, H, W)).astype(np.int32)
    label[0, :4] = 255                                 # ignored pixels
    label[1][label[1] == 3] = 2                        # an absent class
    return cls, masks, label


def test_assignment_costs_match_jax():
    rng = np.random.RandomState(33)
    cls = rng.randn(5, 8).astype(np.float32)
    labels = np.array([3, 0, 6], np.int32)
    pred = (2 * rng.randn(5, 40)).astype(np.float32)
    gt = (rng.rand(3, 40) < 0.4).astype(np.float32)
    for fn, args in ((("classification_cost"), (cls, labels, 2.0)),
                     (("bce_mask_cost"), (pred, gt, 5.0)),
                     (("dice_cost"), (pred, gt, 5.0))):
        want = getattr(jmatching, fn)(*map(jnp.asarray, args[:2]), args[2])
        got = getattr(tmatching, fn)(*map(_t, args[:2]), args[2])
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL,
                                   err_msg=fn)


def _auction_case(case):
    """(cost (B, Q, G), n_valid (B,)): random costs with 0 to G valid gts;
    integer costs (ties among queries and among bids); one query; costs of
    the loss's scale (cls + mask + dice weights) with every gt valid;
    contested costs, where every gt prefers the same few queries (as in an
    untrained model) and the bidding runs hundreds of rounds."""
    rng = np.random.RandomState(34)
    if case == "random":
        cost = 3 * rng.randn(6, 20, 12)
        n_valid = np.array([12, 7, 1, 0, 12, 5])
    elif case == "ties":
        cost = rng.randint(0, 4, (4, 16, 9))
        n_valid = np.array([9, 9, 3, 6])
    elif case == "one_query":
        cost = rng.randn(3, 1, 4)
        n_valid = np.array([1, 1, 0])
    elif case == "loss":
        cost = (-2 * rng.rand(4, 50, 15) + 5 * rng.rand(4, 50, 15)
                + 5 * rng.rand(4, 50, 15))
        n_valid = np.full(4, 15)
    else:
        cost = 3 * rng.rand(3, 50, 1) + 0.05 * rng.rand(3, 50, 20)
        n_valid = np.array([20, 20, 13])
    return cost.astype(np.float32), n_valid.astype(np.int32)


@pytest.mark.parametrize("case", ["random", "ties", "one_query", "loss",
                                  "contested"])
def test_auction_plain_matches_pallas_interpret_and_scipy_cost(case):
    """The same matches as `auction_pallas` in interpret mode (the same fp32
    additions in the same order, the same tie rules), and a total matched
    cost within n_valid * eps of scipy's optimum (the auction's bound), plus
    fp32 rounding."""
    from scipy.optimize import linear_sum_assignment

    cost, n_valid = _auction_case(case)
    want = auction_assign_pallas(jnp.asarray(cost), jnp.asarray(n_valid),
                                 interpret=True)
    got, iters = tmatching.auction_assign_plain(_t(cost), _t(n_valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int64 and (iters >= (_t(n_valid) > 0)).all()
    if case == "contested":
        assert int(iters.min()) >= 100
    for b, n in enumerate(n_valid):
        own = got[b].numpy()
        assert sorted(own[own >= 0]) == list(range(n))
        if n == 0:
            continue
        rows, cols = linear_sum_assignment(cost[b, :, :n].astype(np.float64))
        opt = float(cost[b][rows, cols].sum())
        total = float(sum(cost[b, q, g] for q, g in enumerate(own) if g >= 0))
        eps = max(float(np.abs(cost[b, :, :n]).max()), 1e-6) / 2000
        assert opt - 1e-5 <= total <= opt + n * eps + 1e-5 * abs(opt)


def test_hungarian_assign_takes_the_kernel_off_the_cpu(monkeypatch):
    """CPU tensors take the plain auction and launch nothing; a tensor off
    the CPU takes the kernel (here on the meta device, the input checks and
    the launch stubbed), and an empty gt side launches nothing."""
    cost, n_valid = _auction_case("random")
    before = dict(cuda_ext.launches)
    got = tmatching.hungarian_assign(_t(cost), _t(n_valid))
    np.testing.assert_array_equal(
        got.numpy(), tmatching.auction_assign_plain(_t(cost),
                                                    _t(n_valid))[0].numpy())
    assert dict(cuda_ext.launches) == before
    seen = []

    def kernel(c, n):
        seen.append(tuple(c.shape))
        return torch.zeros(c.shape[:2], dtype=torch.int32,
                           device=c.device), None

    monkeypatch.setattr(tmatching, "check_kernel_inputs", lambda *a: None)
    monkeypatch.setattr(tmatching, "_kernel_auction", kernel)
    meta = dict(device="meta")
    out = tmatching.hungarian_assign(torch.zeros(2, 5, 3, **meta),
                                     torch.zeros(2, **meta))
    assert seen == [(2, 5, 3)] and out.dtype == torch.int64
    out = tmatching.hungarian_assign(torch.zeros(2, 5, 0, **meta),
                                     torch.zeros(2, **meta))
    assert seen == [(2, 5, 3)] and out.shape == (2, 5)


def test_auction_kernel_input_checks():
    cost, nv = torch.zeros(2, 5, 3), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tmatching.check_kernel_inputs(cost, nv)
    with pytest.raises(ValueError, match="fp32"):
        tmatching.check_kernel_inputs(cost.double(), nv)
    with pytest.raises(ValueError, match="n_valid"):
        tmatching.check_kernel_inputs(cost, nv[:1])


def test_auction_shared_memory_formula():
    """`auction_smem_bytes`, the bytes `check_kernel_inputs` holds a cost
    matrix to, as `csrc/auction.cu` lays them out: 8 bytes of bid key and
    4 each of price and owner a query, the (G, Q) fp32 benefit matrix,
    two free lists and the bid slots of G ints, and 76 static bytes. At
    Q = 200, a block's 227 KiB hold G up to 282."""
    assert tmatching.auction_smem_bytes(200, 60) == 51996
    assert tmatching.auction_smem_bytes(1, 1) == 8 + 4 * (1 + 2 + 3) + 76
    fits = [G for G in range(1, 1000)
            if tmatching.auction_smem_bytes(200, G) <= tmatching.SMEM_OPTIN]
    assert max(fits) == 282 and len(fits) == 282


def test_present_classes_and_gt_points_match_jax():
    _, _, label = _preds(35)
    want_l, want_v = jloss.present_classes(jnp.asarray(label), 7, 6)
    got_l, got_v = tloss.present_classes(_t(label), 7, 6)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    pts = np.random.RandomState(36).rand(2, 50, 2).astype(np.float32)
    want = jloss.sample_gt_points(jnp.asarray(label), jnp.asarray(pts),
                                  want_l)
    got = tloss.sample_gt_points(_t(label), _t(pts), got_l)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("B", [1, 2])
def test_sample_gt_points_hands_the_kernel_contiguous_points(monkeypatch, B):
    """At batch 1 the expanded points stayed a zero-stride view, which the
    point-sampling kernel's input checks refuse (a batch-1 train step failed
    on the card); the wrapper must get contiguous points at any batch. It
    now gets each image's point set once, shared by the image's G maps."""
    seen = []

    def spy(masks, points):
        seen.append((points.is_contiguous(), tuple(points.shape),
                     tps.masks_per_set(masks, points)))
        return tps.point_sample_plain(masks, points)

    monkeypatch.setattr(tloss, "point_sample", spy)
    label = np.random.RandomState(37).randint(0, 4, (B, 9, 11))
    got_l, _ = tloss.present_classes(_t(label), 4, 3)
    pts = np.random.RandomState(38).rand(B, 20, 2).astype(np.float32)
    out = tloss.sample_gt_points(_t(label), _t(pts), got_l)
    assert tuple(out.shape) == (B, 3, 20) and seen == [(True, (B, 20, 2), 3)]


@pytest.fixture
def jax_pallas_assignment(monkeypatch):
    """Pin the JAX loss to the Pallas auction (interpret mode on the CPU),
    the kernel it runs on one TPU: under the tests' 8 virtual CPU devices its
    `auto` would take the XLA auction."""
    monkeypatch.setattr(
        jloss, "hungarian_assign",
        lambda cost, n_valid: jmatching.hungarian_assign(
            cost, n_valid, impl="auction_pallas"))


def test_mask2former_loss_matches_jax(jax_pallas_assignment):
    """Total, logs and the gradients of the predictions, to 1e-4, with the
    port's sampler replaying JAX's draws; the assignments are equal."""
    cls, masks, label = _preds(37)
    L, (B, Q) = len(cls), cls[0].shape[:2]
    n_pts, rng = 20, jax.random.PRNGKey(7)

    def jfn(c, m):
        return jloss.mask2former_loss(rng, c, m, jnp.asarray(label), 7,
                                      max_instances=6, num_points=n_pts)

    (jtotal, jlogs), (jdc, jdm) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(cls, masks)
    sampler = ReplaySampler(jax_loss_draws(rng, L, B, Q, n_pts))
    tc = [_t(c).requires_grad_() for c in cls]
    tm = [_t(m).requires_grad_() for m in masks]
    total, logs = tloss.mask2former_loss(sampler, tc, tm, _t(label), 7,
                                         max_instances=6, num_points=n_pts)
    assert sampler.done()
    total.backward()
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-4,
                               atol=1e-4)
    assert set(logs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for i in range(L):
        np.testing.assert_allclose(to_np(tc[i].grad), np.asarray(jdc[i]),
                                   rtol=1e-4, atol=1e-4)
        # mask logits are sampled in bf16 (the JAX dtypes), so their
        # gradient is bf16: JAX scatter-adds it in bf16, the port sums in
        # fp32 and rounds once, so they differ by a few bf16 ulps (2^-8)
        dm = np.asarray(jdm[i])
        np.testing.assert_allclose(to_np(tm[i].grad), dm, rtol=0,
                                   atol=2e-2 * np.abs(dm).max())


def test_assign_all_layers_matches_jax(jax_pallas_assignment):
    cls, masks, label = _preds(38)
    L, (B, Q) = len(cls), cls[0].shape[:2]
    gl, gv = jloss.present_classes(jnp.asarray(label), 7, 6)
    rng = jax.random.PRNGKey(9)
    want = jloss._assign_all_layers(rng, jnp.stack(cls), jnp.stack(masks),
                                    jnp.asarray(label), gl, gv, 16, 2.0, 5.0,
                                    5.0)
    sampler = ReplaySampler([jax.random.uniform(rng, (L, B, 16, 2))])
    tl, tv = tloss.present_classes(_t(label), 7, 6)
    got = tloss._assign_all_layers(sampler, torch.stack([_t(c) for c in cls]),
                                   torch.stack([_t(m) for m in masks]),
                                   _t(label), tl, tv, 16, 2.0, 5.0, 5.0)
    # the same auction on costs equal to fp32 rounding: equal matches
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n_gt = np.asarray(gv).sum(-1)
    assert int((got >= 0).sum()) == L * int(np.minimum(n_gt, Q).sum())


# --- optimizer --------------------------------------------------------------

def _port_names_tree(per_leaf, params, stats):
    """A tree of per-leaf scalars (a JAX lr-scale or decay-mask tree) under
    the port's parameter names, each broadcast to its parameter's shape
    through the weight map."""
    tree = jax.tree_util.tree_map(
        lambda s, v: np.full(np.shape(v), float(s), np.float32), per_leaf,
        params)
    return state_dict_from_flax(tree, stats)


@pytest.fixture(scope="module")
def tiny_segmentor():
    from vitadapter.models.mask2former_segmentor import \
        EncoderDecoderMask2Former as JSeg
    from vitadapter.models.vit_adapter import ViTAdapter as JViTAdapter
    from vitadapter_torch.models.mask2former_segmentor import \
        EncoderDecoderMask2Former
    from vitadapter_torch.models.vit_adapter import ViTAdapter

    from torch_port_util import TINY_BACKBONE

    jm = JSeg(backbone=JViTAdapter(**TINY_BACKBONE),
              decode_head=JHead(**TINY_HEAD))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            np.zeros((1, 64, 64, 3), np.float32))
    params = randomize_flax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]), 40)
    stats = randomize_flax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["batch_stats"]), 41,
        stats=True)

    def port():
        model = EncoderDecoderMask2Former(
            ViTAdapter(**TINY_BACKBONE),
            Mask2FormerHead([TINY_BACKBONE["embed_dim"]] * 4, **TINY_HEAD))
        return load_flax(model, params, stats)

    return jm, params, stats, port


def test_layer_decay_scales_and_decay_mask_match_jax(tiny_segmentor):
    _, params, stats, port = tiny_segmentor
    named = list(port().named_parameters())
    depth = 4
    want_scale = _port_names_tree(
        joptim.layer_decay_scales(params, depth, 0.9), params, stats)
    want_mask = _port_names_tree(joptim.weight_decay_mask(params), params,
                                 stats)
    got_scale = toptim.layer_decay_scales(named, depth, 0.9)
    got_mask = toptim.weight_decay_mask(named)
    assert set(got_scale) == {n for n, _ in named} <= set(want_scale)
    assert len(set(got_scale.values())) == depth + 2
    for n in got_scale:
        np.testing.assert_allclose(want_scale[n], got_scale[n], rtol=1e-6,
                                   err_msg=n)
        np.testing.assert_array_equal(want_mask[n], float(got_mask[n]),
                                      err_msg=n)


@pytest.mark.parametrize("policy", ["poly", "cosine"])
def test_schedules_match_jax(policy):
    jfn = (joptim.poly_schedule_with_warmup if policy == "poly"
           else joptim.cosine_schedule_with_warmup)
    tfn = (toptim.poly_schedule_with_warmup if policy == "poly"
           else toptim.cosine_schedule_with_warmup)
    js, ts = jfn(1e-3, 100, 10), tfn(1e-3, 100, 10)
    # JAX evaluates the schedule in fp32, the port in Python floats
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=3e-5,
                                   atol=1e-12, err_msg=str(step))


def test_optimizer_three_steps_match_optax(tiny_segmentor):
    """Clip (triggered on steps 1 and 3, not 2), warmup, weight decay and a
    layer decay rate of 0.9, on carried parameters and fixed gradients."""
    import optax

    _, params, stats, port = tiny_segmentor
    model = port()
    kw = dict(base_lr=1e-3, weight_decay=0.05, depth=4, layer_decay_rate=0.9,
              total_steps=20, warmup_steps=2, grad_clip=1.0)
    tx, _ = joptim.make_optimizer(params, **kw)
    update = jax.jit(lambda g, st, p: (lambda u, st2: (
        optax.apply_updates(p, u), st2))(*tx.update(g, st, p)))
    opt, _ = toptim.make_optimizer(model, **kw)
    jparams, jstate = params, tx.init(params)
    rng = np.random.RandomState(42)
    named = dict(model.named_parameters())
    for step, norm in enumerate((3.0, 0.5, 2.0)):
        grads = jax.tree_util.tree_map(
            lambda v: rng.randn(*np.shape(v)).astype(np.float32), params)
        gn = np.sqrt(sum(float(np.square(g).sum())
                         for g in jax.tree_util.tree_leaves(grads)))
        grads = jax.tree_util.tree_map(lambda g: g * (norm / gn), grads)
        jparams, jstate = update(grads, jstate, jparams)
        tgrads = state_dict_from_flax(grads, stats)
        for n, p in named.items():
            p.grad = tgrads[n].clone()
        got_norm = opt.step()
        np.testing.assert_allclose(float(got_norm), norm, rtol=1e-5)
    want = state_dict_from_flax(jparams, stats)
    for n, p in named.items():
        np.testing.assert_allclose(to_np(p), to_np(want[n]), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


# --- the autograd wrappers (the repair of the kernels' missing gradient) ---

def test_wrappers_go_through_autograd_functions_off_the_cpu(monkeypatch):
    """A tensor off the CPU takes the wrapper's kernel branch, and that
    branch applies the autograd function (here on the meta device, with the
    input checks stubbed)."""
    seen = []
    for mod, fn in ((tmsda, "MSDeformAttnFunction"),
                    (tattn, "FusedAttentionFunction"),
                    (tps, "PointSampleFunction")):
        monkeypatch.setattr(mod, "check_kernel_inputs", lambda *a: None)
        cls = getattr(mod, fn)
        assert issubclass(cls, torch.autograd.Function)
        monkeypatch.setattr(cls, "apply",
                            staticmethod(lambda *a, _n=fn: seen.append(_n)))
    meta = dict(device="meta")
    tmsda.ms_deform_attn(torch.zeros(1, 4, 2, 8, **meta), ((2, 2),),
                         torch.zeros(1, 3, 2, 1, 4, 2, **meta),
                         torch.zeros(1, 3, 2, 1, 4, **meta))
    q = torch.zeros(1, 2, 8, 32, **meta)
    tattn.fused_attention(q, q, q)
    tps.point_sample(torch.zeros(2, 4, 4, **meta),
                     torch.zeros(2, 5, 2, **meta))
    assert seen == ["MSDeformAttnFunction", "FusedAttentionFunction",
                    "PointSampleFunction"]


def _plain_kernels(monkeypatch):
    """Swap each kernel launch for its plain version, counting calls."""
    calls = []

    def rec(name, fn):
        def wrapped(*a):
            calls.append(name)
            return fn(*a)
        return wrapped

    monkeypatch.setattr(tmsda, "_kernel_forward", rec(
        "msda_fwd", tmsda.ms_deform_attn_plain))
    monkeypatch.setattr(tmsda, "_kernel_backward", rec(
        "msda_bwd", tmsda.ms_deform_attn_plain_backward))
    monkeypatch.setattr(tattn, "_kernel_forward", rec(
        "attention_fwd", lambda q, k, v, scale, for_backward:
        tattn.attention_plain_lse(q, k, v, scale)))
    monkeypatch.setattr(tattn, "_kernel_backward", rec(
        "attention_bwd", tattn.attention_plain_backward_lse))
    monkeypatch.setattr(tps, "_kernel_forward", rec(
        "point_sample_fwd", lambda masks, points, sorted_by_y:
        tps.point_sample_plain(masks, points)))
    monkeypatch.setattr(tps, "_kernel_backward", rec(
        "point_sample_bwd", tps.point_sample_plain_backward))
    return calls


def test_autograd_functions_carry_the_backward_kernels_gradients(
        monkeypatch):
    """Through the autograd functions every input gets the plain version's
    gradient, from one forward and one backward launch each; none is
    None."""
    calls = _plain_kernels(monkeypatch)
    value, loc, attn, g = _msda_inputs("multi_level", 43, MSDA_SHAPES, D=8)
    ins = [_t(a).requires_grad_() for a in (value, loc, attn)]
    tmsda.MSDeformAttnFunction.apply(ins[0], MSDA_SHAPES, ins[1],
                                     ins[2]).backward(_t(g))
    want = _msda_port_grads(value, loc, attn, g)
    for x, w in zip(ins, want):
        assert x.grad is not None
        torch.testing.assert_close(x.grad, w, rtol=0, atol=0)

    q, k, v, go = _qkvg(44, (1, 2, 40, 32))
    ins = [_t(a).requires_grad_() for a in (q, k, v)]
    tattn.FusedAttentionFunction.apply(*ins, 0.2, True).backward(_t(go))
    qkv = list(map(_t, (q, k, v)))
    _, lse, out32 = tattn.attention_plain_lse(*qkv, 0.2)
    want = tattn.attention_plain_backward_lse(*qkv, out32, lse, _t(go), 0.2)
    for x, w in zip(ins, want):
        assert x.grad is not None
        torch.testing.assert_close(x.grad, w, rtol=0, atol=0)

    masks, pts, g = _ps_inputs(46)
    m = _t(masks).requires_grad_()
    tps.PointSampleFunction.apply(m, _t(pts)).backward(_t(g))
    torch.testing.assert_close(m.grad, tps.point_sample_plain_backward(
        _t(masks), _t(pts), _t(g)), rtol=0, atol=0)
    assert calls == ["msda_fwd", "msda_bwd", "attention_fwd",
                     "attention_bwd", "point_sample_fwd", "point_sample_bwd"]


def test_fused_attention_output_may_be_modified_in_place(monkeypatch):
    """fp32: the fp32 output the forward saves is not the output itself, so
    an in-place change of the output leaves the gradient as it was."""
    calls = _plain_kernels(monkeypatch)
    q, k, v, go = _qkvg(47, (1, 2, 40, 32))
    ins = [_t(a).requires_grad_() for a in (q, k, v)]
    out = tattn.FusedAttentionFunction.apply(*ins, 0.2, True)
    out.add_(1.0)
    out.backward(_t(go))
    want = tattn.attention_plain_backward(*map(_t, (q, k, v)), _t(go), 0.2)
    for x, w in zip(ins, want):
        torch.testing.assert_close(x.grad, w, rtol=1e-5, atol=1e-5)
    assert calls == ["attention_fwd", "attention_bwd"]


def test_point_sample_and_cpu_wrappers_launch_nothing():
    before = dict(cuda_ext.launches)
    masks, pts, g = _ps_inputs(45)
    got, gm, _ = _port_sample_and_grad(masks, pts, g)
    torch.testing.assert_close(got, tps.point_sample_plain(_t(masks),
                                                           _t(pts)))
    torch.testing.assert_close(gm, tps.point_sample_plain_backward(
        _t(masks), _t(pts), _t(g)))
    assert dict(cuda_ext.launches) == before


def test_point_sample_kernel_input_checks():
    with pytest.raises(ValueError, match="CUDA"):
        tps.check_kernel_inputs(torch.zeros(2, 4, 4), torch.zeros(2, 3, 2))
    with pytest.raises(ValueError, match="fp32 or bf16"):
        tps.check_kernel_inputs(torch.zeros(2, 4, 4, dtype=torch.float16),
                                torch.zeros(2, 3, 2))
    with pytest.raises(ValueError, match="points"):
        tps.check_kernel_inputs(torch.zeros(2, 4, 4), torch.zeros(2, 3, 3))
