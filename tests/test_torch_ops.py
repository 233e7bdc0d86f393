"""The port's ops against the JAX package, on the CPU (plain versions).

MSDA: `vitadapter_torch.ops.msda.ms_deform_attn_plain` against
`vitadapter.ops.msda.ms_deform_attn_core` and against the Pallas kernel
`msda_pallas.ms_deform_attn_pallas` in TPU interpret mode, fp32, tol 1e-5.
The band-matmul Pallas forward (`msda_pallas._forward_ml_bandmm`, off by
default in JAX) against the same plain version, fp32, tol 1e-5.
Attention: `attention_plain` against `fused_mha(interpret=True)` and
`layers.attention.mha`, fp32, tol 1e-5; the forward kernel's plain
function's log-sum-exp against `torch.logsumexp`, 1e-6. Plus resizing,
positional encoding and preprocessing, and the wrappers' CPU dispatch and
input checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitadapter.data import preprocess as jpre
from vitadapter.layers.attention import mha as jax_mha
from vitadapter.layers.positional import sine_positional_encoding as jsine
from vitadapter.ops.attention_pallas import fused_mha
from vitadapter.ops.msda import ms_deform_attn_core
from vitadapter.utils import resize as jresize
from vitadapter_torch.data import preprocess as tpre
from vitadapter_torch.layers.positional import sine_positional_encoding
from vitadapter_torch.ops import attention as tattn
from vitadapter_torch.ops import cuda_ext
from vitadapter_torch.ops import msda as tmsda
from vitadapter_torch.utils import resize as tresize


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores: torch's intra-op threads on
    top of them make the small eager ops here many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _msda_inputs(case, seed, shapes=((13, 17), (7, 9)), B=2, Lq=11, M=3,
                 D=8, P=4):
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
        # pixel coordinates loc * size - 0.5 on integers, including the
        # borders -1, 0, size - 1 and size
        k = rng.randint(-1, 1 + size.astype(np.int64).max(), loc.shape)
        k = np.minimum(k, size.astype(np.int64))
        loc = (k + 0.5) / size
    attn = rng.rand(B, Lq, M, L, P).astype(np.float32)
    return value, loc.astype(np.float32), attn


@pytest.mark.parametrize("case", ["multi_level", "out_of_range", "integer"])
def test_msda_plain_matches_jax_core(case):
    shapes = ((13, 17), (7, 9))
    value, loc, attn = _msda_inputs(case, 0, shapes)
    ref = ms_deform_attn_core(jnp.asarray(value), shapes, jnp.asarray(loc),
                              jnp.asarray(attn))
    got = tmsda.ms_deform_attn_plain(torch.from_numpy(value), shapes,
                                     torch.from_numpy(loc),
                                     torch.from_numpy(attn))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_msda_plain_matches_pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu

    from vitadapter.ops import msda_pallas

    shapes = ((13, 17), (7, 9))
    value, loc, attn = _msda_inputs("out_of_range", 1, shapes, D=32)
    with pltpu.force_tpu_interpret_mode():
        ref = msda_pallas.ms_deform_attn_pallas(
            jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn))
    got = tmsda.ms_deform_attn_plain(torch.from_numpy(value), shapes,
                                     torch.from_numpy(loc),
                                     torch.from_numpy(attn))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_msda_plain_matches_bandmm_forward_interpret():
    """`_fwd_ml_bandmm_kernel` computes `_fwd_ml_kernel`'s function; on the
    card `msda_fwd.cu` covers it. The 32x32 level at D = 32 takes the band
    path, the 7x9 level the flat one."""
    from jax.experimental.pallas import tpu as pltpu

    from vitadapter.ops import msda_pallas

    shapes = ((32, 32), (7, 9))
    D = 32
    assert [msda_pallas._bandmm_mode(H, W, D, msda_pallas.ML_CHUNK)
            for H, W in shapes] == [True, False]
    value, loc, attn = _msda_inputs("out_of_range", 9, shapes, Lq=40, M=2,
                                    D=D)
    with pltpu.force_tpu_interpret_mode():
        ref = msda_pallas._forward_ml_bandmm(
            jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn))
    got = tmsda.ms_deform_attn_plain(torch.from_numpy(value), shapes,
                                     torch.from_numpy(loc),
                                     torch.from_numpy(attn))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def _qkv(seed, shape=(2, 3, 128, 64)):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def test_attention_plain_matches_fused_mha_interpret():
    q, k, v = _qkv(0)
    scale = 64 ** -0.5
    ref = fused_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                    True)
    got = tattn.attention_plain(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n", [128, 100])
def test_attention_plain_matches_mha(n):
    q, k, v = _qkv(1, (2, 3, n, 64))
    ref = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125)
    got = tattn.attention_plain(*map(torch.from_numpy, (q, k, v)), 0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n", [128, 77])
def test_attention_plain_lse_is_the_scores_logsumexp(n):
    """The forward kernel's plain function returns the fp32 row
    log-sum-exp of the scaled scores beside the output, ragged N
    included."""
    q, k, v = map(torch.from_numpy, _qkv(8, (2, 3, n, 64)))
    out, lse, out32 = tattn.attention_plain_lse(q, k, v, 0.125)
    assert lse.dtype == torch.float32 and lse.shape == (2, 3, n)
    assert out32 is out  # fp32 inputs: the output is the fp32 output
    s = torch.matmul(q, k.transpose(-1, -2)) * 0.125
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6,
                               atol=1e-6)


def test_wrappers_take_plain_versions_on_cpu():
    """CPU tensors take the plain version and launch nothing."""
    before = dict(cuda_ext.launches)
    q, k, v = map(torch.from_numpy, _qkv(2, (1, 2, 40, 32)))
    np.testing.assert_array_equal(tattn.fused_attention(q, k, v).numpy(),
                                  tattn.attention_plain(q, k, v).numpy())
    shapes = ((5, 4),)
    value, loc, attn = map(torch.from_numpy,
                           _msda_inputs("multi_level", 3, shapes))
    np.testing.assert_array_equal(
        tmsda.ms_deform_attn(value, shapes, loc, attn).numpy(),
        tmsda.ms_deform_attn_plain(value, shapes, loc, attn).numpy())
    assert dict(cuda_ext.launches) == before


def test_kernel_input_checks_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.check_kernel_inputs(q, q, q)
    shapes = ((4, 4),)
    loc = torch.zeros(1, 3, 2, 1, 4, 2)
    attn = torch.zeros(1, 3, 2, 1, 4)
    with pytest.raises(ValueError, match="head dim"):
        tmsda.check_kernel_inputs(torch.zeros(1, 16, 2, 96), shapes, loc,
                                  attn)
    with pytest.raises(ValueError, match="dtype"):
        tmsda.check_kernel_inputs(torch.zeros(1, 16, 2, 32,
                                              dtype=torch.float16),
                                  shapes, loc, attn)
    with pytest.raises(ValueError, match="CUDA"):
        tmsda.check_kernel_inputs(torch.zeros(1, 16, 2, 32), shapes, loc,
                                  attn)


@pytest.mark.parametrize("hw,out,method", [
    ((4, 4), (16, 16), "bilinear"), ((8, 6), (4, 3), "bilinear"),
    ((14, 14), (32, 32), "bicubic"), ((5, 7), (9, 4), "bicubic")])
def test_resize_matches_jax_and_interpolate(hw, out, method):
    x = np.random.RandomState(4).randn(2, *hw, 5).astype(np.float32)
    got = tresize.resize_2d(torch.from_numpy(x), out, method)
    ref = jresize.resize_2d(jnp.asarray(x), out, method)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    oracle = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=out, mode=method,
        align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_resize_bf16_rounds_tap_weights_like_jax():
    x = np.random.RandomState(6).randn(1, 4, 4, 8).astype(np.float32)
    got = tresize.resize_2d(torch.from_numpy(x).bfloat16(), (16, 16))
    ref = jresize.resize_2d(jnp.asarray(x, jnp.bfloat16), (16, 16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_sine_positional_encoding_matches_jax():
    got = sine_positional_encoding((5, 7), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsine((5, 7), 16)),
                               rtol=1e-5, atol=1e-5)


def test_preprocess_matches_jax():
    img = np.random.RandomState(7).randint(0, 256, (2, 30, 45, 3),
                                           dtype=np.uint8)
    got = tpre.normalize(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jpre.normalize(jnp.asarray(img))),
                               rtol=1e-6, atol=1e-6)
    padded, hw = tpre.pad_to_multiple(got)
    ref, ref_hw = jpre.pad_to_multiple(jnp.asarray(got.numpy()))
    assert hw == ref_hw == (30, 45)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(ref))
