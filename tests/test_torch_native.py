"""The port's native host runtime (`vitadapter_torch/ops/native.py`, built
from `ops/host/{lap,rle}.cpp`) against the JAX package's
(`vitadapter/ops/native.py`): LAPJV, the COCO RLE codec and the popcount
mask IoU give bitwise the same results, the codec and IoU equal the
port's numpy plain versions, LAPJV's total cost is scipy's, every
`hungarian_assign` impl equals JAX's same impl, the library is built into
`vitadapter_torch/_build/` only, and a failed build raises."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from vitadapter.ops import matching as jmatching
from vitadapter.ops import native as jnative
from vitadapter_torch.data import coco as tcoco
from vitadapter_torch.det import coco_eval as tcoco_eval
from vitadapter_torch.ops import matching as tmatching
from vitadapter_torch.ops import native

ROOT = Path(__file__).resolve().parents[1]


def _lap_cases():
    """The cases of `tests/test_native_lap.py`, a contested matrix with
    non-finite costs, and Mask2Former-shaped ones (Q 20 > G)."""
    rng = np.random.RandomState(0)
    cases = []
    for _ in range(10):
        G = rng.randint(1, 12)
        cases.append((rng.randn(3, 12, G) * 5, rng.randint(0, G + 1, 3)))
    cases.append((np.random.RandomState(1).rand(1, 3, 7), np.asarray([7])))
    c = np.random.RandomState(2).randn(2, 9, 6)
    c[0, 1, 2], c[1, 4, 0], c[1, 5, 1] = np.nan, np.inf, -np.inf
    cases.append((c, np.asarray([6, 4])))
    cases.append((np.random.RandomState(3).rand(4, 20, 8).astype(np.float32),
                  np.asarray([8, 0, 3, 1])))
    return cases


def _rand_mask(rng, h, w):
    m = (rng.rand(h, w) > 0.6).astype(np.uint8)
    m[rng.randint(0, h), :] = 1  # long runs too
    return m


def _masks():
    """The masks of `tests/test_native_rle.py` and 64x96 masks of long
    runs: blocks, full rows and columns, all ones, all zeros."""
    rng = np.random.RandomState(0)
    out = [_rand_mask(rng, h, w) for h, w in
           [(13, 17), (64, 64), (1, 9), (40, 1), (23, 31), (37, 41)]]
    for k in range(4):
        m = np.zeros((64, 96), np.uint8)
        for _ in range(3 + k):
            y, x = rng.randint(0, 64), rng.randint(0, 96)
            m[y:y + rng.randint(5, 40), x:x + rng.randint(5, 60)] = 1
        m[:, rng.randint(0, 96)] = 1
        out.append(m)
    out += [np.ones((64, 96), np.uint8), np.zeros((64, 96), np.uint8)]
    return out


def test_lap_equals_jax_bitwise_and_scipy_total():
    for cost, nv in _lap_cases():
        got = native.lap_solve_batch(cost, nv)
        np.testing.assert_array_equal(got, jnative.lap_solve_batch(cost, nv))
        c = np.nan_to_num(np.asarray(cost, np.float64), nan=1e8, posinf=1e8,
                          neginf=-1e8)
        for b in range(len(cost)):
            n = int(nv[b])
            assert (got[b] < n).all()
            if n == 0:
                assert (got[b] == -1).all()
                continue
            rows, cols = linear_sum_assignment(c[b, :, :n])
            pairs = [(q, g) for q, g in enumerate(got[b]) if g >= 0]
            assert len(pairs) == min(n, cost.shape[1])
            np.testing.assert_allclose(sum(c[b, q, g] for q, g in pairs),
                                       c[b][rows, cols].sum(), rtol=1e-9,
                                       atol=1e-9)


def test_codec_equals_jax_bitwise_and_the_plain_codec():
    for m in _masks():
        h, w = m.shape
        s = native.rle_encode(m)
        assert s == jnative.rle_encode(m)
        assert tcoco.encode_rle(m) == tcoco.encode_rle_plain(m) == {
            "size": [h, w], "counts": s}
        back = native.rle_decode(s, h, w)
        np.testing.assert_array_equal(back, jnative.rle_decode(s, h, w))
        np.testing.assert_array_equal(back, m)
        for counts in (s, s.encode("ascii")):
            np.testing.assert_array_equal(tcoco.decode_rle(counts, (h, w)),
                                          tcoco.decode_rle_plain(counts,
                                                                 (h, w)))
    # uncompressed runs take the numpy decoder
    np.testing.assert_array_equal(tcoco.decode_rle([1, 2, 3], (2, 3)),
                                  [[0, 1, 0], [1, 0, 0]])


def test_mask_iou_equals_jax_bitwise_and_the_plain_iou():
    rng = np.random.RandomState(2)
    masks = [m for m in _masks() if m.shape == (64, 96)]
    dets = np.stack(masks + [_rand_mask(rng, 64, 96) for _ in range(3)])
    gts = np.stack([_rand_mask(rng, 64, 96) for _ in range(3)]
                   + masks[:2] + [masks[-1]]).astype(bool)
    for crowd in (None, np.asarray([0, 1, 0, 0, 1, 1], bool)):
        got = tcoco_eval.mask_iou(dets, gts, crowd)
        np.testing.assert_array_equal(
            got, jnative.mask_iou_native(dets, gts, crowd))
        np.testing.assert_array_equal(
            got, tcoco_eval.mask_iou_plain(dets, gts, crowd))
    assert tcoco_eval.mask_iou(dets[:0], gts).shape == (0, 6)


def _costs():
    """Mask2Former-shaped costs: (B, Q, G) with 0 to G valid columns."""
    rng = np.random.RandomState(5)
    cost = rng.rand(3, 16, 6).astype(np.float32) * 4 - 2
    return cost, np.asarray([6, 0, 2], np.int32)


@pytest.mark.parametrize("impl", ["callback", "native", "auction"])
def test_hungarian_assign_impls_equal_jax(impl):
    cost, nv = _costs()
    got = tmatching.hungarian_assign(torch.from_numpy(cost),
                                     torch.from_numpy(nv), impl=impl)
    want = np.asarray(jmatching.hungarian_assign(cost, nv, impl=impl))
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    if impl != "auction":
        np.testing.assert_array_equal(
            got.numpy(), jmatching._solve_batch(cost, nv))


def test_hungarian_assign_auto_and_kernel_on_the_cpu():
    cost, nv = _costs()
    c, n = torch.from_numpy(cost), torch.from_numpy(nv)
    assert torch.equal(tmatching.hungarian_assign(c, n),
                       tmatching.hungarian_assign(c, n, impl="auction"))
    with pytest.raises(ValueError, match="CUDA"):
        tmatching.hungarian_assign(c, n, impl="auction_kernel")
    with pytest.raises(ValueError, match="impl"):
        tmatching.hungarian_assign(c, n, impl="auction_pallas")


def test_library_lands_in_build_and_nowhere_else(tmp_path, monkeypatch):
    assert native.library_path().parent == ROOT / "vitadapter_torch" / "_build"
    watched = [ROOT / "native", ROOT / "vitadapter_torch" / "ops" / "host",
               ROOT / "vitadapter_torch" / "ops"]
    before = [sorted(os.listdir(d)) for d in watched]
    native.rle_encode(np.eye(3, dtype=np.uint8))
    assert native.library_path().is_file()
    build = tmp_path / "_build"
    monkeypatch.setattr(native, "BUILD_DIR", build)
    monkeypatch.setattr(native, "_lib", None)
    n = native.calls["rle_encode"]
    assert native.rle_encode(np.eye(3, dtype=np.uint8)) == \
        jnative.rle_encode(np.eye(3, dtype=np.uint8))
    assert native.calls["rle_encode"] == n + 1
    assert sorted(p.name for p in build.iterdir()) == [
        native.library_path().name]
    assert [sorted(os.listdir(d)) for d in watched] == before
    assert sorted(os.listdir(watched[1])) == ["lap.cpp", "rle.cpp"]


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.lap_solve_batch(np.zeros((1, 2, 2)), np.asarray([2]))
    broken = tmp_path / "broken-g++"
    broken.write_text("#!/bin/sh\necho 'error: no room' >&2\nexit 3\n")
    broken.chmod(0o755)
    monkeypatch.setattr(native, "CXX", str(broken))
    with pytest.raises(RuntimeError, match="(?s)exit 3.*no room"):
        tcoco_eval.mask_iou(np.ones((1, 2, 2)), np.ones((1, 2, 2)))
    assert not (tmp_path / "_build").exists() or not any(
        (tmp_path / "_build").iterdir())
