"""The harness's arithmetic against hand counts: rates, percentiles, the
idle union, the bounds and the operation counts."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import flops, roofline, stats
from port_bench.reference.models.vit import Block
from port_bench.reference.ops.msda import MSDeformAttn


def test_rate_is_work_over_the_whole_window():
    # 37 steps of 4 images whose window, to the final synchronize, lasted
    # 12.5 s: no chunk medians, no excluded stalls
    assert stats.rate(37 * 4, 12.5) == pytest.approx(11.84)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_takes_every_request_and_its_stall():
    lat = [0.1] * 95 + [0.5] + [3.0] * 4          # one slow, four stalls
    assert stats.percentile(lat, 95) == 0.1
    assert stats.percentile(lat, 96) == 0.5
    lat = [0.1] * 94 + [3.0] * 6
    assert stats.percentile(lat, 95) == 3.0
    assert stats.percentile([7.0], 95) == 7.0


def test_idle_union_counts_overlaps_once():
    ivs = [(0, 10), (5, 12), (20, 25), (21, 22), (30, 30)]
    assert stats.busy_union(ivs) == 17
    assert stats.busy_union([]) == 0


def test_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 1.0, 1e12) == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 2e12, 1e12) == pytest.approx(2.0)


def test_msda_bound_counts_each_byte_once():
    c = dict(B=2, S=100, M=4, D=8, Lq=50, L=3, P=4, es=2)
    points = 2 * 50 * 4 * 3 * 4
    value, out = 2 * 100 * 4 * 8 * 2, 2 * 50 * 4 * 8 * 2
    fwd_bytes = value + points * 8 + points * 4 + out
    fwd_ops = 2 * 8 * 4 * points
    assert roofline.msda_bound_s(c, backward=False) == pytest.approx(max(
        fwd_bytes / 3.35e12, fwd_ops / 67e12))
    bwd_bytes = fwd_bytes + value + points * 12
    assert roofline.msda_bound_s(c) == pytest.approx(
        max(fwd_bytes / 3.35e12, fwd_ops / 67e12)
        + max(bwd_bytes / 3.35e12, 2 * fwd_ops / 67e12))


def test_attention_bound_counts_fp32_at_the_tf32_peak():
    c = dict(B=1, H=16, N=1024, D=64, es=4)
    x = 16 * 1024 * 64 * 4
    lse = 16 * 1024 * 4
    ops = 4 * 16 * 1024 * 1024 * 64
    fwd = max((4 * x + lse) / 3.35e12, ops / 495e12)
    bwd = max((8 * x + lse) / 3.35e12, 2 * ops / 495e12)
    assert roofline.attention_bound_s(c, backward=False) == pytest.approx(fwd)
    assert roofline.attention_bound_s(c) == pytest.approx(fwd + bwd)
    c16 = dict(c, es=2)
    assert roofline.attention_bound_s(c16, backward=False) == pytest.approx(
        max((4 * x / 2 + lse) / 3.35e12, ops / 989e12))


def test_one_vit_l_block_counts_as_by_hand():
    N, C = 1024, 1024
    blk = Block(C, 16, qkv_bias=True, device="meta").requires_grad_(False)
    x = torch.empty(1, N, C, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        blk(x, 32, 32)
    # qkv 3C, proj C, mlp 4C twice: 2 N C^2 (3 + 1 + 8); q k^T and P v
    assert fc.get_total_flops() == 24 * N * C * C + 4 * N * N * C


def test_one_msda_call_counts_as_by_hand():
    from port_bench.reference.ops import msda as ref_msda

    d, M, L, P, Lq = 256, 8, 3, 4, 300
    shapes = ((16, 16), (8, 8), (4, 4))
    S = sum(h * w for h, w in shapes)
    m = MSDeformAttn(d, L, M, P, device="meta").requires_grad_(False)
    q = torch.empty(1, Lq, d, device="meta")
    ref = torch.empty(1, Lq, L, 2, device="meta")
    src = torch.empty(1, S, d, device="meta")
    ref_msda.RECORD = []
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            m(q, ref, src, shapes)
        (call,) = ref_msda.RECORD
    finally:
        ref_msda.RECORD = None
    # offsets (M L P 2), weights (M L P), value and output projections
    linear = 2 * Lq * d * (M * L * P * 3) + 2 * S * d * d + 2 * Lq * d * d
    assert fc.get_total_flops() == linear
    assert call == dict(B=1, S=S, M=M, D=d // M, Lq=Lq, L=L, P=P, es=4)
    # 4 corners x 2 operations and 2 for the weight, a channel a point
    assert flops.msda_flops(call) == Lq * M * L * P * (d // M) * 10


def test_a_train_step_counts_three_forwards():
    cfg = {"backbone": {"dtype": "bfloat16"},
           "decode_head": {"dtype": "float32"}}
    per = {"backbone": 989e12, "decode_head": 495e12}
    one = flops.least_seconds_per_image(cfg, per, train=False)
    assert one == pytest.approx(2.0)
    assert flops.least_seconds_per_image(cfg, per, train=True) == \
        pytest.approx(3 * one)


def test_cell_counts_match_the_configurations():
    import json
    import os
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "configs",
                           "m2f_beit_adapter_l_640.json")) as f:
        cfg = json.load(f)
    fl, msda_calls, attn_calls = flops.count(cfg["model"], (640, 640),
                                             train=True)
    # 4 interactions (injector, extractor), 2 extra extractors, 6 pixel
    # decoder layers; BEiT's attention is not the port's kernel
    assert len(msda_calls) == 16 and not attn_calls
    assert 3.3e12 < sum(fl.values()) < 3.7e12
    assert math.isclose(sum(c["Lq"] for c in msda_calls
                            if c["part"] == "decode_head"), 6 * 8400)
