"""The reduction of a trace to the per-layer metrics, on a made-up trace."""

from collections import Counter

import pytest

from port_bench import readers
from port_bench.trace import DeviceOp, TraceSummary, summarize

OPS = [
    DeviceOp("void msda_fwd_kernel<float, 4, 2, 8>(float const*)", 0, 10),
    DeviceOp("void msda_bwd_kernel<float, 4, 2, 8>(float const*)", 5, 20),
    DeviceOp("void cast_to_bf16<8>(float const*)", 25, 5),
    DeviceOp("sm90_xmma_gemm_bf16", 40, 20),
    DeviceOp("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", 70, 10),
    DeviceOp("Memcpy HtoD (Pageable -> Device)", 85, 5),
]
HOST = [(28, 45, "aten::mm"), (0, 100, "train step"),
        (60, 70, "aten::add")]


def summary():
    return TraceSummary(list(OPS), HOST, 100e-6, 0.0, 100.0)


def test_busy_is_the_union_of_device_intervals():
    s = summary()
    # [0, 30] [40, 60] [70, 80] [85, 90]
    assert s.busy_s == pytest.approx(65e-6)
    assert readers.idle_pct(_ctx(s), "train") == pytest.approx(35.0)


def test_family_time_and_launch_counts():
    s = summary()
    assert s.family_seconds("msda") == pytest.approx(35e-6)
    assert s.launch_mismatch("msda", Counter(msda_fwd=1, msda_bwd=1)) is None
    assert "msda_bwd" in s.launch_mismatch("msda",
                                           Counter(msda_fwd=1, msda_bwd=2))


def test_idle_gaps_name_the_innermost_host_operation():
    gaps = summary().idle_gaps()
    # [30, 40] under aten::mm, [60, 70] under aten::add, [90, 100] and
    # [80, 85] under the step alone
    assert [g[0] for g in gaps] == ["aten::mm", "aten::add", "train step",
                                    "train step"]
    assert [g[1] for g in gaps] == pytest.approx([10e-6] * 3 + [5e-6])


def _ctx(trace):
    class C:
        kind = "train"
    c = C()
    c.trace = trace
    return c


def test_roofline_is_silent_when_counts_disagree():
    class C:
        kind = "train"
        trace = summary()
        launches = Counter(msda_fwd=3, msda_bwd=1)
        msda_calls = [dict(B=1, S=10, M=1, D=8, Lq=10, L=1, P=1, es=4)]
        attn_calls = []
        batch, traced_units = 1, 1
    assert readers.kernel_roofline(C(), "msda", "train") is None
    C.launches = Counter(msda_fwd=1, msda_bwd=1)
    assert readers.kernel_roofline(C(), "msda", "train") > 0


def test_the_span_runs_from_the_first_mark_to_the_last():
    import torch

    class Ev:
        def __init__(self, name, start, end, device):
            self.name = name
            self.time_range = type("R", (), {"start": start, "end": end})
            self.device_type = device

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    prof = type("P", (), {"events": lambda self: [
        Ev("cudaLaunchKernel", 8, 12, cpu),
        Ev("fill (mark)", 10, 11, cuda),
        Ev("gemm", 20, 50, cuda),
        Ev("cudaStreamSynchronize", 55, 95, cpu),
        Ev("fill (mark)", 90, 92, cuda)]})()
    s = summarize(prof)
    assert (s.t0_us, s.t1_us) == (10, 92)
    assert s.window_s == pytest.approx(82e-6)
    assert s.busy_s == pytest.approx(33e-6)
    # [50, 90] under the synchronize, [11, 20] after the first mark
    assert s.idle_gaps() == [["cudaStreamSynchronize", pytest.approx(40e-6)],
                             ["host, after fill ", pytest.approx(9e-6)]]
