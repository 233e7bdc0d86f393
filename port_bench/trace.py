"""Reduce a `torch.profiler` trace, kept in memory, to what the per-layer
metrics read: the device's busy time (the union of its kernel, copy and
set intervals), device time and counts by kernel family, and the longest
idle gaps named by what the host was doing."""

from __future__ import annotations

import re
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from port_bench.stats import busy_union

# the kernels each of the port's entry points launches, by the name the
# trace gives them: (the kernel launched once a call, every kernel of it)
ENTRY_KERNELS = {
    "msda_fwd": (r"\bmsda_fwd_kernel\b", r"\bmsda_fwd_kernel\b"),
    "msda_bwd": (r"\bmsda_bwd_kernel\b",
                 r"\bmsda_bwd_kernel\b|\bcast_to_bf16\b"),
    "msda_level_fwd": (r"\bmsda_level_fwd_kernel\b",
                       r"\bmsda_level_fwd_kernel\b"),
    "msda_level_dv": (r"\bmsda_level_dv_kernel\b",
                      r"\bmsda_level_dv_kernel\b"),
    "msda_level_dgrid": (r"\bmsda_level_dgrid_kernel\b",
                         r"\bmsda_level_dgrid_kernel\b"),
    "attention_fwd": (r"\battention_fwd_(f32|bf16)\b",
                      r"\battention_fwd_(f32|bf16)\b"),
    "attention_bwd": (r"\battention_bwd_delta\b",
                      r"\battention_bwd_(delta|dq_\w+|dkdv_\w+)\b"),
    "point_sample_fwd": (r"\bpoint_sample_(stream|tile|gather)_kernel\b",
                         r"\bpoint_sample_(stream|tile|gather)_kernel\b"),
    "point_sample_bwd": (r"\bpoint_sample_bwd_kernel\b",
                         r"\bpoint_sample_bwd_kernel\b"),
    "auction": (r"\bauction_kernel\b", r"\bauction_kernel\b"),
    "nms": (r"\bnms_mask\b", r"\bnms_(mask|walk)\b"),
}
# kernels shared by several entry points of one family
SHARED = {"attention": r"\bsplit_tf32\b"}
FAMILIES = {
    "msda": ("msda_fwd", "msda_bwd", "msda_level_fwd", "msda_level_dv",
             "msda_level_dgrid"),
    "attention": ("attention_fwd", "attention_bwd"),
}


@dataclass
class DeviceOp:
    name: str
    start: float      # us, the profiler's clock
    dur: float        # us


@dataclass
class TraceSummary:
    ops: List[DeviceOp]
    host: List[Tuple[float, float, str]]      # (start, end, name), us
    window_s: float
    t0_us: float
    t1_us: float
    busy_s: float = 0.0
    by_name: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        self.busy_s = busy_union(
            (max(o.start, self.t0_us), min(o.start + o.dur, self.t1_us))
            for o in self.ops
            if o.start + o.dur > self.t0_us and o.start < self.t1_us) / 1e6
        acc = defaultdict(float)
        for o in self.ops:
            acc[o.name] += o.dur / 1e6
        self.by_name = dict(acc)

    def seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(t for n, t in self.by_name.items() if rx.search(n))

    def count(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for o in self.ops if rx.search(o.name))

    def family_seconds(self, family: str) -> float:
        pats = [ENTRY_KERNELS[e][1] for e in FAMILIES[family]]
        if family in SHARED:
            pats.append(SHARED[family])
        return self.seconds("|".join(f"(?:{p})" for p in pats))

    def launch_mismatch(self, family: str, launches: Counter
                        ) -> Optional[str]:
        """None when the trace holds as many calls of each of the family's
        entry points as the port counted (`cuda_ext.launches`) over the
        traced span; else what differs."""
        bad = []
        for e in FAMILIES[family]:
            seen = self.count(ENTRY_KERNELS[e][0])
            if seen != launches.get(e, 0):
                bad.append(f"{e}: {seen} in the trace, "
                           f"{launches.get(e, 0)} launched")
        return "; ".join(bad) or None

    def top_ops(self, n: int = 10) -> List[List]:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[short(k), v] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The n longest device idle gaps inside the span, each named by
        the innermost host operation the trace holds at its middle (with
        device activity alone traced, the CUDA runtime's calls), else as
        the host's time after the device operation that preceded it."""
        ivs = sorted((o.start, o.start + o.dur, o.name) for o in self.ops)
        gaps, end, last = [], self.t0_us, "the span's start"
        for s, e, name in ivs:
            if s > end:
                gaps.append((end, s, last))
            if e > end:
                end, last = e, name
        if self.t1_us > end:
            gaps.append((end, self.t1_us, last))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        out = []
        for s, e, before in gaps:
            mid = (s + e) / 2
            cover = [h for h in self.host if h[0] <= mid <= h[1]]
            name = (min(cover, key=lambda h: h[1] - h[0])[2] if cover
                    else "host, after " + short(before, 80))
            out.append([short(name), (e - s) / 1e6])
        return out


def short(name: str, n: int = 96) -> str:
    """A kernel's name without `void`, anonymous namespaces and its
    argument list, at most n characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0][:n]


def summarize(prof) -> TraceSummary:
    """The device operations (kernels, copies, sets) and the host's
    operations of a finished profiler that traced a span opened and closed
    by a mark on the device (`harness.traced_span`): the span runs from
    the first device operation's start to the last one's end."""
    import torch

    ops, host = [], []
    for e in prof.events():
        tr = e.time_range
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ops.append(DeviceOp(e.name, tr.start, tr.end - tr.start))
        else:
            host.append((tr.start, tr.end, e.name))
    if not ops:
        raise RuntimeError("the trace holds no device operation")
    t0 = min(o.start for o in ops)
    t1 = max(o.start + o.dur for o in ops)
    return TraceSummary(ops, host, (t1 - t0) / 1e6, t0, t1)
