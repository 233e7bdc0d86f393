"""One run of one cell: set-up, the measured window, the traced span (with
`--trace 1`), then the reference's check, and one JSON line.

What a run does is its traffic's kind: `kinds/<kind>.py` (`train`,
`infer`), found by the name the traffic mix gives, holds its `run`.
Every metric, end to end or per layer, is read from the run's `Context`
by `metrics/<name>.py`. A cell that asks for more than one card runs
under `torch.distributed.run`, one process a card, and rank 0 prints the
line."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from port_bench import check, flops, spec, stats
from port_bench import traffic_gen as tg
from port_bench import weights as W
from port_bench.reference import builder as ref_builder

FORBIDDEN = ("jax", "jaxlib", "flax", "vitadapter")
CHECK_STEPS = 3


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's,
    flax's or the JAX package's."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def process_age_s() -> float:
    """Seconds since this process started (the kernel's record)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclass
class Context:
    """What the metrics read."""
    kind: str
    cell: spec.Cell
    rate: float                    # images a second over the window's
                                   # untraced steps or requests
    build_s: float
    batch: int                     # images a step or crops a request
    setup_s: float = 0.0
    peak: int = 0                  # bytes, the allocator's over the window
    latencies: List[float] = field(default_factory=list)   # s, untraced
    hooks: Dict[str, List[float]] = field(default_factory=dict)
    trace: Optional[object] = None          # trace.TraceSummary
    traced_units: int = 0                   # steps or requests traced
    launches: Counter = field(default_factory=Counter)
    flops: Dict[str, float] = field(default_factory=dict)
    msda_calls: List[Dict] = field(default_factory=list)
    attn_calls: List[Dict] = field(default_factory=list)

    @classmethod
    def of_window(cls, kind: str, cell: spec.Cell, batch: int, units: int,
                  window_s: float, span: Optional["Span"], log=None,
                  **kw) -> "Context":
        """The rate counts only the window's untraced units over their own
        time: the traced span, with the profiler's start and stop, is taken
        out of both."""
        traced = span.units if span is not None else 0
        own_s = window_s - (span.host_s if span is not None else 0.0)
        rate = stats.rate((units - traced) * batch, own_s)
        summ = kw.get("trace")
        if summ is not None and log is not None and units > traced:
            log(f"untraced {own_s / (units - traced) * 1e3:.1f} ms a unit "
                f"over {units - traced} (host clock); traced "
                f"{summ.window_s / traced * 1e3:.1f} ms a unit over "
                f"{traced} (the trace's span between its device marks)")
        return cls(kind, cell, rate, batch=batch, traced_units=traced,
                   launches=span.launches if span is not None else Counter(),
                   **kw)


class EventHooks:
    """CUDA events recorded on the stream around the forwards of named
    modules and around a callable, paired per call."""

    def __init__(self):
        self.pairs: Dict[str, List] = {}
        self.handles = []

    def _start(self, key):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.pairs.setdefault(key, []).append([e, None])

    def _end(self, key):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.pairs[key][-1][1] = e

    def module(self, key: str, mod: torch.nn.Module) -> None:
        self.handles.append(mod.register_forward_pre_hook(
            lambda *_: self._start(key)))
        self.handles.append(mod.register_forward_hook(
            lambda *_: self._end(key)))

    def wrap(self, key: str, fn: Callable) -> Callable:
        def timed(*a, **k):
            self._start(key)
            out = fn(*a, **k)
            self._end(key)
            return out
        return timed

    def ms(self) -> Dict[str, List[float]]:
        torch.cuda.synchronize()
        for h in self.handles:
            h.remove()
        return {k: [s.elapsed_time(e) for s, e in v if e is not None]
                for k, v in self.pairs.items()}


def _profile():
    """The profiler with device activity alone: no host operator is
    recorded, so the traced steps run at about their untraced pace."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def _launch_counts():
    from vitadapter_torch.ops import cuda_ext
    return Counter(cuda_ext.launches)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Span:
    """A traced span of a run's window."""
    prof: object               # the finished profiler
    units: int                 # steps or requests it ran
    host_s: float              # its length on the host's clock, the
                               # profiler's start and stop included
    launches: Counter          # the port's kernel launches in it


def traced_span(fn: Callable[[int], object], n: int, device) -> Span:
    """n calls of fn(i) under the profiler, between two marks on the
    device: a one-element fill launched just after a synchronize, before
    the first call, and one after the last call, before the closing
    synchronize. The trace's span runs from the first mark's start to the
    second's end (`trace.summarize`)."""
    sync(device)
    mark = torch.zeros(1, device=device)
    before = _launch_counts()
    t = time.perf_counter()
    with _profile() as prof:
        sync(device)
        mark.fill_(1.0)
        for i in range(n):
            fn(i)
        mark.fill_(2.0)
        sync(device)
    host_s = time.perf_counter() - t
    return Span(prof, n, host_s, _launch_counts() - before)


def summary(span: Optional[Span]):
    from port_bench import trace as T
    return None if span is None else T.summarize(span.prof)


def model_shapes(cfg: Dict):
    ref = ref_builder.build(cfg["model"], "meta")
    return W.model_shapes(ref), W.msda_geometry(ref)


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes, geometry = model_shapes(cfg)
    return W.make_state(shapes, geometry, tg.sub_seed(seed, 0), device)


class Phases:
    """Logs the seconds each phase of a run took, to a synchronize."""

    def __init__(self, log, device):
        self.log, self.device = log, device
        self.t = time.perf_counter()

    def __call__(self, name: str) -> float:
        sync(self.device)
        now = time.perf_counter()
        dt, self.t = now - self.t, now
        self.log(f"{name}: {dt:.2f} s")
        return dt


# ------------------------------------------------------------------ result

def read_metrics(metrics: List[Dict], ctx: Context, log,
                 here=spec.HERE) -> Dict[str, Dict]:
    """Each metric by its reader, `metrics/<name>.py`; one whose reader
    finds nothing to read is left out of the line."""
    out = {}
    for m in metrics:
        v = spec.metric_reader(m["name"], here=here).read(ctx)
        if v is None:
            log(f"{m['name']}: nothing to read")
            continue
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def add_model_counts(cell: spec.Cell, ctx: Context) -> None:
    """Operations and kernel calls of one image, for the rooflines."""
    cfg = cell.config
    hw = tuple(cfg["data"]["crop_size"] if ctx.kind == "train"
               else cfg["test_cfg"]["crop_size"])
    ctx.flops, ctx.msda_calls, ctx.attn_calls = flops.count(
        cfg["model"], hw, ctx.kind == "train")


def rank() -> int:
    return int(os.environ.get("RANK", "0"))


def launch_command(cell: spec.Cell, argv: List[str]) -> Optional[List[str]]:
    """For a cell on more than one card, run from outside
    `torch.distributed.run`: the command that runs this one under it, one
    process a card on this host; else None."""
    if cell.chips <= 1 or "LOCAL_RANK" in os.environ:
        return None
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={cell.chips}",
            str(spec.HERE / "run.py"), *argv]


def main(argv=None) -> int:
    import argparse

    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    cell = spec.load_cell(args.workload)
    # fp32 is fp32: no TF32 products where a configuration states float32
    # (each configuration lists this under `changes`)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is false")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"cell {cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} visible")
        return 3
    cmd = launch_command(cell, argv)
    if cmd is not None:
        return subprocess.run(cmd).returncode
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(device)
    run = spec.kind_runner(cell.traffic["kind"])
    result = run(cell, args.seed, args.seconds, bool(args.trace), device,
                 log=log)
    return report(cell, result, bool(args.trace), log)


def report(cell: spec.Cell, result: Dict, trace: bool, log) -> int:
    """Judges the run and, on rank 0, prints its line; a kind that runs
    on several ranks gives every rank's `result` the same `numbers`,
    `attempted` and `failed`, and `ctx.peak` the fullest card's peak."""
    ctx = result["ctx"]
    numbers = result["numbers"]
    correct = check.judge(numbers, cell.limits) and result["failed"] == 0
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": ctx.peak}
    line = {"correct": correct, "attempted": result["attempted"],
            "failed": result["failed"]}
    if trace:
        add_model_counts(cell, ctx)
        line["metrics"] = read_metrics(cell.per_layer, ctx, log)
        device["busy_s"] = ctx.trace.busy_s
        device["window_s"] = ctx.trace.window_s
        line["device"] = device
        line["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                             "idle_gaps": ctx.trace.idle_gaps()}
    else:
        line["metrics"] = read_metrics(cell.end_to_end, ctx, log)
        line["device"] = device
    bad = forbidden_modules()
    if bad:
        log("modules of JAX or of the JAX package are loaded: "
            + ", ".join(bad))
        return 4
    line["checks"] = {k: {"value": v, "limit": cell.limits.get(k)}
                      for k, v in numbers.items()}
    if rank() != 0:
        return 0
    for k, v in line["checks"].items():
        log(f"check {k} = {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0
