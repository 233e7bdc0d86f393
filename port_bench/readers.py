"""Shared arithmetic of the per-layer metrics' readers (`metrics/`). Each
returns None where the run holds nothing to read: a kind of run the
metric is not of, no trace, no such kernel in the traced span, or a
trace whose kernel counts disagree with the port's own launch counter."""

from __future__ import annotations

import statistics
import sys
from typing import Optional

from port_bench import flops, roofline


def mean_ms(ctx, key: str, kind: str) -> Optional[float]:
    if ctx.kind != kind or not ctx.hooks.get(key):
        return None
    return statistics.fmean(ctx.hooks[key])


def kernel_roofline(ctx, family: str, kind: str) -> Optional[float]:
    """Percent: the least time of the family's calls in the traced span
    (their shapes from the reference, forward and, in training, backward)
    over the device time of the family's kernels there."""
    if ctx.kind != kind or ctx.trace is None:
        return None
    bad = ctx.trace.launch_mismatch(family, ctx.launches)
    if bad:
        print(f"{family} kernels: the trace and the launch counter "
              f"disagree ({bad})", file=sys.stderr)
        return None
    seconds = ctx.trace.family_seconds(family)
    calls, fn = {"msda": (ctx.msda_calls, roofline.msda_bound_s),
                 "attention": (ctx.attn_calls,
                               roofline.attention_bound_s)}[family]
    if seconds <= 0 or not calls:
        return None
    train = kind == "train"
    bound = sum(fn(c, backward=train) for c in calls)
    return 100.0 * bound * ctx.batch * ctx.traced_units / seconds


def mfu(ctx, kind: str) -> Optional[float]:
    """Percent: the least time of an image's model work over the time an
    image took in the window's untraced steps or requests (host clock)."""
    if ctx.kind != kind or not ctx.flops:
        return None
    least = flops.least_seconds_per_image(ctx.cell.config["model"],
                                          ctx.flops, kind == "train")
    return 100.0 * least * ctx.rate


def idle_pct(ctx, kind: str) -> Optional[float]:
    if ctx.kind != kind or ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
