"""The 95th percentile of every untraced request's latency in the window,
from its start (upload included) to its logits synchronized."""

from port_bench import stats

UNIT = "ms"
SOURCE = "host_clock"


def read(ctx):
    if ctx.kind != "infer" or not ctx.latencies:
        return None
    return 1e3 * stats.percentile(ctx.latencies, 95)
