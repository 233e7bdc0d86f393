"""The arithmetic of the end-to-end metrics: rates over a whole window,
percentiles over all requests and the union of device intervals."""

from __future__ import annotations

import math
from typing import Iterable, Sequence, Tuple


def rate(count: float, seconds: float) -> float:
    """Work completed in a window over the window's whole length."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of all values: the
    smallest value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]


def busy_union(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total
