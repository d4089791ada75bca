"""The metric arithmetic: percentiles, spreads and the union of intervals."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of `values`, interpolated linearly
    between the two nearest ranks (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """Distance between the first and third quartiles as a share of the
    median, by statistics.quantiles(values, n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals):
    """The idle stretches between merged (start, end) intervals, as
    (start, end, index of the interval that ends the gap) in the sorted
    order."""
    out, end = [], None
    for i, (s, e) in enumerate(sorted(intervals)):
        if end is not None and s > end:
            out.append((end, s, i))
        end = e if end is None else max(end, e)
    return out
