"""Percentile and rate arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0–100) of ``values``, interpolated
    linearly between the two nearest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if pos == lo or xs[hi] == xs[lo]:  # also keeps inf - inf out
        return xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(done: float, seconds: float) -> float:
    """Work completed per second over the whole window."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return done / seconds
