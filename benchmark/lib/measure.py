"""End-to-end arithmetic over a window's calls, and the spread of runs."""

from __future__ import annotations

import math
import statistics


def rate(work, seconds) -> float:
    """Work of every call completed in the window over the time those
    calls took."""
    total = sum(seconds)
    if total <= 0:
        raise ValueError("rate: no time measured")
    return sum(work) / total


def percentile(values, q: float) -> float:
    """The q-th percentile of every value, nearest rank (no interpolation,
    no chunking)."""
    if not values:
        raise ValueError("percentile of nothing")
    ordered = sorted(values)
    return ordered[max(math.ceil(q / 100 * len(ordered)) - 1, 0)]


def spread(values) -> float:
    """(third quartile - first quartile) / median, by
    ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
