"""Arithmetic over a window's units: rates, quartiles and percentiles."""

from __future__ import annotations

import math
import statistics


def rate(work_per_unit, window_s: float) -> float:
    """Work of every unit that ran in the window over the window's whole
    time: a unit that stalled keeps its share of the time."""
    return float(sum(work_per_unit)) / window_s


def quartiles(values):
    """(q1, median, q3) as statistics.quantiles gives them; one value
    repeats itself."""
    xs = list(values)
    if len(xs) < 2:
        return (float(xs[0]),) * 3
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return float(q1), float(q2), float(q3)


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) by the nearest rank: the least
    value with at least q% of the values at or below it."""
    xs = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return float(xs[k - 1])
