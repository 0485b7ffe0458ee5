"""Percentiles and interval arithmetic."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile by linear interpolation between closest
    ranks (numpy's default); NaN for no values."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def clip(intervals: Iterable[Tuple[float, float]], t0: float, t1: float
         ) -> List[Tuple[float, float]]:
    """Each interval cut to ``[t0, t1]``; empty ones dropped."""
    return [(max(a, t0), min(b, t1)) for a, b in intervals
            if min(b, t1) > max(a, t0)]


def busy_and_gaps(intervals: Iterable[Tuple[float, float]], t0: float,
                  t1: float) -> Tuple[float, List[Tuple[float, float]]]:
    """Covered length of ``[t0, t1]`` and its uncovered gaps."""
    merged = merge(clip(intervals, t0, t1))
    busy = sum(b - a for a, b in merged)
    gaps, cursor = [], t0
    for a, b in merged:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = b
    if t1 > cursor:
        gaps.append((cursor, t1))
    return busy, gaps
