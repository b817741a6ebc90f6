"""The arithmetic of the end-to-end metrics."""
from __future__ import annotations

from typing import Sequence


def rate(work: float, seconds: float) -> float:
    """Work per second over a whole window: all its work over all its
    time, never a median of chunks."""
    return work / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile of all values, linear between order statistics
    (numpy's default). Needs a sample: at least one value."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def beyond(values: Sequence[float], q: float) -> int:
    """How many values lie above the q-th percentile."""
    p = percentile(values, q)
    return sum(v > p for v in values)

