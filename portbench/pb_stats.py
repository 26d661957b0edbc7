"""Percentiles and rates of a window, on the host's wall clock.

The arithmetic of ``repro_torch/loadgen/metrics.py`` and
``ServiceRouter.stats()`` (numpy's linear percentile), with two
corrections: times are wall seconds, not a virtual clock, and a call
that failed or never gave a first token counts as beyond every limit
(+inf), so a percentile that reaches one is +inf.  A rate is taken over
all the work and all the time of the window.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence


def percentile(values: Iterable[float], q: float) -> float:
    """numpy's linear percentile of ``values`` (``inf`` allowed): +inf
    where the interpolation touches an infinite value."""
    xs: List[float] = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if math.isinf(xs[hi]) or math.isinf(xs[lo]):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(times: Sequence[float], t0: float, t1: float) -> float:
    """Events stamped in [t0, t1) per second of that window."""
    n = sum(1 for t in times if t0 <= t < t1)
    return n / (t1 - t0)


def gaps(times: Sequence[float]) -> List[float]:
    """The gaps between consecutive stamps of one stream."""
    return [b - a for a, b in zip(times, times[1:])]
