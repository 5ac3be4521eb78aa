"""Percentiles and spreads of the benchmark's samples.

``pct`` is the nearest-rank percentile of the port's ``bench_torch.py``
(copied, not imported): the sorted sample at index ⌊q·n⌋, capped at the
last. ``spread`` is the distance between the first and third quartiles of
``statistics.quantiles(values, n=4)`` as a share of the median, the rule the
benchmark's bounds are set by.
"""

from __future__ import annotations

import statistics


def pct(vals: list[float], q: float) -> float:
    s = sorted(vals)
    return s[min(len(s) - 1, int(q * len(s)))]


def spread(vals: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(vals, n=4)
    return (q3 - q1) / statistics.median(vals)
