"""The statistics the benchmark reports and the proof of its bounds reads."""
from __future__ import annotations

import math
import statistics
from typing import Iterable, Optional


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The q-th percentile by nearest rank over every value given: the
    smallest value with at least q % of the values at or below it. An
    unfinished request enters as ``math.inf`` and so counts as missing
    every limit."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def spread(values: Iterable[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    v = list(values)
    q1, q2, q3 = statistics.quantiles(v, n=4)
    return (q3 - q1) / q2
