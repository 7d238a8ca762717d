"""Window arithmetic: a rate is all the work in the window over all of
its time; a tail is taken over every batch of the window."""
from __future__ import annotations

import math
from typing import Sequence


def rate(work: float, start: float, end: float) -> float:
    """Work per second over the whole window [start, end]."""
    if end <= start:
        raise ValueError("an empty window")
    return work / (end - start)


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all values, by the nearest rank:
    the smallest value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(v)))
    return v[rank - 1]


def batch_latencies(pulls: Sequence[float], dones: Sequence[float]):
    """Each batch's time from its pull by the pipeline to the return of
    its records; the batches come back in pull order."""
    if len(dones) != len(pulls):
        raise ValueError(f"{len(pulls)} batches pulled, {len(dones)} came "
                         f"back")
    return [d - p for p, d in zip(pulls, dones)]

