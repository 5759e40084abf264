"""The metric arithmetic, kept apart from what it reads so that the tests
hold it on the CPU: a rate over the whole window, a percentile over all
samples, the busy time of a device as a union of intervals, and the
spread the bounds are set from."""

from __future__ import annotations

import statistics

import numpy as np


def rate(count: int, seconds: float) -> float:
    """Work done in the window over the window's whole length."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return count / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of every sample (numpy's linear rule)."""
    v = np.asarray(values, np.float64).ravel()
    if v.size == 0:
        raise ValueError("no samples")
    return float(np.percentile(v, q))


def union_length(intervals, lo: float | None = None,
                 hi: float | None = None) -> float:
    """Length covered by the union of ``(start, end)`` intervals, each
    clipped to ``[lo, hi]`` when given: overlapping work (a copy beside a
    kernel) counts once."""
    return sum(e - s for s, e in merged(intervals, lo, hi))


def merged(intervals, lo: float | None = None,
           hi: float | None = None) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals as disjoint sorted ones,
    clipped to ``[lo, hi]`` when given."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, t = [], lo
    for s, e in merged(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def spread(values) -> float:
    """Distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / q2
