"""Window arithmetic: how the end-to-end metrics are taken from what a run
saw between the window's open (t0) and close (t1), in seconds on the host
clock.

A rate is all the work finished in the window over the window's length;
a tail is a percentile over every sample of the window.  No statistic is
a median of chunks, and no request due in the window is dropped from a
tail.  Open-loop traffic is served on past the close until every request
due in the window has its first token (a cell's `extend_s` caps that), so
a TTFT is taken whole; one still without it when the run stops enters
with its wait so far (a lower bound, counted as is).
"""
from __future__ import annotations

import statistics

import numpy as np


def percentile(values, q: float) -> float | None:
    """The q-th percentile (numpy's linear interpolation) of all values,
    or None when there are none."""
    vals = list(values)
    if not vals:
        return None
    return float(np.percentile(np.asarray(vals, dtype=np.float64), q))


def rate(count: float, t0: float, t1: float) -> float:
    """Work per second over the whole window."""
    return count / (t1 - t0)


def waits(due: list[float], done: list[float | None], t0: float,
          t1: float, t_end: float | None = None) -> list[float]:
    """For every request due in [t0, t1): the time from its due time to
    its event (first token, admission) if that came by t_end (the end of
    the run's watch, t1 by default), else t_end minus its due time."""
    t_end = t1 if t_end is None else t_end
    out = []
    for d, e in zip(due, done):
        if not t0 <= d < t1:
            continue
        out.append((e if e is not None and e <= t_end else t_end) - d)
    return out


def gaps(stamps: list[list[float]], t0: float, t1: float) -> list[float]:
    """Every gap between two consecutive output tokens of one request as
    the host saw them, the later token inside [t0, t1] and the earlier
    not before t0."""
    out = []
    for ts in stamps:
        for a, b in zip(ts, ts[1:]):
            if t0 <= a and b <= t1:
                out.append(b - a)
    return out


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of
    the median (`statistics.quantiles(values, n=4)`, Python's default
    method): how a bound is set from repeated runs."""
    q1, q2, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / q2
