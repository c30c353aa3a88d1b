"""The program's spans in the traced window, and the two readings made of them.

The program opens ``tgtc.step.*`` spans (``forward``, ``backward``,
``optimizer``) in each training step and ``tgtc.render.*`` spans
(``coarse``, ``resample``, ``fine``) in each ray block, on the profiler's
clock and as direct children of the benchmark's ``bench.step`` or
``bench.frame``, where :func:`~benchmark.harness.trace.profile_units` keeps
them. Both readings split a number the benchmark already reports; the
window only apportions it:

* :func:`host_ms`: the spans' share of ``bench.step``'s host time in the
  window, times the median host milliseconds of a step call
  (``step_host_ms.train``);
* :func:`idle_ms`: the share of the device's idle gaps in the window that
  falls inside the spans (by intersection, not by where a gap starts), times
  the idle milliseconds a unit (``device_idle_share`` of the unprofiled
  unit).

A program without the spans (a commit before them) reads None, not 0.
"""

from __future__ import annotations

import statistics
from typing import List, Optional, Sequence, Tuple

STEP_SPAN = "bench.step"


def _union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, disjoint intervals covering ``intervals``."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def gaps(trace) -> List[Tuple[float, float]]:
    """The device's idle gaps: between consecutive merged device operations."""
    busy = _union([(e.start, e.end) for e in trace.device])
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]


def _overlap(xs: List[Tuple[float, float]], ys: List[Tuple[float, float]]) -> float:
    """Length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _spans(trace, names: Sequence[str]):
    return [e for e in trace.host if e.name in names]


def host_ms(ctx, names: Sequence[str]) -> Optional[float]:
    """Host milliseconds a step inside the spans ``names``: their time over
    ``bench.step``'s in the window, times median(``ctx.host_ms``)."""
    spans = _spans(ctx.trace, names)
    steps = _spans(ctx.trace, (STEP_SPAN,))
    if not spans or not steps or not ctx.host_ms:
        return None
    share = sum(e.end - e.start for e in spans) / sum(e.end - e.start for e in steps)
    return share * statistics.median(ctx.host_ms)


def idle_ms(ctx, names: Sequence[str]) -> Optional[float]:
    """Idle milliseconds of the device a unit while the host is inside the
    spans ``names``: the gaps' time under the spans over all the gaps' time
    in the window, times ``idle_share / 100 × unit_s`` (at least 0)."""
    spans = _spans(ctx.trace, names)
    if not spans:
        return None
    idle = gaps(ctx.trace)
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return 0.0
    inside = _overlap(idle, _union([(e.start, e.end) for e in spans]))
    return inside / total * max(0.0, ctx.idle_share() / 100 * ctx.unit_s * 1e3)
