"""The system's own spans (``vista_tpu_torch.utils.profiling``) in a traced
run's record: the device time launched inside them and the device's idle
time while the host was inside them.

The system stores a span only while a profiler records, stamped with
``time.time_ns()``, the clock of the profiler's host events, so its spans
lie on the axis of the record's device intervals and launch times. They are
read from the system's store after the window (or from ``rec["program"]``,
``[(name, start_s, end_s, index, parent)]``, where the record carries
them), clipped to ``rec["window"]``; a span's descendants (by ``parent``)
count with it. Exact interval arithmetic: an instant inside nested or
overlapping spans counts once. Where no span of the names lies in the
window (a system without spans), the functions return None.
"""

from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Tuple

from benchmark import trace

Interval = Tuple[float, float]


def spans(rec: dict) -> list:
    """``[(name, start_s, end_s, index, parent)]``: the record's, or the
    system's store read once into the record."""
    if "program" not in rec:
        rec["program"] = stored()
    return rec["program"]


def stored() -> list:
    """The system's closed spans in seconds; [] where it keeps none."""
    try:
        from vista_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    if read is None:
        return []
    return [(s.name, s.start_ns * 1e-9, s.end_ns * 1e-9, s.index, s.parent)
            for s in read() if s.end_ns is not None]


def named(rec: dict, names: Iterable[str]) -> List[Interval]:
    """The intervals of the spans called ``names`` and of their descendants,
    clipped to the window (those outside it dropped)."""
    names = set(names)
    w0, w1 = rec["window"]
    everything = spans(rec)
    children = {}
    for s in everything:
        children.setdefault(s[4], []).append(s)
    todo = [s for s in everything if s[0] in names]
    out = []
    while todo:
        s = todo.pop()
        a, b = max(s[1], w0), min(s[2], w1)
        if a < b:
            out.append((a, b))
        todo += children.get(s[3], [])
    return out


def busy(rec: dict) -> List[Interval]:
    """The union of the device's intervals, clipped to the window."""
    w0, w1 = rec["window"]
    return trace.union((max(s, w0), min(e, w1)) for _, s, e, _ in rec["device"]
                       if e > w0 and s < w1)


def idle(rec: dict) -> List[Interval]:
    """The window's instants in which no device operation ran."""
    w0, w1 = rec["window"]
    edges = [w0] + [x for iv in busy(rec) for x in iv] + [w1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def intersect(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def launched_in(rec: dict, names: Iterable[str]) -> Optional[list]:
    """The device operations of the window whose launch ran inside the spans
    called ``names``."""
    inside = trace.union(named(rec, names))
    if not inside:
        return None
    starts = [s for s, _ in inside]
    w0, w1 = rec["window"]
    ops = []
    for op in rec["device"]:
        t = op[3]
        if t is None or op[2] <= w0 or op[1] >= w1:
            continue
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= inside[k][1]:
            ops.append(op)
    return ops


def busy_in(rec: dict, names: Iterable[str]) -> Optional[float]:
    """Device seconds (two streams at once count once) of the operations
    whose launch ran inside the spans called ``names``."""
    ops = launched_in(rec, names)
    if ops is None:
        return None
    w0, w1 = rec["window"]
    return length(trace.union((max(s, w0), min(e, w1)) for _, s, e, _ in ops))


def idle_in(rec: dict, names: Iterable[str]) -> Optional[float]:
    """Idle seconds of the device while the host was inside the spans called
    ``names``."""
    inside = trace.union(named(rec, names))
    return length(intersect(idle(rec), inside)) if inside else None


def idle_outside(rec: dict, names: Iterable[str]) -> Optional[float]:
    """Idle seconds of the device while the host was outside every span
    called ``names``."""
    inside = trace.union(named(rec, names))
    if not inside:
        return None
    return length(idle(rec)) - length(intersect(idle(rec), inside))


def count(rec: dict, name: str) -> Optional[int]:
    """Spans called ``name`` that start in the window (None where the window
    holds no span of the system at all)."""
    w0, w1 = rec["window"]
    found = [s for s in spans(rec) if s[2] > w0 and s[1] < w1]
    return sum(1 for s in found if s[0] == name and s[1] >= w0) if found else None

