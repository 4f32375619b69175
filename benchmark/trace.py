"""What a ``torch.profiler`` trace of the window says: the device's busy
intervals, kernel times by name, and the host's activity in the device's
idle gaps.

:func:`events` flattens a stopped profiler into plain records,
``(name, on_device, start_s, end_s)``; everything else works on those
records, so it is tested on the CPU with made-up intervals.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Iterable, List, NamedTuple


class Event(NamedTuple):
    name: str
    on_device: bool
    start: float   # seconds, on the profiler's clock
    end: float


def events(prof, markers=()) -> List[Event]:
    """Every event of a stopped ``torch.profiler.profile``: host ones (ops,
    runtime calls) and device ones (kernels, copies, sets). The profiler
    mirrors each ``record_function`` range named in ``markers`` on the
    device's timeline; those copies are no device work and are left out."""
    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = "cuda" in str(e.device_type()).lower()
        if on_device and e.name() in markers:
            continue
        start = e.start_ns() * 1e-9
        out.append(Event(e.name(), on_device, start,
                         start + e.duration_ns() * 1e-9))
    return out


def union(intervals: Iterable) -> List[tuple]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def clip(intervals, lo: float, hi: float) -> List[tuple]:
    """``intervals`` cut to ``[lo, hi]``, empty pieces dropped."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def busy_seconds(evs: List[Event], lo: float, hi: float) -> float:
    """Seconds of ``[lo, hi]`` in which some operation ran on the device."""
    dev = clip(union((e.start, e.end) for e in evs if e.on_device), lo, hi)
    return sum(e - s for s, e in dev)


def device_time_by_name(evs: List[Event]) -> dict:
    """``name -> (launches, seconds)`` of the device's operations."""
    acc = defaultdict(lambda: [0, 0.0])
    for e in evs:
        if e.on_device:
            acc[e.name][0] += 1
            acc[e.name][1] += e.end - e.start
    return {k: (n, t) for k, (n, t) in acc.items()}


def kernels_matching(evs: List[Event], names) -> tuple:
    """``(launches, seconds)`` of the device operations whose name holds
    one of ``names``; launches counted per name, as a dict."""
    counts, secs = {n: 0 for n in names}, 0.0
    for e in evs:
        if not e.on_device:
            continue
        for n in names:
            if n in e.name:
                counts[n] += 1
                secs += e.end - e.start
                break
    return counts, secs


def top_device_ops(evs: List[Event], k: int = 10) -> list:
    """The ``k`` device operations that took the most time: ``[[name,
    seconds], ...]``."""
    by = device_time_by_name(evs)
    return [[n, t] for n, (_, t) in
            sorted(by.items(), key=lambda kv: -kv[1][1])[:k]]


def idle_gaps(evs: List[Event], lo: float, hi: float, k: int = 10) -> list:
    """The device's idle time in ``[lo, hi]`` by what the host was doing:
    each gap between busy intervals goes to the innermost host event that
    covers its middle ("host, outside any op" where none does: Python
    between ops); the ``k`` largest sums as ``[[name, seconds], ...]``."""
    dev = clip(union((e.start, e.end) for e in evs if e.on_device), lo, hi)
    edges = [lo] + [x for iv in dev for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = sorted((e for e in evs if not e.on_device),
                  key=lambda e: e.start)
    starts = [e.start for e in host]
    acc = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid) - 1
        label = "host, outside any op"
        for j in range(i, max(i - 256, -1), -1):
            if host[j].end >= mid:
                label = host[j].name
                break
        acc[label] += e - s
    return [[n, t] for n, t in sorted(acc.items(), key=lambda kv: -kv[1])[:k]]
