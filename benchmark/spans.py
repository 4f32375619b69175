"""What the program's own spans say about a traced run: the device's idle
time split by the layer the host was in, and the host's cost of one ADMM
epoch.

The program records its spans (``colaborativempc_tpu_torch/utils/
tracing.py``) on the profiler's clock while the profiler collects, and
keeps them out of the profiler's event list; this module reads them from
the loaded module, as ``harness.counters`` reads the launch counters, and
lays them beside ``run.trace``. Every reader returns None where the run
has no spans (a program without them, no trace) or no device time.
"""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from typing import List, NamedTuple, Optional

from benchmark import readers
from benchmark import trace as tl

TRACING = "colaborativempc_tpu_torch.utils.tracing"
OUTSIDE = "outside the program"
# the layer of a span is read from its name, cmpc.<part>.*: the rest
# (cmpc.step, .exchange, .hold, .safety, .plant) is the rollout's
LAYER_OF_PART = {"admm": "admm", "ocd": "ocd", "lpv": "planner",
                 "nl": "planner"}


class Span(NamedTuple):
    """A program span: ``parent`` indexes the list it is in; the stamps
    are Unix-epoch ns, the profiler's clock (``end_ns`` inf while open)."""
    name: str
    parent: Optional[int]
    start_ns: float
    end_ns: float

    @property
    def start(self) -> float:
        return self.start_ns * 1e-9

    @property
    def end(self) -> float:
        return self.end_ns * 1e-9


def layer(name: str) -> str:
    """The layer a span's own time is charged to: ``admm``, ``ocd``,
    ``planner`` or ``rollout``."""
    parts = name.split(".")
    return LAYER_OF_PART.get(parts[1] if len(parts) > 2 else "", "rollout")


def program_spans(run) -> Optional[List[Span]]:
    """The program's spans where the run was traced with device time and
    the program recorded any; else None."""
    mod = sys.modules.get(TRACING)
    if mod is None or readers.device_idle_pct(run) is None:
        return None
    out = [Span(s.name, s.parent, s.start_ns,
                float("inf") if s.end_ns is None else s.end_ns)
           for s in mod.spans()]
    return out or None


def innermost(spans: List[Span], lo: float, hi: float) -> list:
    """``[(start, end, index)]``: the pieces of ``[lo, hi]`` in which span
    ``index`` is the innermost open span, in time order (pieces no span
    covers are left out). Spans nest as a stack: the one opened last and
    not yet closed is the innermost."""
    depth = []
    for s in spans:
        depth.append(0 if s.parent is None else depth[s.parent] + 1)
    edges = []
    for i, s in enumerate(spans):
        a, b = max(s.start, lo), min(s.end, hi)
        if b > a:
            # at one instant: ends before starts, inner ends first, outer
            # starts first
            edges.append((b, 0, -depth[i], i))
            edges.append((a, 1, depth[i], i))
    edges.sort()
    pieces, stack, t = [], [], lo
    for x, opens, _, i in edges:
        if stack and x > t:
            pieces.append((t, x, stack[-1]))
        t = max(t, x)
        if opens:
            stack.append(i)
        elif stack and stack[-1] == i:
            stack.pop()
        else:
            stack.remove(i)
    return pieces


def idle_intervals(evs, lo: float, hi: float) -> list:
    """The device's idle intervals in ``[lo, hi]``: the complement of the
    union that ``trace.busy_seconds`` sums."""
    dev = tl.clip(tl.union((e.start, e.end) for e in evs if e.on_device),
                  lo, hi)
    edges = [lo] + [x for iv in dev for x in iv] + [hi]
    return [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]


def _idle_before(idle: list, cum: list, starts: list, t: float) -> float:
    """Idle seconds of ``idle`` before ``t``."""
    k = bisect.bisect_right(starts, t) - 1
    if k < 0:
        return 0.0
    s, e = idle[k]
    return cum[k] + min(t, e) - s


def idle_split(spans: List[Span], evs, lo: float, hi: float) -> dict:
    """Idle seconds of ``[lo, hi]`` by the layer whose own time the host
    was in (``admm``, ``ocd``, ``planner``, ``rollout``), and
    :data:`OUTSIDE` where no program span was open. Each idle interval is
    cut exactly at the spans' edges, so the values sum to the window's idle
    time."""
    idle = idle_intervals(evs, lo, hi)
    starts = [s for s, _ in idle]
    cum = [0.0]
    for s, e in idle:
        cum.append(cum[-1] + e - s)

    def idle_in(a, b):
        return (_idle_before(idle, cum, starts, b)
                - _idle_before(idle, cum, starts, a))

    out = defaultdict(float)
    t = lo
    for a, b, i in innermost(spans, lo, hi):
        out[OUTSIDE] += idle_in(t, a)
        out[layer(spans[i].name)] += idle_in(a, b)
        t = b
    out[OUTSIDE] += idle_in(t, hi)
    return dict(out)


def idle_pct(run, name: str):
    """Share of the traced window in which the device was idle while the
    host was in layer ``name``'s own time, %; None where the window has no
    span of that layer. Notes the share outside the program and the sum
    of the split against ``device_idle_pct``."""
    spans = program_spans(run)
    if spans is None or not any(layer(s.name) == name for s in spans):
        return None
    t = run.trace
    pct = {k: 100.0 * v / t.window_s
           for k, v in idle_split(spans, t.events, t.lo, t.hi).items()}
    run.note(f"idle_{name}_pct {pct.get(name, 0.0):.4f}; {OUTSIDE} "
             f"{pct[OUTSIDE]:.4f}; the split sums to "
             f"{sum(pct.values()):.4f}, device_idle_pct "
             f"{readers.device_idle_pct(run):.4f}")
    return pct.get(name, 0.0)


def epoch_host_us(spans: List[Span], lo: float, hi: float):
    """Mean over the ``cmpc.admm.epoch`` spans inside ``[lo, hi]`` of the
    span's time less its ``cmpc.admm.sync`` children's, us; None where
    there is none."""
    sync = defaultdict(float)
    for s in spans:
        if s.name == "cmpc.admm.sync" and s.parent is not None:
            sync[s.parent] += s.end_ns - s.start_ns
    own = [s.end_ns - s.start_ns - sync[i] for i, s in enumerate(spans)
           if s.name == "cmpc.admm.epoch" and s.start >= lo and s.end <= hi]
    if not own:
        return None
    return 1e-3 * sum(own) / len(own)


def admm_host_us_per_epoch(run):
    """The host's time in one ADMM epoch outside its sync (the rescale,
    the selects and the two launches), mean over the traced window, us."""
    spans = program_spans(run)
    if spans is None:
        return None
    return epoch_host_us(spans, run.trace.lo, run.trace.hi)
