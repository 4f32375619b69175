"""The port's spans: where a control step's host time goes, layer by layer.

``with span("cmpc.admm.epoch"): ...`` records the body's start and end
with ``time.time_ns()`` while a ``torch.profiler`` session collects, and
does nothing else otherwise: one read of the profiler's flag, then a
shared null context. The records stay in memory; :func:`spans` returns
those of the current (or last) profiler session, each with the index of
its parent span and of its root, the outermost span open when it opened
(``cmpc.step`` on the fleet and racing steps, so every span of one control
step shares it). Nothing is written anywhere. Spans nest by the order they
open in, as the port's steps run on one thread.

The stamps are Unix-epoch nanoseconds, the clock of the profiler's own
events (``KinetoEvent.start_ns``), so a span can be laid beside the device's
busy intervals of the same trace. A span never enters the profiler's event
list, as a profiler range or an NVTX range would: the profiler mirrors
those on the device's timeline, where they would read as device work.

The port's counters are the kernel wrappers' ``.launches`` attributes
(``ops/cuda_lqr.py``, ``ops/cuda_sqp.py``); its spans are here.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, NamedTuple, Optional

import torch.autograd.profiler as _profiler


class Span(NamedTuple):
    """One recorded span. ``parent`` and ``root`` index the list that
    :func:`spans` returns (``root`` is the span's own index for an
    outermost span, ``parent`` then None); ``end_ns`` is None while the
    span is open."""
    name: str
    parent: Optional[int]
    root: int
    start_ns: int
    end_ns: Optional[int]


# [name, parent, root, start_ns, end_ns] of every span, in order of opening
_records: List[list] = []
_open: List[int] = []       # indexes of the open spans, innermost last
_NULL = contextlib.nullcontext()
_hooked = False


def _hook_session_start() -> None:
    """Empty the records whenever a profiler session starts, by wrapping
    the function the profiler calls as it starts (installed on the first
    span recorded, so importing this module changes nothing)."""
    global _hooked
    started = _profiler._run_on_profiler_start

    def run_on_profiler_start():
        _records.clear()
        _open.clear()
        started()

    _profiler._run_on_profiler_start = run_on_profiler_start
    _hooked = True


class _Recording:
    __slots__ = ("name", "index", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.index = i = len(_records)
        self.record = rec = [self.name, _open[-1] if _open else None,
                             _open[0] if _open else i, 0, None]
        _records.append(rec)
        _open.append(i)
        rec[3] = time.time_ns()

    def __exit__(self, *exc):
        self.record[4] = time.time_ns()
        if _open and _open[-1] == self.index:
            _open.pop()
        return False


def span(name: str):
    """A context manager that records ``name`` around its body while a
    profiler collects (a shared null context otherwise). The span closes
    with its end stamp when the body raises."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    if not _hooked:
        _hook_session_start()
    return _Recording(name)


def spans() -> List[Span]:
    """The spans recorded since the current profiler session began (after
    it stopped: that session's), in the order they opened."""
    return [Span(*r) for r in _records]
