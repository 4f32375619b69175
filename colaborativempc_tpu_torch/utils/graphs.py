"""Replay a fixed-shape stretch of torch ops as one CUDA graph.

The racing step's own ops (re-projection, both guesses, failure
bookkeeping, the RK4 plant) and the LPV fleet step's (hold ladder,
exchange, safety filter, plant) are hundreds to thousands of tiny kernels
on a small batch; the host pays a dispatch and a launch for each, so the
step's time follows the host's speed rather than the card's. :class:`graphed`
records such a function once per layout of its tensor arguments as a CUDA
graph and replays it: the host copies the inputs in and launches one
graph. The replay runs the same kernels on the same data, so its results
are the function's bit for bit.

The function takes and returns tensors only (a tuple), reads nothing from
the host while it runs (no ``float(t)``, no tensor built from Python data
on the card) and makes no host read. On CPU tensors it runs as it is.
:func:`record` is the capture both this and ``ops/admm.py _EpochGraph``
(the ADMM loop's epochs, state kept in place across replays) use.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def record(fn: Callable, device: torch.device):
    """Capture ``fn()`` on ``device`` as a CUDA graph, which runs nothing
    until replayed; returns the graph and what ``fn`` returned (its
    tensors live in the graph's pool and are rewritten by each replay).
    Whatever ``fn`` loads lazily must have run once before."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.graph(graph):
        out = fn()
    return graph, out


class graphed:
    """``graphed(fn)(*tensors)``: ``fn(*tensors)``, replayed from a CUDA
    graph on CUDA tensors. The first call with a new layout (shapes,
    dtypes, device) runs ``fn`` once outside the graph, for lazy
    initialisation, then records it. The tensors returned on the card are
    the graph's own buffers: they hold until the next call, so a caller
    that keeps one longer clones it. ``counter``, when given, is an object
    whose ``graph_records`` and ``graph_replays`` each recording and each
    replay advance by one."""

    def __init__(self, fn: Callable[..., Tuple[torch.Tensor, ...]],
                 counter=None):
        self.fn = fn
        self.counter = counter
        self._graphs = {}

    def __call__(self, *args: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if not args[0].is_cuda:
            return self.fn(*args)
        key = tuple((a.shape, a.dtype, a.device) for a in args)
        rec = self._graphs.get(key)
        if rec is None:
            rec = self._graphs[key] = self._record(args)
        graph, inputs, outputs = rec
        for dst, src in zip(inputs, args):
            dst.copy_(src)
        graph.replay()
        if self.counter is not None:
            self.counter.graph_replays += 1
        return outputs

    def _record(self, args):
        dev = args[0].device
        with torch.cuda.device(dev):
            inputs = tuple(a.clone() for a in args)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.fn(*inputs)
            torch.cuda.current_stream().wait_stream(side)
        graph, outputs = record(lambda: self.fn(*inputs), dev)
        if self.counter is not None:
            self.counter.graph_records += 1
        return graph, inputs, tuple(outputs)
