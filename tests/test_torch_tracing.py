"""The port's spans (``utils/tracing.py``) on the CPU.

An N=8 LPV fleet step and an N=8 NL-OCD step, each run once without a
profiler and twice under a CPU ``torch.profiler``: the span tree of the
two timed step paths (names, parents, one root per step), the span counts
against the steps' own counts (ADMM epochs, SQP and OCD iterations), the
spans' stamps against the profiler's events on the same clock, no span in
the profiler's event list, and outputs bitwise equal with and without the
profiler. Then the recorder alone: nothing recorded without a profiler, a
span closed by an exception, a new session starting empty.
"""

import bisect

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from colaborativempc_tpu_torch import config as tcfg
from colaborativempc_tpu_torch.geometry import make_track
from colaborativempc_tpu_torch.ops.admm import default_epoch_len
from colaborativempc_tpu_torch.parallel import batch_fleet_state
from colaborativempc_tpu_torch.runtime import ocd as tocd
from colaborativempc_tpu_torch.runtime import simulate as tsim
from colaborativempc_tpu_torch.utils import tracing

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)

N = 8
SQP_ITERS = 2
# each span name and the names its parent may have
PARENTS = {
    "cmpc.step": {None},
    "cmpc.hold": {"cmpc.step"}, "cmpc.exchange": {"cmpc.step"},
    "cmpc.safety": {"cmpc.step"}, "cmpc.plant": {"cmpc.step"},
    "cmpc.ocd.sync": {"cmpc.step"}, "cmpc.ocd.iter": {"cmpc.step"},
    "cmpc.lpv.solve": {"cmpc.step"}, "cmpc.lpv.build": {"cmpc.lpv.solve"},
    "cmpc.nl.solve": {"cmpc.ocd.iter"},
    "cmpc.nl.sqp_iter": {"cmpc.nl.solve"},
    "cmpc.nl.build": {"cmpc.nl.sqp_iter"},
    "cmpc.admm.solve": {"cmpc.lpv.solve", "cmpc.nl.sqp_iter"},
    "cmpc.admm.epoch": {"cmpc.admm.solve"},
    "cmpc.admm.sync": {"cmpc.admm.solve", "cmpc.admm.epoch"},
}
NAMES = {
    "lpv": {"cmpc.step", "cmpc.hold", "cmpc.exchange", "cmpc.safety",
            "cmpc.plant", "cmpc.lpv.solve", "cmpc.lpv.build",
            "cmpc.admm.solve", "cmpc.admm.epoch", "cmpc.admm.sync"},
    "nl": {"cmpc.step", "cmpc.hold", "cmpc.safety", "cmpc.plant",
           "cmpc.ocd.sync", "cmpc.ocd.iter", "cmpc.nl.solve",
           "cmpc.nl.sqp_iter", "cmpc.nl.build", "cmpc.admm.solve",
           "cmpc.admm.epoch", "cmpc.admm.sync"},
}


def _system(family):
    """``(cfg, step, state)``: two fleets of three agents at N=8 on the
    CPU, their starts perturbed apart so the batch's problems stop at
    different epochs and iterations."""
    if family == "lpv":
        cfg = tcfg.ExperimentConfig(
            n_agents=3, N=N, dt=0.025, dtype="float64",
            gains=tcfg.lpv_gains(), solver=tcfg.SolverConfig(admm_iters=300))
        init, make = tsim.init_lpv_fleet, tsim.make_lpv_fleet_step
    else:
        cfg = tcfg.ExperimentConfig(
            n_agents=3, N=N, dt=0.02, dtype="float64",
            gains=tcfg.nl_gains(), ocd=tcfg.OCDConfig(max_it_ocd=4),
            solver=tcfg.SolverConfig(admm_iters=60, sqp_iters=SQP_ITERS))
        init, make = tocd.init_nl_fleet, tocd.make_nl_ocd_step
    track = make_track(cfg.map_type, device="cpu", dtype=torch.float64)
    state = batch_fleet_state(init(track, cfg, device="cpu"), 2,
                              device="cpu")
    pert = np.random.default_rng(3).normal(scale=0.05, size=(2, 3, 9))
    pert[..., 5:] = 0.0
    state = state._replace(x0=state.x0 + torch.as_tensor(pert))
    return cfg, make(track, cfg), state


def _flat(out):
    new_state, metrics = out
    return [t for rec in (new_state, metrics) for t in rec]


@pytest.fixture(scope="module", params=["lpv", "nl"])
def traced(request):
    """One step without a profiler, then two steps under one CPU profiler
    session: the outputs, the spans and the profiler's events."""
    cfg, step, state = _system(request.param)
    plain = step(state)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        first = step(state)
        second = step(first[0])
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()]
    return dict(family=request.param, cfg=cfg, plain=plain, first=first,
                second=second, spans=tracing.spans(), events=evs)


def _children(spans, i, name):
    return [k for k, s in enumerate(spans) if s.parent == i
            and s.name == name]


def test_span_tree_of_the_step(traced):
    spans = traced["spans"]
    assert {s.name for s in spans} == NAMES[traced["family"]]
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["cmpc.step", "cmpc.step"]
    for i, s in enumerate(spans):
        parent = None if s.parent is None else spans[s.parent].name
        assert parent in PARENTS[s.name], (s.name, parent)
        assert s.root in roots
        assert s.root == (i if s.parent is None else spans[s.parent].root)
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # the second step's spans all open after the first step closed
    first, second = roots
    assert all(s.start_ns > spans[first].end_ns
               for s in spans if s.root == second)


def test_epoch_spans_count_the_epochs_run(traced):
    """``cmpc.admm.epoch`` spans per solve: the epochs ``admm_solve`` ran,
    for LPV the batch's most ADMM iterations over the epoch length."""
    spans, cfg = traced["spans"], traced["cfg"]
    el = cfg.solver.epoch_len or default_epoch_len(N)
    solves = [i for i, s in enumerate(spans) if s.name == "cmpc.admm.solve"]
    assert solves
    for i in solves:
        epochs = len(_children(spans, i, "cmpc.admm.epoch"))
        syncs = [k for k, s in enumerate(spans) if s.name == "cmpc.admm.sync"
                 and spans[s.parent].name in ("cmpc.admm.solve",
                                              "cmpc.admm.epoch")
                 and (s.parent == i or spans[s.parent].parent == i)]
        n_epochs = cfg.solver.admm_budget() // el
        # one sync before the first epoch, one after each epoch but the
        # last of the budget
        assert len(syncs) == epochs + (epochs < n_epochs)
        assert 1 <= epochs <= n_epochs
    if traced["family"] == "lpv":
        for out, root in zip((traced["first"], traced["second"]),
                             [i for i, s in enumerate(spans)
                              if s.parent is None]):
            solve = [i for i in solves if spans[i].root == root]
            assert len(solve) == 1
            ran = int(out[1].iterations.max()) // el
            assert len(_children(spans, solve[0], "cmpc.admm.epoch")) == ran


def test_sqp_and_ocd_spans_count_the_iterations(traced):
    spans = traced["spans"]
    if traced["family"] == "lpv":
        assert not any(s.name.startswith(("cmpc.nl.", "cmpc.ocd."))
                       for s in spans)
        return
    for i, s in enumerate(spans):
        if s.name == "cmpc.nl.solve":
            assert len(_children(spans, i, "cmpc.nl.sqp_iter")) == SQP_ITERS
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    for out, root in zip((traced["first"], traced["second"]), roots):
        iters = int(out[1].ocd_iterations.max())
        assert len(_children(spans, root, "cmpc.ocd.iter")) == iters
        # one host check before each iteration and the one that ends it
        assert len(_children(spans, root, "cmpc.ocd.sync")) == iters + 1


def test_spans_bracket_the_profiler_events_inside_them(traced):
    """Spans and the profiler's events share a clock: every event lies
    inside a span or apart from it, and each build span holds events."""
    evs = sorted((s, e) for name, s, e in traced["events"])
    starts = [s for s, _ in evs]
    ends_before = [0]
    for _, e in evs:
        ends_before.append(max(ends_before[-1], e))
    for sp in traced["spans"]:
        lo = bisect.bisect_left(starts, sp.start_ns)
        hi = bisect.bisect_right(starts, sp.end_ns)
        assert ends_before[lo] <= sp.start_ns, sp.name
        assert all(e <= sp.end_ns for _, e in evs[lo:hi]), sp.name
        if sp.name in ("cmpc.lpv.build", "cmpc.nl.build"):
            assert hi > lo


def test_no_profiler_event_is_a_span(traced):
    names = {n for n, _, _ in traced["events"]}
    assert names and not any(n.startswith("cmpc.") for n in names)


def test_outputs_bitwise_equal_with_and_without_profiler(traced):
    for a, b in zip(_flat(traced["plain"]), _flat(traced["first"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.numpy(), b.numpy(), equal_nan=True)


def test_nothing_is_recorded_without_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert tracing.spans() == []
    assert tracing.span("cmpc.a") is tracing.span("cmpc.b")
    with tracing.span("cmpc.step"):
        with tracing.span("cmpc.hold"):
            pass
    _, step, state = _system("lpv")
    step(state)
    assert tracing.spans() == []


def test_a_span_closes_when_its_body_raises():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with tracing.span("cmpc.step"):
                with tracing.span("cmpc.hold"):
                    raise ValueError("in the body")
        with tracing.span("cmpc.plant"):
            pass
    step, hold, plant = tracing.spans()
    assert (step.name, hold.name, plant.name) == ("cmpc.step", "cmpc.hold",
                                                   "cmpc.plant")
    assert hold.parent == 0 and hold.root == 0
    assert step.start_ns <= hold.start_ns <= hold.end_ns <= step.end_ns
    # the raise closed both: the next span is a root of its own
    assert plant.parent is None and plant.root == 2
    assert plant.start_ns >= step.end_ns


def test_a_second_profiler_session_starts_empty():
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("cmpc.step"):
            pass
    assert [s.name for s in tracing.spans()] == ["cmpc.step"]
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.spans() == []
        with tracing.span("cmpc.plant"):
            pass
    assert [(s.name, s.parent, s.root) for s in tracing.spans()] == [
        ("cmpc.plant", None, 0)]


# the racing step (runtime/racing.py, planners/mpcc.py): each span name and
# the name its parent has
RACE_PARENTS = {
    "cmpc.step": None, "cmpc.guess": "cmpc.step", "cmpc.plant": "cmpc.step",
    "cmpc.mpcc.solve": "cmpc.step", "cmpc.mpcc.sqp_iter": "cmpc.mpcc.solve",
    "cmpc.mpcc.build": "cmpc.mpcc.sqp_iter",
    "cmpc.admm.solve": "cmpc.mpcc.sqp_iter",
    "cmpc.admm.epoch": "cmpc.admm.solve",
}


def _race_system():
    """``(cfg, step, state)``: two races at N=8 on the CPU, their speeds
    perturbed apart; the first step cold-starts."""
    from colaborativempc_tpu_torch.planners.mpcc import MPCCConfig
    from colaborativempc_tpu_torch.runtime import racing
    cfg = MPCCConfig(N=N, dt=0.02, n_sqp=SQP_ITERS, sqp_mixing=0.8,
                     epoch_len=15, assoc=False)
    track = make_track(cfg.map_type, device="cpu", dtype=torch.float64)
    state = racing.init_mpcc(track, cfg, races=2, dtype=torch.float64,
                             device="cpu")
    state = state._replace(x=state.x + torch.tensor(
        [[0.0] * 9, [0.002, 0.001] + [0.0] * 7], dtype=torch.float64))
    return cfg, racing.make_mpcc_step(track, cfg), state


@pytest.fixture(scope="module")
def race_traced():
    """A racing step without a profiler, two under one CPU profiler
    session, then one more without: the outputs and the spans."""
    cfg, step, state = _race_system()
    plain = step(state)
    with profile(activities=[ProfilerActivity.CPU]):
        first = step(state)
        second = step(first[0])
    spans = tracing.spans()
    step(second[0])
    return dict(cfg=cfg, plain=plain, first=first, second=second,
                spans=spans, after=tracing.spans())


def test_racing_step_span_tree(race_traced):
    spans = race_traced["spans"]
    assert {s.name for s in spans} == set(RACE_PARENTS) | {"cmpc.admm.sync"}
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["cmpc.step", "cmpc.step"]
    for s in spans:
        parent = None if s.parent is None else spans[s.parent]
        if s.name == "cmpc.admm.sync":
            assert parent.name in ("cmpc.admm.solve", "cmpc.admm.epoch")
        else:
            assert (parent and parent.name) == RACE_PARENTS[s.name], s.name
        if parent is not None:
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    for root in roots:
        kids = [spans[k].name for k, s in enumerate(spans)
                if s.parent == root]
        # the guesses, one SQP solve, then the plant, in that order
        assert kids == ["cmpc.guess", "cmpc.mpcc.solve", "cmpc.plant"]
    for i, s in enumerate(spans):
        if s.name == "cmpc.mpcc.solve":
            iters = _children(spans, i, "cmpc.mpcc.sqp_iter")
            assert len(iters) == SQP_ITERS
            for k in iters:
                assert len(_children(spans, k, "cmpc.mpcc.build")) == 1
                assert len(_children(spans, k, "cmpc.admm.solve")) == 1


def test_racing_epoch_spans_count_the_admm_iterations(race_traced):
    """A step's epochs, 15 iterations each, cover the ADMM iterations of
    each of its races (summed over the SQP iterations): each SQP
    iteration's solve runs the epochs of its slowest race."""
    spans = race_traced["spans"]
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    for out, root in zip((race_traced["first"], race_traced["second"]),
                         roots):
        epochs = sum(1 for s in spans
                     if s.name == "cmpc.admm.epoch" and s.root == root)
        assert epochs * 15 >= int(out[1].iterations.max())
        assert epochs >= SQP_ITERS


def test_racing_step_records_only_under_a_profiler(race_traced):
    assert race_traced["after"] == race_traced["spans"]
    for a, b in zip(_flat(race_traced["plain"]),
                    _flat(race_traced["first"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.numpy(), b.numpy(), equal_nan=True)
