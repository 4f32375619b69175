"""The split of the device's idle time by the program's spans
(``benchmark/spans.py``), on made-up spans and device intervals: the
innermost span wins, a gap is cut at a span's edge, the shares and the
time outside the program sum to the idle share, an epoch's host time
leaves out its sync; every reader reads nothing where there is nothing to
read; the new metric files load by name."""

import json
import sys
from types import SimpleNamespace

import pytest

from benchmark import harness, readers, spans as sp, trace as tl
from benchmark.tests.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = [f"idle_{layer}_pct.{cell}" for layer in ("admm", "planner", "rollout")
       for cell in ("lpv_mc", "nl_mc", "fleet1")] + [
    "idle_ocd_pct.nl_mc"] + [
    f"admm_host_us_per_epoch.{cell}" for cell in ("lpv_mc", "nl_mc", "fleet1")]
S = 1_000_000_000      # ns a second


def rec(name, parent, root, start, end):
    """A record as ``utils/tracing.py spans()`` gives it, stamps in s."""
    return SimpleNamespace(name=name, parent=parent, root=root,
                           start_ns=int(start * S),
                           end_ns=None if end is None else int(end * S))


# a step [0, 10]: ADMM solve [1, 6] holding an epoch [2, 5] and its sync
# [3, 4]; the plant [7, 9]; outside the program [10, 12]
RECORDS = [rec("cmpc.step", None, 0, 0.0, 10.0),
           rec("cmpc.admm.solve", 0, 0, 1.0, 6.0),
           rec("cmpc.admm.epoch", 1, 0, 2.0, 5.0),
           rec("cmpc.admm.sync", 2, 0, 3.0, 4.0),
           rec("cmpc.plant", 0, 0, 7.0, 9.0)]
# busy [0.5, 1.5], [3.5, 3.75], [8, 11]: idle [0, 0.5], [1.5, 3.5],
# [3.75, 8], [11, 12]
EVENTS = [tl.Event("k", True, 0.5, 1.5), tl.Event("k", True, 3.5, 3.75),
          tl.Event("k", True, 8.0, 11.0),
          tl.Event("aten::add", False, 0.2, 0.3)]


def _run(records, events=EVENTS, lo=0.0, hi=12.0, monkeypatch=None):
    if monkeypatch is not None:
        monkeypatch.setitem(sys.modules, sp.TRACING,
                            SimpleNamespace(spans=lambda: list(records)))
    run = SimpleNamespace(trace=SimpleNamespace(events=events, lo=lo, hi=hi,
                                                window_s=hi - lo), notes=[])
    run.note = run.notes.append
    return run


def _spans(records):
    return [sp.Span(r.name, r.parent, r.start_ns, r.end_ns) for r in records]


def test_the_innermost_span_wins():
    pieces = sp.innermost(_spans(RECORDS), 0.0, 12.0)
    names = [(a, b, RECORDS[i].name) for a, b, i in pieces]
    assert names == [(0.0, 1.0, "cmpc.step"), (1.0, 2.0, "cmpc.admm.solve"),
                     (2.0, 3.0, "cmpc.admm.epoch"),
                     (3.0, 4.0, "cmpc.admm.sync"),
                     (4.0, 5.0, "cmpc.admm.epoch"),
                     (5.0, 6.0, "cmpc.admm.solve"), (6.0, 7.0, "cmpc.step"),
                     (7.0, 9.0, "cmpc.plant"), (9.0, 10.0, "cmpc.step")]
    # at one instant a child opens after, and closes before, its parent
    flush = [rec("cmpc.step", None, 0, 0.0, 2.0),
             rec("cmpc.hold", 0, 0, 0.0, 1.0),
             rec("cmpc.plant", 0, 0, 1.0, 2.0)]
    assert [(a, b, i) for a, b, i in sp.innermost(_spans(flush), 0, 3)] == [
        (0.0, 1.0, 1), (1.0, 2.0, 2)]


def test_a_gap_that_crosses_a_span_edge_is_cut_there():
    split = sp.idle_split(_spans(RECORDS), EVENTS, 0.0, 12.0)
    # [0, 0.5] step; [1.5, 3.5]: solve 0.5, epoch 1, sync 0.5; [3.75, 8]:
    # sync 0.25, epoch 1, solve 1, step 1, plant 1; [11, 12] outside
    assert split["rollout"] == pytest.approx(0.5 + 1.0 + 1.0)
    assert split["admm"] == pytest.approx(0.5 + 1.0 + 0.5 + 0.25 + 1.0 + 1.0)
    assert split[sp.OUTSIDE] == pytest.approx(1.0)
    assert set(split) == {"rollout", "admm", sp.OUTSIDE}
    assert sp.layer("cmpc.nl.sqp_iter") == "planner"
    assert sp.layer("cmpc.lpv.build") == "planner"
    assert sp.layer("cmpc.ocd.sync") == "ocd"
    assert sp.layer("cmpc.exchange") == "rollout"


def test_the_shares_and_outside_sum_to_the_idle_share(monkeypatch):
    # spans cut by the window: the step opens before lo, the plant ends
    # after hi
    run = _run(RECORDS, lo=0.5, hi=8.5, monkeypatch=monkeypatch)
    idle = readers.device_idle_pct(run)
    got = {k: sp.idle_pct(run, k) for k in ("admm", "planner", "rollout",
                                            "ocd")}
    assert got["planner"] is None and got["ocd"] is None
    split = sp.idle_split(sp.program_spans(run), EVENTS, 0.5, 8.5)
    assert 100.0 * sum(split.values()) / 8.0 == pytest.approx(idle)
    assert split[sp.OUTSIDE] == 0.0
    assert got["admm"] + got["rollout"] == pytest.approx(idle)
    assert len(run.notes) == 2 and "device_idle_pct" in run.notes[0]
    # the harness's own bookkeeping between steps is outside the program
    run = _run(RECORDS, monkeypatch=monkeypatch)
    split = sp.idle_split(sp.program_spans(run), EVENTS, 0.0, 12.0)
    assert sum(split.values()) == pytest.approx(
        readers.device_idle_pct(run) * 12.0 / 100.0)


def test_the_epoch_time_leaves_out_its_sync(monkeypatch):
    run = _run(RECORDS, monkeypatch=monkeypatch)
    # the epoch [2, 5] less its sync [3, 4]
    assert sp.admm_host_us_per_epoch(run) == pytest.approx(2e6)
    two = RECORDS + [rec("cmpc.admm.epoch", 1, 0, 5.0, 5.5)]
    run = _run(two, monkeypatch=monkeypatch)
    assert sp.admm_host_us_per_epoch(run) == pytest.approx(1.25e6)
    # an epoch that runs past the window is not counted
    run = _run(two, hi=5.2, monkeypatch=monkeypatch)
    assert sp.admm_host_us_per_epoch(run) == pytest.approx(2e6)


@pytest.mark.parametrize("name", NEW)
def test_every_reader_reads_nothing_without_spans(monkeypatch, name):
    read = harness.load_reader(name)
    assert read(SimpleNamespace(trace=None)) is None
    monkeypatch.delitem(sys.modules, sp.TRACING, raising=False)
    assert read(_run(RECORDS)) is None
    assert read(_run([], monkeypatch=monkeypatch)) is None
    # spans but no device time: a CPU run
    host_only = [e for e in EVENTS if not e.on_device]
    assert read(_run(RECORDS, events=host_only,
                     monkeypatch=monkeypatch)) is None
    value = read(_run(RECORDS, monkeypatch=monkeypatch))
    if "ocd" in name or "planner" in name:
        assert value is None          # no span of the layer
    else:
        assert value > 0


def test_the_new_entries_load_by_name():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    assert [m["name"] for m in SPEC["per_layer"][-len(NEW):]] == NEW
    cells = {"lpv_mc": ("lpv-n125-mc64", "lpv_solves_per_s"),
             "nl_mc": ("nl-n20-mc64", "nl_fleet_steps_per_s"),
             "fleet1": ("lpv-n125-fleet1", "step_ms_p95")}
    for name in NEW:
        m = entries[name]
        cell, moves = cells[name.rsplit(".", 1)[1]]
        assert m["workloads"] == [cell] and m["moves"] == moves
        assert m["source"] == "program_span" and m["better"] == "lower"
        assert m["unit"] == ("us" if name.startswith("admm_host") else "%")
        assert callable(harness.load_reader(name))
        assert name in [e["name"] for e in harness.cell_metrics(SPEC, cell,
                                                                True)]
