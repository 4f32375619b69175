"""The racing cell through the benchmark's harness on the CPU: the racing
family (``benchmark/families/mpcc.py``) runs a course cell's warm-up,
window and check at N=8 and comes out correct with an exact start; its
course ends where its laps say; the racing split of the device's idle time
(``benchmark/racing.py``) on made-up spans and device intervals charges
the SQP loop to the planner and sums to the idle time; the MPCC build's
counts (``benchmark/roofline/mpcc.py``) are the port's; every new metric
file loads by name and reads nothing where a run has nothing to read."""

import json
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, racing, readers, systems  # noqa: E402
from benchmark import spans as sp  # noqa: E402
from benchmark import trace as tl  # noqa: E402
from benchmark.roofline import mpcc as rl_mpcc  # noqa: E402

BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "mpcc-n60-race1"
RACE1 = [m["name"] for m in SPEC["per_layer"]
         if m.get("workloads") == [CELL]]
S = 1_000_000_000      # ns a second


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny_bench(tmp: Path, laps: int = 0) -> tuple:
    """A benchmark directory under ``tmp`` with the real metric and family
    files and the racing configuration cut to N=8 and 6-step courses, one
    course cell (``tiny-mpcc-f1``: one car, no noise) whose check runs 3
    samples on the CPU; ``(directory, spec)`` with every metric reported
    by the cell."""
    bench = tmp / "bench"
    for d in ("metrics", "families"):
        shutil.copytree(BENCH / d, bench / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for d in ("configs", "traffic", "workloads"):
        (bench / d).mkdir(parents=True)
    conf = json.loads((BENCH / "configs" / "mpcc-race-oval-n60.json")
                      .read_text())
    conf["name"] = "tiny-mpcc"
    conf["mpcc"].update(N=8, n_sim=6, laps=laps)
    (bench / "configs" / "tiny-mpcc.json").write_text(json.dumps(conf))
    shutil.copy(BENCH / "traffic" / "fleet1.json", bench / "traffic")
    # the port's CPU float32 path reads 3.5e-8 / 3.2e-7 here (bit for bit
    # the copy in float32; these are float64's distance), the control
    # (every product in TF32) far more
    (bench / "workloads" / "tiny-mpcc-f1.json").write_text(json.dumps(
        {"name": "tiny-mpcc-f1", "config": "tiny-mpcc", "traffic": "fleet1",
         "why": "test", "warm_steps": 1, "trace_seconds": 0.3,
         "check": {"samples": 3, "device": "cpu",
                   "limits": {"start_gap": 0.0, "x0_gap": 1e-5,
                              "plan_gap": 1e-4}}}))
    spec = json.loads(json.dumps(SPEC))
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    return bench, spec


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_a_racing_course_cell_runs_correct_through_the_harness(tmp_path,
                                                                trace):
    bench, spec = _tiny_bench(tmp_path)
    cell = harness.load_cell("tiny-mpcc-f1", bench)
    system = systems.program(cell.conf, "cpu", bench)
    assert (system.n_agents, system.max_steps) == (1, 6)
    res = harness.execute(cell, 2 ** 32 + 17, 1.0, trace, system, spec,
                          bench)
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["start_gap"]["value"] == 0.0
    assert set(res["checks"]) == {"start_gap", "x0_gap", "plan_gap"}
    steps = res["_context"]["steps"]
    assert steps >= 1 and res["attempted"] == steps
    got = res["metrics"]
    if trace:
        # no device time on the CPU: only the step's own count reads
        assert set(got) == {"admm_iters_per_step.race1"}
        # a mean over the window's steps of whole epochs of 15 iterations
        total = got["admm_iters_per_step.race1"]["value"] * steps
        assert abs(total - round(total)) < 1e-6 and round(total) % 15 == 0
    else:
        assert got["step_ms_p95"]["value"] >= got["step_ms_p50"]["value"]


def test_a_course_ends_on_its_laps_only(tmp_path):
    for laps, want in ((0, False), (1, True)):
        bench, _ = _tiny_bench(tmp_path / str(laps), laps)
        conf = harness.load_cell("tiny-mpcc-f1", bench).conf
        system = systems.program(conf, "cpu", bench)
        state = system.start(1, torch.zeros((1, 1, 9)).numpy())
        assert not system.course_ended(state)
        past = state.x.clone()
        past[:, 6] = system.track.track_length[0] + 0.1
        assert system.course_ended(state._replace(x=past)) is want


def _rec(name, parent, start, end):
    return sp.Span(name, parent, start * S, end * S)


# a racing step [0, 10]: the guesses [0, 1], the SQP loop [1, 6] (its
# build [1, 2], the ADMM solve [2, 5] with an epoch [2, 4] and its sync
# [3, 4]), the plant [7, 9]; outside the program [10, 12]
SPANS = [_rec("cmpc.step", None, 0.0, 10.0),
         _rec("cmpc.guess", 0, 0.0, 1.0),
         _rec("cmpc.mpcc.solve", 0, 1.0, 6.0),
         _rec("cmpc.mpcc.sqp_iter", 2, 1.0, 6.0),
         _rec("cmpc.mpcc.build", 3, 1.0, 2.0),
         _rec("cmpc.admm.solve", 3, 2.0, 5.0),
         _rec("cmpc.admm.epoch", 5, 2.0, 4.0),
         _rec("cmpc.admm.sync", 6, 3.0, 4.0),
         _rec("cmpc.plant", 0, 7.0, 9.0)]
# busy [0.5, 1.5], [3.5, 3.75], [8, 11]: idle [0, 0.5], [1.5, 3.5],
# [3.75, 8], [11, 12]
EVENTS = [tl.Event("k", True, 0.5, 1.5), tl.Event("k", True, 3.5, 3.75),
          tl.Event("k", True, 8.0, 11.0),
          tl.Event("aten::add", False, 0.2, 0.3)]


def test_the_racing_split_charges_the_sqp_loop_to_the_planner():
    split = racing.idle_split(SPANS, EVENTS, 0.0, 12.0)
    # [0, 0.5] guess; [1.5, 3.5]: build 0.5, epoch 1, sync 0.5; [3.75, 8]:
    # sync 0.25, ADMM solve 1, SQP iteration 1, step 1 and plant 1;
    # [11, 12] outside
    want = {"rollout": 0.5 + 1.0 + 1.0, "planner": 0.5 + 1.0,
            "admm": 1.0 + 0.5 + 0.25 + 1.0, sp.OUTSIDE: 1.0}
    assert split.keys() == want.keys()
    for k, v in want.items():
        assert split[k] == pytest.approx(v, abs=1e-12)
    idle = 12.0 - tl.busy_seconds(EVENTS, 0.0, 12.0)
    assert sum(split.values()) == pytest.approx(idle, abs=1e-12)
    # the fleets' split charges the same planner time to the rollout
    fleets = sp.idle_split(SPANS, EVENTS, 0.0, 12.0)
    assert "planner" not in fleets
    assert fleets["rollout"] == pytest.approx(want["rollout"]
                                              + want["planner"])


def test_the_racing_shares_sum_to_device_idle_pct(monkeypatch):
    records = [SimpleNamespace(name=s.name, parent=s.parent, root=0,
                               start_ns=int(s.start_ns), end_ns=int(s.end_ns))
               for s in SPANS]
    monkeypatch.setitem(sys.modules, sp.TRACING,
                        SimpleNamespace(spans=lambda: records))
    run = SimpleNamespace(trace=SimpleNamespace(events=EVENTS, lo=0.0,
                                                hi=12.0, window_s=12.0),
                          notes=[])
    run.note = run.notes.append
    got = {k: racing.idle_pct(run, k) for k in ("planner", "admm",
                                               "rollout")}
    outside = 100.0 / 12.0
    assert sum(got.values()) + outside == pytest.approx(
        readers.device_idle_pct(run), abs=1e-9)
    assert got["planner"] == pytest.approx(100.0 * 1.5 / 12.0)
    assert all("the split sums to" in n for n in run.notes)
    # a run whose program recorded no racing planner span reads nothing
    fleet_like = [SimpleNamespace(name=n, parent=p, root=0,
                                  start_ns=a * S, end_ns=b * S)
                  for n, p, a, b in (("cmpc.step", None, 0, 10),
                                     ("cmpc.admm.solve", 0, 2, 5),
                                     ("cmpc.admm.epoch", 1, 2, 4))]
    monkeypatch.setitem(sys.modules, sp.TRACING,
                        SimpleNamespace(spans=lambda: fleet_like))
    assert racing.idle_pct(run, "planner") is None
    assert racing.idle_pct(run, "admm") is not None


@pytest.mark.parametrize("shape", [(1, 60, 1, 6), (18, 20, 2, 40)])
def test_the_build_counts_are_the_ports(shape):
    from colaborativempc_tpu_torch.ops import cuda_sqp
    assert rl_mpcc.build_counts(*shape) == cuda_sqp.mpcc_traffic(*shape)


def test_the_cell_is_declared_as_the_files_say():
    w = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    entry = [c for c in SPEC["workloads"] if c["name"] == CELL]
    assert entry and entry[0]["config"] == w["config"] == "mpcc-race-oval-n60"
    assert entry[0]["traffic"] == w["traffic"] == "fleet1"
    assert entry[0]["chips"] == 1
    conf = harness.load_cell(CELL).conf
    assert conf["family"] == "mpcc" and conf["reduced"] == []
    assert conf["mpcc"]["N"] == 60
    assert [m["name"] for m in harness.cell_metrics(SPEC, CELL, False)] == [
        "step_ms_p95", "step_ms_p50", "setup_s"]
    assert len(RACE1) == 9 and all(m.endswith(".race1") for m in RACE1)


@pytest.mark.parametrize("name", RACE1)
def test_each_racing_metric_reads_nothing_from_an_empty_run(name):
    # a run without a trace, spans or launches: what the parent program
    # gives where it lacks what the racing cell reads
    conf = harness.load_cell(CELL).conf
    run = SimpleNamespace(trace=None, counters={}, steps=0, notes=[],
                          conf=conf, fleets=1, system=SimpleNamespace(
                              family=systems.load_family(conf["family"])))
    run.note = run.notes.append
    assert harness.load_reader(name)(run) is None
