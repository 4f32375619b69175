"""The harness on the CPU: files found by name, the result's keys, the
window's arithmetic, the trace's intervals, the frozen work counts and the
import guard. Card-only cases are marked ``cuda`` and skip here."""

import ast
import importlib.util
import json
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import pytest
import torch

from benchmark import harness, readers, roofline as rl, systems, trace as tl
from benchmark.tests.conftest import BENCH, ROOT, tiny_bench

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_every_config_cell_and_metric_loads_by_name():
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.workload["config"] == w["config"]
        assert cell.workload["traffic"] == w["traffic"]
        assert cell.workload["why"] == w["why"]
        assert cell.conf["name"] == w["config"]
        assert set(cell.workload["check"]["limits"]) >= {
            "start_gap", "x0_gap"}
        assert cell.workload["check"]["limits"]["start_gap"] == 0
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
        family = systems.load_family(conf["family"])
        for pkg in (family.PROGRAM, family.REFERENCE):
            family.config(pkg, conf, conf["dtype"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
    for w in SPEC["workloads"]:
        for trace in (False, True):
            assert harness.cell_metrics(SPEC, w["name"], trace)


def test_benchmark_json_keeps_to_its_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            reported = [e["name"] for e in harness.cell_metrics(SPEC, w,
                                                                False)]
            assert m["moves"] in reported, (m["name"], w)
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert len(harness.cell_metrics(SPEC, w["name"], False)) >= 2


@pytest.mark.parametrize("fam,tr", [("lpv", "mc"), ("nl", "f1")])
def test_a_new_cell_is_picked_up_with_no_edit(tmp_path, fam, tr):
    bench, spec = tiny_bench(tmp_path)
    cell = harness.load_cell(f"tiny-{fam}-{tr}", bench)
    system = systems.program(cell.conf, "cpu")
    res = harness.execute(cell, 2 ** 33 + 17, 0.5, False, system, spec,
                          bench, t_start=time.perf_counter())
    ctx = res.pop("_context")
    assert list(res) == RESULT_KEYS + ["checks"]
    assert res["correct"] and res["failed"] == 0
    assert res["attempted"] == ctx["steps"] * cell.traffic["fleets"] > 0
    assert "setup_s" in res["metrics"]
    rate = ("lpv_solves_per_s" if fam == "lpv" else "nl_fleet_steps_per_s")
    assert res["metrics"][rate]["value"] > 0
    if tr == "f1":
        assert res["metrics"]["step_ms_p95"]["value"] >= \
            res["metrics"]["step_ms_p50"]["value"] > 0
    else:
        assert "step_ms_p95" not in res["metrics"]


def test_a_traced_run_gives_device_fields_and_breakdown(tmp_path):
    bench, spec = tiny_bench(tmp_path)
    cell = harness.load_cell("tiny-lpv-mc", bench)
    system = systems.program(cell.conf, "cpu")
    res = harness.execute(cell, 5, 0.3, True, system, spec, bench)
    res.pop("_context")
    assert list(res) == RESULT_KEYS + ["breakdown", "checks"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(res["breakdown"]["idle_gaps"]) <= 10
    # no device ran, so no idle share, roofline or counter is made up
    for name in res["metrics"]:
        assert not name.startswith(("device_idle", "admm_epoch_roofline",
                                    "epochs_per_step"))


def test_a_new_metric_file_is_read_with_no_edit(tmp_path):
    bench, spec = tiny_bench(tmp_path)
    (bench / "metrics" / "fleets_in_window.py").write_text(
        "def read(run):\n    return run.fleet_steps\n")
    spec["end_to_end"].append({"name": "fleets_in_window", "unit": "steps",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock"})
    run = SimpleNamespace(fleet_steps=12, setup_s=1.0, window_s=2.0,
                          step_times=[], system=SimpleNamespace(n_agents=3))
    out = harness.read_metrics(run, [spec["end_to_end"][-1]], bench)
    assert out == {"fleets_in_window": {"value": 12.0, "unit": "steps"}}


def test_the_command_refuses_without_a_card_and_prints_no_result():
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        SPEC["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no result" in p.stderr


def test_the_command_refuses_where_the_program_is_missing(tmp_path):
    import shutil
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        SPEC["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "not in this checkout" in p.stderr


class _State(NamedTuple):
    x0: torch.Tensor


class _Sleeper:
    """A system of plain Python whose steps take ``dt`` seconds, and one
    step ``stall`` seconds more."""

    def __init__(self, dt, stall_at=None, stall=0.0):
        self.dt, self.stall_at, self.stall = dt, stall_at, stall
        self.n_agents, self.device = 3, torch.device("cpu")
        self.max_steps = 10 ** 6
        self.calls = 0

    def start(self, fleets, pert):
        return _State(x0=torch.zeros(fleets, 3, 9))

    def step(self, state):
        self.calls += 1
        time.sleep(self.dt + (self.stall if self.calls == self.stall_at
                              else 0.0))
        return state, None

    def effort(self, metrics):
        return torch.ones(2)

    def executed(self, state):
        return state.x0

    def course_ended(self, state):
        return False


@pytest.mark.parametrize("kind", ["course", "sweep"])
def test_rates_and_percentiles_cover_the_whole_window(kind):
    cell = SimpleNamespace(name="x", conf={}, workload={
        "check": {"samples": 2}}, traffic={
        "kind": kind, "fleets": 2, "episode_steps": 5, "noise": 0.05})
    base = harness.run_window(_Sleeper(0.01), cell, 1, 0.4)
    stalled = harness.run_window(_Sleeper(0.01, 3, 0.25), cell, 1, 0.4)
    for run in (base, stalled):
        assert run.window_s >= 0.4
        assert run.fleet_steps == 2 * len(run.work) == 2 * run.steps
    # the stall leaves fewer steps in the same window: the rate falls
    assert readers.fleet_steps_per_s(stalled) < \
        0.8 * readers.fleet_steps_per_s(base)
    assert readers.solves_per_s(base) == pytest.approx(
        3 * readers.fleet_steps_per_s(base))
    if kind == "course":
        assert len(base.step_times) == base.steps
        assert max(stalled.step_times) >= 0.25
        # one stalled step of a dozen moves the tail, not the median
        p95 = readers.step_ms(stalled, 95)
        assert p95 > 2 * readers.step_ms(base, 95)
        assert readers.step_ms(stalled, 50) < \
            1.5 * readers.step_ms(base, 50)
    else:
        assert len(base.step_times) == 0
        assert readers.step_ms(base, 95) is None


def test_the_idle_share_is_one_minus_the_union_of_device_intervals():
    E = tl.Event
    evs = [E("k1", True, 1.0, 2.0), E("k2", True, 1.5, 2.5),
           E("k3", True, 4.0, 4.5), E("memcpy", True, 4.4, 5.0),
           E("k4", True, 9.5, 11.0),
           E("aten::where", False, 0.0, 3.5),
           E("cudaStreamSynchronize", False, 2.5, 3.9),
           E("python", False, 5.0, 9.0)]
    assert tl.union([(1, 2), (1.5, 2.5), (4, 4.5), (4.4, 5)]) == [
        (1, 2.5), (4, 5)]
    assert tl.busy_seconds(evs, 0.0, 10.0) == pytest.approx(1.5 + 1.0 + 0.5)
    run = SimpleNamespace(trace=SimpleNamespace(events=evs, lo=0.0, hi=10.0,
                                                window_s=10.0))
    assert readers.device_idle_pct(run) == pytest.approx(70.0)
    gaps = dict(tl.idle_gaps(evs, 0.0, 10.0))
    # [0, 1] and [2.5, 4]: the innermost host event at the middle
    assert gaps["aten::where"] == pytest.approx(1.0)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(1.5)
    assert gaps["python"] == pytest.approx(4.5)
    assert sum(gaps.values()) == pytest.approx(7.0)
    counts, secs = tl.kernels_matching(evs, ("k1", "k3"))
    assert counts == {"k1": 1, "k3": 1} and secs == pytest.approx(1.5)
    assert tl.top_device_ops(evs, 2) == [["k4", 1.5], ["k1", 1.0]]
    # a trace with no device time reads nothing
    run.trace.events = [e for e in evs if not e.on_device]
    assert readers.device_idle_pct(run) is None


# Hand counts of one problem (P = 1), nz = 11, nc = 2, mr = 6 (3 agents:
# LPV's four rows and two planes, NL eu's four rows and two neighbours).
# Stage QP floats: per stage F 121, G 22, d 11, R 4, r 2, S 22, D 66, E 12
# and four bounds of 6 (284); Q and q over N + 1 (132 each stage).
# Epoch inputs add rho_scale 6, z0 11 and (w, y) 12 a stage; outputs are z
# (N + 1) x 11, c N x 2, (w, y) 12 a stage and two residuals of 6.
# Operations a stage: the fixed data 9,857 (augmentation 1,764 + 156,
# Riccati 5,324 + 968 + 88 + 242 + 294 + 8, Cholesky 2, solves 104,
# P 484 + 363, rows 60); an iteration 1,096 (484 + 176 + 8 + 312 + 72 +
# 44).
HAND = {
    # (N, epoch_len): (bytes, operations)
    (20, 20): (4 * (20 * 284 + 21 * 132 + 6 + 11 + 240 + 231 + 40 + 240
                    + 12), 20 * 9857 + 20 * 20 * 1096),
    (125, 15): (4 * (125 * 284 + 126 * 132 + 6 + 11 + 1500 + 1386 + 250
                     + 1500 + 12), 125 * 9857 + 125 * 15 * 1096),
}


@pytest.mark.parametrize("N,el", sorted(HAND))
def test_frozen_epoch_counts_equal_hand_counts(N, el):
    assert rl.lpv_shape(3) == rl.nl_shape(3, "eu") == (11, 2, 6)
    nbytes, flops = rl.epoch_work(1, N, 11, 2, 6, el)
    assert (nbytes, flops) == HAND[(N, el)]
    b192, f192 = rl.epoch_work(192, N, 11, 2, 6, el)
    assert (b192, f192) == (192 * nbytes, 192 * flops)
    assert HAND[(20, 20)] == (36928, 635540)


def test_frozen_nl_build_counts_equal_hand_counts():
    # per stage x, u and two neighbours' (x, y, price): 17; per problem
    # the state of stage N 9 and 28 more; out the 8,452 QP floats; a
    # track of one lane and one segment 5 floats; 300 operations a stage
    nbytes, flops = rl.nl_build_counts(1, 20, 3, "eu", 1, 1)
    assert nbytes == 4 * (20 * 17 + 9 + 28 + 20 * 284 + 21 * 132 + 5)
    assert flops == 300 * 20


def test_frozen_counts_equal_the_ports_today():
    from colaborativempc_tpu_torch.ops import cuda_lqr, cuda_sqp
    spec = importlib.util.spec_from_file_location("chip_smoke_counts",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for P, N, nz, nc, mr, el in ((192, 125, 11, 2, 6, 15),
                                 (192, 20, 11, 2, 6, 20),
                                 (3, 125, 11, 2, 6, 15),
                                 (64, 20, 11, 8, 13, 20)):
        assert rl.epoch_data_counts(P, N, nz, nc, mr) == \
            cuda_lqr.epoch_data_traffic(P, N, nz, nc, mr)
        ms, by = smoke.kernel_bound(P, N, nz, nc, mr, el)
        s, by2 = rl.bound_s(*rl.epoch_iteration_counts(P, N, nz, nc, mr,
                                                       el))
        assert (s * 1e3, by2) == (pytest.approx(ms, rel=1e-12), by)
    for P, n, coupling, nseg in ((192, 3, "eu", 7), (3, 3, "eu", 7),
                                 (64, 4, "hp_opt", 12)):
        assert rl.nl_build_counts(P, 20, n, coupling, 1, nseg) == \
            cuda_sqp.nl_traffic(P, 20, n - 1, coupling, 1, nseg)


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "colaborativempc_tpu_torch.fake",
                        object())
    assert "colaborativempc_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "colaborativempc_tpu.ops", object())
    assert "colaborativempc_tpu" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert "jaxlib" in harness.forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    bench, spec = tiny_bench(tmp_path)
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from benchmark import harness, systems\n"
        "from pathlib import Path\n"
        "import json\n"
        "cell = harness.load_cell('tiny-nl-mc', Path(%r))\n"
        "spec = json.loads(%r)\n"
        "res = harness.execute(cell, 3, 0.2, False, "
        "systems.program(cell.conf, 'cpu'), spec, Path(%r))\n"
        "print(harness.forbidden_modules(), res['correct'])\n"
    ) % (str(ROOT), str(bench), json.dumps(spec), str(bench))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[] True"


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax",
                                   "colaborativempc_tpu"), (path, n)
                if "reference" in path.parts:
                    assert top != "colaborativempc_tpu_torch", (path, n)


def _sampled(fleets, steps, n, seed, hot=None):
    """The picks of a ``check.Sampler`` fed ``steps`` steps of a batch of
    ``fleets`` whose work is 0 but at ``hot = (step, fleet)``; each state
    holds its step and fleet numbers, so the kept copies name themselves."""
    from benchmark import check
    smp = check.Sampler(n, fleets, seed)
    for k in range(steps):
        eff = torch.zeros(fleets)
        if hot is not None and hot[0] == k:
            eff[hot[1]] = 9
        ids = torch.arange(fleets, dtype=torch.float64)
        pre = (torch.full((fleets,), float(k)), ids)
        post = (torch.full((fleets,), k + 0.5), ids)
        smp.observe(pre, post, eff)
    return smp


def test_sample_draws_every_part_of_the_batch_and_the_longest():
    smp = _sampled(64, 7, 8, 2 ** 31 + 5, hot=(5, 40))
    picks = smp.picks()
    assert picks[0] == (5, 40) and len(picks) == 8
    assert [b // 8 for _, b in picks[1:]] == list(range(1, 8))
    assert all(0 <= k < 7 for k, _ in picks)
    assert picks == _sampled(64, 7, 8, 2 ** 31 + 5, hot=(5, 40)).picks()
    # the kept copies are the picked fleet-steps' states before and after
    for (k, b), (pre, post) in zip(picks, smp.pull()):
        assert pre[0].item() == k and post[0].item() == k + 0.5
        assert pre[1].item() == post[1].item() == b
    one = _sampled(1, 7, 4, 9).picks()
    assert one[0] == (0, 0) and all(b == 0 for _, b in one)


def test_sample_steps_are_uniform_over_the_window():
    # reservoir sampling: over many seeds every step is drawn alike
    counts = np.zeros(10)
    for seed in range(300):
        for k, _ in _sampled(8, 10, 4, seed).picks()[1:]:
            counts[k] += 1
    assert counts.sum() == 900
    assert counts.min() > 0.6 * 90 and counts.max() < 1.4 * 90


@pytest.mark.cuda
def test_a_card_run_reads_every_metric_of_its_cell():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        system = systems.program(cell.conf, torch.device("cuda", 0))
        for trace in (False, True):
            res = harness.execute(cell, 7, 2.0, trace, system, SPEC)
            want = {m["name"] for m in harness.cell_metrics(SPEC, w["name"],
                                                            trace)}
            assert set(res["metrics"]) == want, w["name"]
            assert res["correct"], res["checks"]


def test_the_windows_marker_is_no_device_work():
    class K:
        def __init__(self, name, dev, start, dur):
            self._n, self._d, self._s, self._u = name, dev, start, dur

        def name(self):
            return self._n

        def device_type(self):
            return self._d

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._u

    evs = [K("benchmark_window", "DeviceType.CPU", 0, 10 ** 9),
           K("benchmark_window", "DeviceType.CUDA", 0, 10 ** 9),
           K("admm_epoch_kernel", "DeviceType.CUDA", 10 ** 8, 2 * 10 ** 8)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))
    got = tl.events(prof, ("benchmark_window",))
    assert [(e.name, e.on_device) for e in got] == [
        ("benchmark_window", False), ("admm_epoch_kernel", True)]
    assert tl.busy_seconds(got, 0.0, 1.0) == pytest.approx(0.2)
