"""Controller families found by file (``benchmark/families/<family>.py``):
a family with another state's layout runs through the whole harness
with no file of ``benchmark/`` touched; the fleet families read the same
bits as the harness did before they moved into files of their own; a
family with no file is refused by name."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import check, harness, systems, traffic
from benchmark.tests.conftest import BENCH, ROOT, tiny_bench

# A racing layout: one car a fleet, a state with no agent axis (x, x_bar,
# u_bar, ...). The port's single-car MPCC step stands in for program and
# reference alike, so this checks the harness, not the port.
RACE = '''"""Single-car MPCC racing (the port's ``runtime/racing.py``)."""
from types import SimpleNamespace

import torch

PROGRAM = REFERENCE = "colaborativempc_tpu_torch"
COUNTERS = (("colaborativempc_tpu_torch.ops.cuda_sqp", "mpcc_qp_batched"),
            ("colaborativempc_tpu_torch.ops.cuda_lqr", "admm_epoch_batched"))


def config(package, conf, dtype):
    from colaborativempc_tpu_torch.planners.mpcc import MPCCConfig
    return MPCCConfig(**conf["race"])


def build(package, cfg, conf, device, dtype):
    from colaborativempc_tpu_torch.runtime import racing
    track = racing.load_mpcc_track(cfg, dtype=dtype, device=device)
    base = racing.init_mpcc(track, cfg, dtype=dtype, device=device)

    def start(fleets, pert):
        x = base.x + torch.as_tensor(pert[:, 0], dtype=dtype, device=device)
        return racing.init_mpcc(track, cfg, x, races=fleets, dtype=dtype,
                                device=device)

    def course_ended(state):
        return cfg.laps > 0 and bool(
            state.x[0, 6] >= cfg.laps * track.track_length[0])

    return SimpleNamespace(track=track, base=base,
                           step=racing.make_mpcc_step(track, cfg),
                           start=start, course_ended=course_ended)


def n_agents(cfg):
    return 1


def max_steps(cfg):
    return cfg.n_sim


def executed(state):
    return state.x


def plans(state):
    return state.x_bar, state.u_bar


def prices(state):
    return None


def effort(metrics):
    return metrics.iterations


def epoch_shape(conf):
    return dict(N=conf["race"]["N"], nz=11, nc=2, mr=7, agents=1,
                epoch_len=10)
'''


def _files(d):
    """Every file under ``d`` but the byte code, with its time and size."""
    return sorted((str(p.relative_to(d)), p.stat().st_mtime_ns,
                   p.stat().st_size) for p in d.rglob("*")
                  if p.is_file() and "__pycache__" not in p.parts)


def _race_bench(tmp_path):
    """``tiny_bench`` with the racing family, its configuration at N=8
    and a course cell and a sweep cell, written as files alone."""
    bench, spec = tiny_bench(tmp_path)
    (bench / "families" / "race.py").write_text(RACE)
    (bench / "configs" / "tiny-race.json").write_text(json.dumps(
        {"name": "tiny-race", "family": "race", "dtype": "float32",
         "race": {"N": 8, "n_sim": 3, "admm_iters": 200}}))
    # the sweep's noise is small: at the fleets' 0.05 on (vx, vy, wz) the
    # 1:43 car's cold-started SQP fails its QPs, and float32 and float64
    # part within two steps (executed states by up to 6, plans by 10**3)
    for tr, kind, noise in (("race1", "course", 0.0),
                            ("race-sweep", "sweep", 0.002)):
        (bench / "traffic" / f"{tr}.json").write_text(json.dumps(
            {"kind": kind, "fleets": 1 if kind == "course" else 4,
             "episode_steps": 2, "noise": noise}))
        # the port's racing step in float32 against float64 on the CPU
        # reads 3.5e-9 / 3.5e-7 (x0_gap / plan_gap) on the course and
        # 2.0e-5 / 6.5e-5 on the sweep at the tests' seed; up to 4.0e-4 /
        # 7.5e-3 on other seeds, where the cold-started first step is drawn
        (bench / "workloads" / f"tiny-race-{tr}.json").write_text(
            json.dumps({"name": f"tiny-race-{tr}", "config": "tiny-race",
                        "traffic": tr, "why": "test", "warm_steps": 1,
                        "trace_seconds": 0.2,
                        "check": {"samples": 3, "device": "cpu", "limits": {
                            "start_gap": 0.0, "x0_gap": 1e-3,
                            "plan_gap": 1e-2}}}))
    return bench, spec


@pytest.mark.parametrize("tr,trace", [("race1", False),
                                      ("race-sweep", True)])
def test_a_family_with_another_layout_is_added_by_files_alone(tmp_path, tr,
                                                              trace):
    before = _files(BENCH)
    bench, spec = _race_bench(tmp_path)
    cell = harness.load_cell(f"tiny-race-{tr}", bench)
    system = systems.program(cell.conf, "cpu", bench)
    assert system.n_agents == 1 and system.executed(system.base).shape == (
        1, 9)
    res = harness.execute(cell, 2 ** 33 + 41, 0.5, trace, system, spec,
                          bench, t_start=time.perf_counter())
    ctx = res.pop("_context")
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["checks"]["start_gap"]["value"] == 0.0
    assert "price_gap" not in res["checks"]
    assert res["attempted"] == ctx["steps"] * cell.traffic["fleets"] > 0
    if trace:
        # no card ran, so no roofline is read, though its shape is the
        # family's
        assert "admm_epoch_roofline.lpv_mc" not in res["metrics"]
    else:
        assert res["metrics"]["step_ms_p95"]["value"] > 0
    assert _files(BENCH) == before


def test_a_broken_step_of_the_new_family_is_not_correct(tmp_path):
    bench, spec = _race_bench(tmp_path)
    cell = harness.load_cell("tiny-race-race-sweep", bench)
    system = systems.program(cell.conf, "cpu", bench)

    class Unchanged:
        """The program with a step that returns its state unchanged."""

        def __getattr__(self, name):
            return getattr(system, name)

        def step(self, state):
            return state, system.step(state)[1]

    res = harness.execute(cell, 5, 0.5, False, Unchanged(), spec, bench)
    assert not res["correct"]
    assert res["checks"]["x0_gap"]["value"] > \
        res["checks"]["x0_gap"]["limit"]


def _digest(state) -> str:
    h = hashlib.sha256()
    for t in state:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


# Recorded by running the calls of the test below with the harness as it
# was before the families moved into files of their own (the same on 1, 2
# and 4 CPU threads): the sha-256 (first 16 hex digits) of every field's
# bytes of the start and of the state after each of 3 steps, and the
# check's gaps on the three fleet-steps (fleet k of step k).
BEFORE = {
    "lpv": (["1e721375c89889db", "c58de5609bdf1c23", "02c298050aaa2ee7",
             "1a539fad53aefdfe"],
            {"x0_gap": 5.5106564310694606e-06,
             "plan_gap": 8.632407756281602e-06, "start_gap": 0.0}),
    "nl": (["ce6305e26bbea0e2", "443af7acc8a8ef0f", "66e35474745b44e7",
            "418eeac5f6aa3b06"],
           {"x0_gap": 8.31523872660278e-07,
            "plan_gap": 6.424492094758705e-06,
            "price_gap": 2.0005009627316328e-07, "start_gap": 0.0}),
}


@pytest.mark.parametrize("fam", ["lpv", "nl"])
def test_the_fleet_families_read_the_same_bits_as_before(tmp_path, fam):
    bench, _ = tiny_bench(tmp_path)
    conf = harness.load_cell(f"tiny-{fam}-mc", bench).conf
    prog = systems.program(conf, "cpu", bench)
    pert = traffic.start_perturbation({"fleets": 3, "noise": 0.05}, 3,
                                      2 ** 33 + 5, 0)
    state = prog.start(3, pert)
    digests, pulled = [_digest(state)], []
    for k in range(3):
        new, _ = prog.step(state)
        pulled.append((check._take(state, k), check._take(new, k)))
        state = new
        digests.append(_digest(state))
    gaps = check.compare(
        systems.reference(conf, "cpu", bench=bench), pulled,
        systems.reference(conf, "cpu", conf["dtype"], bench),
        [tuple(t.clone() for t in prog.start(3, pert))], [pert])
    assert (digests, gaps) == BEFORE[fam]


def test_a_family_with_no_file_is_refused_by_name(tmp_path):
    bench, _ = tiny_bench(tmp_path)
    conf = json.loads((bench / "configs" / "tiny-lpv.json").read_text())
    conf["family"] = "no-such-family"
    with pytest.raises(harness.Refused, match="families/no-such-family.py"):
        systems.program(conf, "cpu", bench)
    # the command, in a checkout whose cell names it: no result, and the
    # file it looked for, before it looks for a card
    shutil.copytree(BENCH, tmp_path / "co" / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    co = tmp_path / "co" / "benchmark"
    (co / "configs" / "no-such.json").write_text(json.dumps(conf))
    wl = json.loads((co / "workloads" / "lpv-n125-mc64.json").read_text())
    (co / "workloads" / "no-such.json").write_text(json.dumps(
        {**wl, "name": "no-such", "config": "no-such"}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "no-such", "config": "no-such",
                              "traffic": "mc64", "chips": 1, "why": "test"})
    (tmp_path / "co" / "BENCHMARK.json").write_text(json.dumps(spec))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "no-such", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path / "co",
                       env={**os.environ, "PYTHONPATH": str(ROOT)},
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "benchmark: no result:" in p.stderr
    assert "families/no-such-family.py" in p.stderr
