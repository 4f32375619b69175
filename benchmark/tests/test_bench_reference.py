"""The plain reference and the frozen copies against the port on the CPU:
the reference's steps are the port's CPU path, bit for bit, at a small
size; the generator, the start states and the settings draw the same
numbers as the port does today; the reference imports nothing of the
port. And the reference against answers worked out without its code
(``benchmark/reference/exact.py``): its ADMM reaches each stage QP's
optimum, and its model is the bicycle written from its forces."""

import importlib
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import systems, traffic
from benchmark.tests.conftest import BENCH, ROOT

CONFIGS = {"lpv": "lpv-highway-3ag-n125", "nl": "nl-ocd-highway-3ag-n20"}


def _conf(fam: str, N: int = 8) -> dict:
    conf = json.loads((BENCH / "configs" / f"{CONFIGS[fam]}.json")
                      .read_text())
    conf["experiment"]["N"] = N
    if fam == "lpv":
        conf["solver"]["admm_iters"] = 300
    return conf


@pytest.mark.parametrize("fam", ["lpv", "nl"])
def test_the_reference_is_the_ports_cpu_path_bit_for_bit(fam):
    conf = _conf(fam)
    prog = systems.program(conf, "cpu")
    ref = systems.reference(conf, "cpu", "float32")
    pert = traffic.start_perturbation({"fleets": 3, "noise": 0.05}, 3,
                                      2 ** 32 + 3, 0)
    a, b = prog.start(3, pert), ref.start(3, pert)
    for _ in range(3):
        a, ma = prog.step(a)
        b, mb = ref.step(b)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        for x, y in zip(ma, mb):
            assert torch.equal(x, y)


@pytest.mark.parametrize("fam", ["lpv", "nl"])
def test_float64_reference_stays_near_the_ports_float32_cpu_path(fam):
    conf = _conf(fam)
    prog = systems.program(conf, "cpu")
    ref = systems.reference(conf, "cpu")
    pert = traffic.start_perturbation({"fleets": 2, "noise": 0.05}, 3, 11, 0)
    state = prog.start(2, pert)
    state, _ = prog.step(state)
    post, _ = prog.step(state)
    want, _ = ref.step(type(state)(*(t.double() if t.is_floating_point()
                                     else t for t in state)))
    assert float((post.x0.double() - want.x0).abs().max()) < 1e-4
    assert ref.base.x0.dtype == torch.float64


def test_the_frozen_generator_draws_the_ports_numbers():
    from colaborativempc_tpu_torch.scripts.monte_carlo import perturb_x0
    for seed in (0, 7, 2 ** 31 + 11):
        a = traffic.perturb_x0((64, 3, 9), 0.05, np.random.default_rng(seed))
        b = perturb_x0((64, 3, 9), 0.05, np.random.default_rng(seed))
        np.testing.assert_array_equal(a, b)
        assert np.all(a[..., 3:] == 0) and np.any(a[..., :3] != 0)
    one = traffic.start_perturbation({"fleets": 64, "noise": 0.05}, 3,
                                     2 ** 33, 4)
    np.testing.assert_array_equal(one, traffic.start_perturbation(
        {"fleets": 64, "noise": 0.05}, 3, 2 ** 33, 4))
    assert not np.array_equal(one, traffic.start_perturbation(
        {"fleets": 64, "noise": 0.05}, 3, 2 ** 33, 5))


def test_a_pool_gives_every_seed_the_same_starts_in_another_order():
    tr = {"fleets": 64, "noise": 0.05, "pool": 1}
    for episode in (0, 3):
        a = traffic.start_perturbation(tr, 3, 2 ** 33 + 1, episode)
        b = traffic.start_perturbation(tr, 3, 7, episode)
        assert not np.array_equal(a, b)
        key = [tuple(r) for r in a.reshape(64, -1)]
        assert sorted(key) == sorted(tuple(r) for r in b.reshape(64, -1))
        np.testing.assert_array_equal(a, traffic.start_perturbation(
            tr, 3, 2 ** 33 + 1, episode))
    # the episodes of one run differ, and a pool's starts are the
    # generator's own draws
    assert not np.array_equal(traffic.start_perturbation(tr, 3, 7, 0),
                              traffic.start_perturbation(tr, 3, 7, 1))
    free = traffic.start_perturbation({"fleets": 64, "noise": 0.05}, 3, 1,
                                      0)
    assert sorted(map(tuple, free.reshape(64, -1))) == sorted(
        map(tuple, traffic.start_perturbation(tr, 3, 99, 0).reshape(64, -1)))


@pytest.mark.parametrize("fam", ["lpv", "nl"])
def test_the_configurations_hold_the_ports_settings(fam):
    from colaborativempc_tpu_torch.config import params as p
    conf = json.loads((BENCH / "configs" / f"{CONFIGS[fam]}.json")
                      .read_text())
    np.testing.assert_array_equal(np.asarray(conf["x0"]),
                                  p.x0_database(3))
    gains = p.lpv_gains() if fam == "lpv" else p.nl_gains()
    for k in ("q", "qs", "r", "dr"):
        np.testing.assert_array_equal(conf["gains"][k], getattr(gains, k))
    assert conf["gains"]["wq"] == gains.wq
    assert conf["model"] == p.ModelParams()._asdict()
    assert conf["limits"] == p.SysLimits()._asdict()
    assert conf["ocd"] == p.OCDConfig()._asdict()
    default = p.ExperimentConfig()
    for k, v in conf["experiment"].items():
        if k not in ("N", "dt", "max_it"):
            assert v == getattr(default, k), k
    e = conf["experiment"]
    if fam == "lpv":
        # scripts/lpv_main.py: 3 agents, N=125, dt 0.025, 600 steps, 1000
        # ADMM iterations; resolve_single_fleet_schedule's epoch_len 15
        assert (e["N"], e["dt"], e["max_it"]) == (125, 0.025, 600)
        assert conf["solver"] == p.SolverConfig(
            admm_iters=1000, epoch_len=15, assoc=False)._asdict()
    else:
        # scripts/nl_main.py: N=20, dt 0.02, 1500 steps, the solver's
        # defaults (None resolves to 300 ADMM iterations at N=20)
        assert (e["N"], e["dt"], e["max_it"]) == (20, 0.02, 1500)
        assert conf["solver"] == p.SolverConfig(admm_iters=300)._asdict()
        assert p.SolverConfig().admm_budget() == 300


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.cmpc.fleet, "
            "benchmark.reference.cmpc.ocd\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('colaborativempc_tpu_torch', 'colaborativempc_tpu', 'jax')))"
            % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_the_exact_solver_finds_known_optima():
    from benchmark.reference import exact
    # min 1/2 (x - 3)^2 subject to x <= 1, and with x <= 1 soft at weight
    # 2 (2 (x - 1)^2 over it): x = 1, and x = (3 + 4) / 5
    n = 1
    for w, want in ((np.inf, 1.0), (2.0, 7.0 / 5.0)):
        A, b, ws = exact._inequalities(n, np.eye(1), np.zeros(1),
                                       np.array([-np.inf]), np.array([1.0]),
                                       np.array([np.inf]), np.array([w]))
        P = np.zeros((n + ws.size, n + ws.size))
        P[0, 0] = 1.0
        P[n:, n:] = np.diag(2.0 * ws)
        x = exact._ipm(P, np.concatenate([[-3.0], np.zeros(ws.size)]), A, b)
        assert x[0] == pytest.approx(want, abs=1e-9)


@pytest.mark.parametrize("fam", ["lpv", "nl"])
def test_the_references_admm_reaches_each_stage_qps_optimum(fam,
                                                             monkeypatch):
    # the stage QPs of the reference's second float64 step (warm plans,
    # neighbours' planes or prices), solved by its ADMM to a tight
    # tolerance and by a dense interior point that shares none of its code
    from benchmark.reference import exact
    mod = importlib.import_module(f"benchmark.reference.cmpc.{fam}")
    real, seen = mod.admm_solve, []

    def spy(qp, z0, **kw):
        seen.append((qp, z0, kw))
        return real(qp, z0, **kw)

    monkeypatch.setattr(mod, "admm_solve", spy)
    ref = systems.reference(_conf(fam), "cpu")
    state = ref.start(2, traffic.start_perturbation(
        {"fleets": 2, "noise": 0.05}, 3, 2 ** 31 + 7, 0))
    for _ in range(2):
        state, _ = ref.step(state)
    qp, z0, kw = seen[-1]
    tight = real(qp, z0, **{**kw, "iters": 60000, "eps": 1e-11})
    assert float(tight.r_prim.max()) < 1e-10
    for p in range(z0.shape[0]):
        z, c = exact.stage_qp_optimum(qp, p, z0[p])
        scale = 1.0 + np.abs(z).max()
        assert np.abs(tight.z[p].numpy() - z).max() < 1e-8 * scale
        assert np.abs(tight.c[p].numpy() - c).max() < 1e-8 * scale


def test_the_references_model_is_the_bicycle_from_its_forces():
    from benchmark.reference import exact
    from benchmark.reference.cmpc import bicycle
    from benchmark.reference.cmpc.config import ModelParams
    rng = np.random.default_rng(2 ** 31 + 3)
    n = 400
    x = np.column_stack([
        rng.uniform(-0.1, 3.0, n), rng.normal(0, 0.3, n),
        rng.normal(0, 1.0, n), rng.normal(0, 0.2, n), rng.normal(0, 0.3, n),
        rng.uniform(-np.pi, np.pi, n), rng.uniform(0, 20, n),
        rng.normal(0, 5, n), rng.normal(0, 5, n)])
    u = np.column_stack([rng.normal(0, 0.2, n), rng.normal(0, 1.0, n)])
    kappa = rng.normal(0, 0.5, n)
    p = ModelParams()
    want = exact.bicycle_rhs(x, u, kappa, **p._asdict())
    got = bicycle.f_continuous(torch.as_tensor(x), torch.as_tensor(u),
                               torch.as_tensor(kappa), p).numpy()
    assert (x[:, 0] < bicycle.LOW_VEL_THRESH).sum() > 5
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
