"""Parity of the PyTorch port's closed-loop experiment runners with the JAX
package: the batched NL-OCD rollout (per-fleet freeze), the NL and LPV
gain batteries, ``run_nl_experiment`` and ``run_lpv_experiment``.

All float64 on the CPU, small shapes (N <= 8, 2-3 agents, a few steps):
trajectories and duals within 1e-6 (1e-5 for the 8-configuration NL
battery, see there), OCD iteration counts, ADMM iteration counts and
feasible flags equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colaborativempc_tpu import config as jcfg
from colaborativempc_tpu.geometry import make_track as j_make_track
from colaborativempc_tpu.runtime import battery as jbat
from colaborativempc_tpu.runtime import ocd as jocd
from colaborativempc_tpu.runtime import simulate as jsim
from colaborativempc_tpu.utils.precision import x64_island

from colaborativempc_tpu_torch import config as tcfg
from colaborativempc_tpu_torch import interop
from colaborativempc_tpu_torch.runtime import battery as tbat
from colaborativempc_tpu_torch.runtime import ocd as tocd
from colaborativempc_tpu_torch.runtime import simulate as tsim

F64 = torch.float64


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol)


def nl_configs(n_agents=3, N=6, **kw):
    args = dict(n_agents=n_agents, N=N, dt=0.02, map_type="Highway",
                dtype="float64", **kw)
    return (jcfg.ExperimentConfig(
                gains=jcfg.nl_gains(), ocd=jcfg.OCDConfig(max_it_ocd=12),
                solver=jcfg.SolverConfig(admm_iters=60, sqp_iters=2), **args),
            tcfg.ExperimentConfig(
                gains=tcfg.nl_gains(), ocd=tcfg.OCDConfig(max_it_ocd=12),
                solver=tcfg.SolverConfig(admm_iters=60, sqp_iters=2), **args))


def test_batched_nl_rollout_reproduces_standalone_fleets():
    """B=3 fleets in one batch: each fleet's trajectory, duals and OCD
    iteration counts equal its own standalone JAX run, although the batch
    keeps iterating for its slowest fleet."""
    jc, tc = nl_configs()
    steps = 3
    x0 = np.asarray(jcfg.x0_database(3))
    x0s = [x0.copy() for _ in range(3)]
    x0s[1][:, 0] += 0.5
    x0s[2][:, 0] -= 0.4
    x0s[2][1, 1] += 0.3
    with x64_island():
        jt = j_make_track("Highway", dtype=jnp.float64)
        roll = jocd.make_nl_ocd_rollout(jt, jc, steps)
        states = [jocd.init_nl_fleet(jt, jc, x) for x in x0s]
        refs = [roll(s) for s in states]
        batch = jax.tree.map(lambda *a: jnp.stack(a), *states)
    tt = interop.track_from_numpy(jt, dtype=F64)
    fin, (xh, _, m) = tocd.make_nl_ocd_rollout(tt, tc, steps)(
        interop.ocd_state_from_numpy(batch, dtype=F64))
    its = m.ocd_iterations.numpy()
    for b, (jfin, (jxh, _, jm)) in enumerate(refs):
        np.testing.assert_array_equal(its[b], np.asarray(jm.ocd_iterations))
        np.testing.assert_array_equal(m.feasible[b].numpy(),
                                      np.asarray(jm.feasible))
        close(xh[b], jxh, 1e-6)
        close(fin.lambdas[b], jfin.lambdas, 1e-6)
        close(fin.x_pred[b], jfin.x_pred, 1e-6)
    # the fleets stop at different iterations, so the freeze was exercised
    assert len({tuple(r) for r in its.T}) > 1 or len(set(its[:, 0])) > 1


def test_nl_battery_matches_jax():
    jc, tc = nl_configs(n_agents=2)
    kw = dict(q_vx=[25.0, 50.0], q_ey=[150.0, 300.0], dr_scale=[1.0, 0.5])
    steps = 3
    with x64_island():
        jt = j_make_track("Highway", dtype=jnp.float64)
        ref = jbat.run_nl_battery(jc, jbat.gain_grid(jcfg.nl_gains(), **kw),
                                  steps=steps, track=jt)
    tt = interop.track_from_numpy(jt, dtype=F64)
    grid = tbat.gain_grid(tcfg.nl_gains(), **kw)
    got = tbat.run_nl_battery(tc, grid, steps=steps, track=tt, device="cpu")
    assert got.n_configs == len(grid) == 8
    assert got.states.shape == (steps, 8, 2, 9)
    np.testing.assert_array_equal(got.ocd_iterations, ref.ocd_iterations)
    np.testing.assert_array_equal(got.feasible, ref.feasible)
    # the two packages agree to ~1e-11 for two steps; at the third, one
    # configuration's solve ends an ADMM epoch apart on float64 rounding
    # (1.3e-6 on one state, measured), so the battery holds 1e-5
    for f in ("states", "min_dist", "min_dist_exec", "progress"):
        close(getattr(got, f), getattr(ref, f), 1e-5)


def test_lpv_battery_matches_jax():
    args = dict(n_agents=2, N=8, dt=0.02, map_type="Highway",
                dtype="float64")
    jc = jcfg.ExperimentConfig(gains=jcfg.lpv_gains(),
                               solver=jcfg.SolverConfig(admm_iters=100),
                               **args)
    tc = tcfg.ExperimentConfig(gains=tcfg.lpv_gains(),
                               solver=tcfg.SolverConfig(admm_iters=100),
                               **args)
    kw = dict(q_ey=[25.0, 50.0], wq=[5.0, 0.5])
    with x64_island():
        jt = j_make_track("Highway", dtype=jnp.float64)
        ref = jbat.run_lpv_battery(jc, jbat.gain_grid(jcfg.lpv_gains(), **kw),
                                   steps=3, track=jt)
    got = tbat.run_lpv_battery(tc, tbat.gain_grid(tcfg.lpv_gains(), **kw),
                               steps=3,
                               track=interop.track_from_numpy(jt, dtype=F64),
                               device="cpu")
    np.testing.assert_array_equal(got.feasible, ref.feasible)
    for f in ("states", "min_dist_exec", "progress"):
        close(getattr(got, f), getattr(ref, f), 1e-6)


@pytest.mark.parametrize("verb_ocd", [False, True])
def test_run_nl_experiment_matches_jax(verb_ocd, tmp_path):
    """The closed loop of one fleet; with ``verb_ocd`` the port times every
    coordination iteration and still reproduces the fast JAX path."""
    from colaborativempc_tpu_torch.runtime.io import ExperimentIO
    jc, tc = nl_configs(max_it=4)
    ref = jocd.run_nl_experiment(jc)
    tc = tc.__class__(**{**tc.__dict__, "verb_ocd": verb_ocd})
    io = ExperimentIO(tc, path=str(tmp_path))
    got = tocd.run_nl_experiment(tc, io=io, device="cpu")
    assert got.steps == ref.steps == 4
    np.testing.assert_array_equal(got.ocd_iterations, ref.ocd_iterations)
    np.testing.assert_array_equal(got.feasible, ref.feasible)
    for f in ("states", "inputs", "min_dist", "min_dist_exec", "lambdas",
              "exec_beta"):
        close(getattr(got, f), getattr(ref, f), 1e-6)
    assert len(io.ocd_iters) == 4
    if verb_ocd:
        assert [len(r) for r in io.ocd_iter_times] == got.ocd_iterations.tolist()
    else:
        assert io.ocd_iter_times == []


def lpv_configs(N=8, max_it=3, **kw):
    args = dict(n_agents=3, N=N, dt=0.02, map_type="Highway",
                dtype="float64", max_it=max_it, **kw)
    sv = dict(admm_iters=100)
    return (jcfg.ExperimentConfig(gains=jcfg.lpv_gains(),
                                  solver=jcfg.SolverConfig(**sv), **args),
            tcfg.ExperimentConfig(gains=tcfg.lpv_gains(),
                                  solver=tcfg.SolverConfig(**sv), **args))


def test_run_lpv_experiment_matches_jax(tmp_path):
    jc, tc = lpv_configs()
    ref = jsim.run_lpv_experiment(jc)
    got = tsim.run_lpv_experiment(tc, profile_dir=str(tmp_path / "prof"),
                                  device="cpu")
    assert got.steps == ref.steps == 3 and not got.finished
    np.testing.assert_array_equal(got.iterations, ref.iterations)
    np.testing.assert_array_equal(got.feasible, ref.feasible)
    for f in ("states", "inputs", "min_dist", "min_dist_exec", "exec_beta"):
        close(getattr(got, f), getattr(ref, f), 1e-6)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("runner", ["lpv", "nl"])
def test_experiment_resumes_from_checkpoint_exactly(runner, tmp_path):
    """Stopped after 2 steps and resumed to 4, a run ends where the
    uninterrupted 4-step run ends (duals included on the NL path)."""
    if runner == "lpv":
        _, tc = lpv_configs(max_it=4)
        run = tsim.run_lpv_experiment
    else:
        _, tc = nl_configs(max_it=4)
        run = tocd.run_nl_experiment
    straight = run(tc, device="cpu")
    ck = str(tmp_path / "ck.npz")
    first = run(tc.__class__(**{**tc.__dict__, "max_it": 2}),
                checkpoint_path=ck, device="cpu")
    resumed = run(tc, checkpoint_path=ck, device="cpu")
    assert first.steps == 2 and resumed.steps == 2
    np.testing.assert_array_equal(resumed.states, straight.states[2:])
    if runner == "nl":
        np.testing.assert_array_equal(resumed.lambdas, straight.lambdas)
