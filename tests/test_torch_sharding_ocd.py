"""The port's sharded NL-OCD coordination step and rollout on real
multi-process gloo groups, held against the JAX package's sharded step and
the port's own single-process step (the harness is
``tests/test_torch_sharding.py``'s: spawned ranks that import no JAX, one
torch thread each, a ``file://`` rendezvous, the global result gathered on
every rank).

Tolerances: eu on a 2 x 2 mesh within 2e-3 (x_pred) and 1e-3 (lambdas) of
JAX's sharded step — the JAX package's own sharded-vs-single tolerances
(``tests/test_sharding.py:90-93``); OCD iteration counts equal to
JAX's scenario by scenario; the float64 step within 1e-9 of the port's
single-process step; the sharded rollout within 1e-5 of the per-step
sharded loop, with equal iteration counts.
"""

import dataclasses

import numpy as np
import pytest
import torch

from colaborativempc_tpu_torch import config as tcfg
from colaborativempc_tpu_torch import interop
from colaborativempc_tpu_torch.geometry import make_track
from colaborativempc_tpu_torch.parallel import (
    gather_sharded, make_sharded_nl_ocd_rollout, make_sharded_nl_ocd_step,
    place_ocd_batch,
)
from colaborativempc_tpu_torch.runtime import ocd as tocd

from test_torch_sharding import close, join, np_record, spawn

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64


def nl_cfg(dtype="float32", n_agents=4, max_it_ocd=12, iters=150, sqp=2,
           coupling="eu", sweep="jacobi"):
    return tcfg.ExperimentConfig(
        n_agents=n_agents, N=8, dt=0.02, max_it=5, map_type="oval",
        dtype=dtype, coupling=coupling, gains=tcfg.nl_gains(),
        ocd=tcfg.OCDConfig(max_it_ocd=max_it_ocd, sweep=sweep),
        solver=tcfg.SolverConfig(admm_iters=iters, sqp_iters=sqp))


def jax_nl_cfg(n_agents=4, max_it_ocd=12, iters=150, sqp=2, coupling="eu"):
    from colaborativempc_tpu import config as jcfg
    return jcfg.ExperimentConfig(
        n_agents=n_agents, N=8, dt=0.02, max_it=5, map_type="oval",
        coupling=coupling, gains=jcfg.nl_gains(),
        ocd=jcfg.OCDConfig(max_it_ocd=max_it_ocd),
        solver=jcfg.SolverConfig(admm_iters=iters, sqp_iters=sqp))


def ocd_state(start, dtype):
    return interop.ocd_state_from_numpy(start, device="cpu", dtype=dtype)


def sharded_ocd(mesh, cfg, start, dtype):
    track = make_track(cfg.map_type, device="cpu", dtype=dtype)
    new, m = make_sharded_nl_ocd_step(track, cfg, mesh)(
        place_ocd_batch(ocd_state(start, dtype), mesh))
    return (interop.to_numpy(gather_sharded(new, mesh)),
            interop.to_numpy(gather_sharded(m, mesh)))


def ocd_cases_rank(rank, world, rdv, starts):
    """2 x 2 mesh: eu in float32 and float64, the two-speed batch, and the
    2-step rollout beside the per-step loop."""
    mesh = join(rank, world, rdv, (2, 2))
    out = {"eu": sharded_ocd(mesh, nl_cfg(), starts["eu"], F32),
           "eu64": sharded_ocd(mesh, nl_cfg("float64"), starts["eu"], F64),
           "speeds": sharded_ocd(mesh, nl_cfg(max_it_ocd=25),
                                 starts["speeds"], F32)}
    cfg = nl_cfg(max_it_ocd=10, iters=120, sqp=1)
    track = make_track(cfg.map_type, device="cpu")
    st = place_ocd_batch(ocd_state(starts["eu"], F32), mesh)
    step = make_sharded_nl_ocd_step(track, cfg, mesh)
    s1 = st
    for _ in range(2):
        s1, m1 = step(s1)
    s2, ms = make_sharded_nl_ocd_rollout(track, cfg, mesh, 2)(st)
    out["per_step"] = (interop.to_numpy(gather_sharded(s1, mesh)),
                       interop.to_numpy(gather_sharded(m1, mesh)))
    out["rollout"] = (interop.to_numpy(gather_sharded(s2, mesh)),
                      interop.to_numpy(gather_sharded(ms, mesh,
                                                      time_axis=True)))
    return out


def jax_sharded(cfg, states, shape):
    """JAX's sharded step on a mesh of ``shape`` virtual devices, from the
    scenarios ``states`` stacked; returns (numpy start, state, metrics)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from colaborativempc_tpu.geometry import make_track as j_make_track
    from colaborativempc_tpu.parallel import (
        make_sharded_nl_ocd_step as j_step, place_ocd_batch as j_place,
    )
    n = shape[0] * shape[1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("scen", "agent"))
    batched = jax.tree.map(lambda *a: jnp.stack(a), *states)
    new, m = j_step(j_make_track(cfg.map_type), cfg, mesh)(
        j_place(batched, mesh))
    return np_record(batched), np_record(new), np_record(m)


def two_fleets(cfg, speed_b):
    """Two fleets from the x0 database, the second ``speed_b`` faster."""
    from colaborativempc_tpu.config import x0_database
    from colaborativempc_tpu.geometry import make_track as j_make_track
    from colaborativempc_tpu.runtime.ocd import init_nl_fleet
    track = j_make_track(cfg.map_type)
    x0_a = np.asarray(x0_database(cfg.n_agents))
    x0_b = x0_a.copy()
    x0_b[:, 0] += speed_b
    return [init_nl_fleet(track, cfg, x) for x in (x0_a, x0_b)]


@pytest.fixture(scope="module")
def ocd_runs(tmp_path_factory):
    starts, refs = {}, {}
    for name, cfg, speed in (("eu", jax_nl_cfg(), 0.2),
                             ("speeds", jax_nl_cfg(max_it_ocd=25), 0.5)):
        starts[name], *refs[name] = jax_sharded(
            cfg, two_fleets(cfg, speed), (2, 2))
    ranks = spawn(ocd_cases_rank, 4, tmp_path_factory.mktemp("ocd"), starts)
    return starts, refs, ranks


def test_every_rank_holds_the_same_global_result(ocd_runs):
    _, _, ranks = ocd_runs
    for r in ranks[1:]:
        for case in ("eu", "speeds", "rollout"):
            for a, b in zip(ranks[0][case], r[case]):
                for f in a:
                    np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_sharded_ocd_eu_matches_jax_sharded_step(ocd_runs):
    _, refs, ranks = ocd_runs
    (st, m), (jst, jm) = ranks[0]["eu"], refs["eu"]
    close(st["x_pred"], jst["x_pred"], 2e-3)
    close(st["lambdas"], jst["lambdas"], 1e-3)
    np.testing.assert_array_equal(m["feasible"], jm["feasible"])
    np.testing.assert_array_equal(m["ocd_iterations"], jm["ocd_iterations"])
    assert st["lambdas"].shape == (2, 4, 4, 8)


def test_sharded_ocd_float64_matches_single_process(ocd_runs):
    starts, _, ranks = ocd_runs
    cfg = nl_cfg("float64")
    track = make_track(cfg.map_type, device="cpu", dtype=F64)
    ref, rm = tocd.make_nl_ocd_step(track, cfg)(ocd_state(starts["eu"], F64))
    st, m = ranks[0]["eu64"]
    for f in tocd.OCDFleetState._fields:
        close(st[f], getattr(ref, f).numpy(), 1e-9)
    for f in tocd.OCDStepMetrics._fields:
        close(m[f], getattr(rm, f).numpy(), 1e-9)


def test_per_scenario_convergence_matches_jax(ocd_runs):
    """Two fleets of different speed in one batch converge at their own
    OCD depths; each scenario's count equals JAX's."""
    _, refs, ranks = ocd_runs
    (st, m), (jst, jm) = ranks[0]["speeds"], refs["speeds"]
    np.testing.assert_array_equal(m["ocd_iterations"], jm["ocd_iterations"])
    close(st["x_pred"], jst["x_pred"], 2e-3)
    close(st["lambdas"], jst["lambdas"], 1e-3)


def test_sharded_ocd_rollout_matches_per_step(ocd_runs):
    _, _, ranks = ocd_runs
    (s1, m1), (s2, ms) = ranks[0]["per_step"], ranks[0]["rollout"]
    for f in s1:
        close(s2[f], s1[f], 1e-5)
    assert ms["ocd_iterations"].shape == (2, 2)       # (steps, S)
    np.testing.assert_array_equal(ms["ocd_iterations"][-1],
                                  m1["ocd_iterations"])


def test_gauss_seidel_is_refused_on_the_mesh():
    cfg = nl_cfg(sweep="gauss_seidel")
    track = make_track(cfg.map_type, device="cpu")
    for build in (make_sharded_nl_ocd_step,
                  lambda *a: make_sharded_nl_ocd_rollout(*a, 2)):
        with pytest.raises(ValueError, match="sweep='jacobi'") as e:
            build(track, cfg, None)
        assert "TPU" not in str(e.value)
    # the single-process path keeps Gauss-Seidel
    assert tocd.make_nl_ocd_step(track, dataclasses.replace(cfg)) is not None
