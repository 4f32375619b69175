"""The port's sharded LPV fleet step and rollout on real multi-process gloo
groups, held against the JAX package's sharded step and the port's own
single-process step.

Ranks are spawned processes (``parallel.run_local_ranks``) that import no
JAX: their bodies are this module's ``*_rank`` functions, and JAX is
imported inside the test functions only. Each rank runs one torch thread,
joins through a ``file://`` rendezvous under ``tmp_path`` with an explicit
timeout, and returns the global result gathered on every rank
(``gather_sharded``). The JAX reference runs here on the conftest's
virtual CPU devices, on a mesh of the same shape, from the same numpy
start.

Tolerances: the float32 step within 5e-4 of JAX's sharded step (the JAX
package's own sharded-vs-single tolerance, ``tests/test_sharding.py:45``)
with equal feasible flags; the float64 step within 1e-9 of the port's
single-process step (rounding of the split batch only); the sharded
rollout within 1e-6 of the per-step sharded loop.
"""

import dataclasses
import datetime

import numpy as np
import pytest
import torch

from colaborativempc_tpu_torch import config as tcfg
from colaborativempc_tpu_torch import interop
from colaborativempc_tpu_torch.geometry import make_track
from colaborativempc_tpu_torch.parallel import (
    fleet_mesh, gather_sharded, initialize_distributed,
    make_sharded_lpv_rollout, make_sharded_lpv_step, shard_fleet_state,
)
from colaborativempc_tpu_torch.parallel.multihost import run_local_ranks
from colaborativempc_tpu_torch.runtime import simulate as tsim

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
RANK_TIMEOUT = datetime.timedelta(seconds=90)


def spawn(fn, world, tmp_path, *args, deadline=150.0):
    """``fn(rank, world, rendezvous, *args)`` on ``world`` local gloo
    ranks; each rank's result, in rank order."""
    rdv = tmp_path / f"rdv_{fn.__name__}_{world}"
    return run_local_ranks(fn, world, (f"file://{rdv}",) + args,
                           timeout=deadline)


def join(rank, world, rdv, shape):
    """Join the gloo group and build the ("scen", "agent") mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    initialize_distributed("cpu", init_method=rdv, rank=rank,
                           world_size=world, timeout=RANK_TIMEOUT)
    return init_device_mesh("cpu", shape, mesh_dim_names=("scen", "agent"))


def lpv_cfg(dtype="float32", n_agents=4, N=8, iters=400, map_type="oval",
            **kw):
    return tcfg.ExperimentConfig(
        n_agents=n_agents, N=N, dt=0.025, max_it=10, map_type=map_type,
        dtype=dtype, gains=tcfg.lpv_gains(),
        solver=tcfg.SolverConfig(admm_iters=iters), **kw)


def jax_cfg(n_agents=4, N=8, iters=400, map_type="oval", dt=0.025, **kw):
    from colaborativempc_tpu import config as jcfg
    return jcfg.ExperimentConfig(
        n_agents=n_agents, N=N, dt=dt, max_it=10, map_type=map_type,
        gains=jcfg.lpv_gains(), solver=jcfg.SolverConfig(admm_iters=iters),
        **kw)


def np_record(rec):
    return {f: np.asarray(getattr(rec, f)) for f in rec._fields}


def perturbed(start, seed):
    """Each scenario's speeds jittered (numpy seed), so the scenario
    split matters."""
    rng = np.random.default_rng(seed)
    x0 = start["x0"].copy()
    x0[..., 0] += rng.normal(size=x0.shape[:2]) * 0.02
    return dict(start, x0=x0.astype(start["x0"].dtype))


def port_state(start, dtype):
    return interop.fleet_state_from_numpy(start, device="cpu", dtype=dtype)


def sharded_step(mesh, cfg, start, dtype):
    track = make_track(cfg.map_type, device="cpu", dtype=dtype)
    new, m = make_sharded_lpv_step(track, cfg, mesh)(
        shard_fleet_state(port_state(start, dtype), mesh))
    return (interop.to_numpy(gather_sharded(new, mesh)),
            interop.to_numpy(gather_sharded(m, mesh)))


def lpv_cases_rank(rank, world, rdv, starts):
    """2 x 2 mesh: the float32 and float64 steps on Oval, the dynamic-lane
    step on Oval2, and the 3-step rollout beside the per-step loop."""
    mesh = join(rank, world, rdv, (2, 2))
    out = {"f32": sharded_step(mesh, lpv_cfg(), starts["oval"], F32),
           "f64": sharded_step(mesh, lpv_cfg("float64"), starts["oval"], F64),
           "lanes": sharded_step(
               mesh, lpv_cfg(map_type="Oval2", lane=0, dynamic_lane=True),
               starts["oval2"], F32)}
    cfg = lpv_cfg()
    track = make_track(cfg.map_type, device="cpu")
    st = shard_fleet_state(port_state(starts["oval"], F32), mesh)
    step = make_sharded_lpv_step(track, cfg, mesh)
    s1 = st
    for _ in range(3):
        s1, m1 = step(s1)
    s2, ms = make_sharded_lpv_rollout(track, cfg, mesh, 3)(st)
    out["per_step"] = (interop.to_numpy(gather_sharded(s1, mesh)),
                       interop.to_numpy(gather_sharded(m1, mesh)))
    out["rollout"] = (interop.to_numpy(gather_sharded(s2, mesh)),
                      interop.to_numpy(gather_sharded(ms, mesh,
                                                      time_axis=True)))
    out["fleet_mesh"] = {}
    for n_agents in (4, 3, 2):
        m, n_scen = fleet_mesh(n_agents)
        out["fleet_mesh"][n_agents] = (tuple(m.shape), m.mesh_dim_names,
                                       n_scen)
    return out


@pytest.fixture(scope="module")
def lpv_runs(tmp_path_factory):
    """The JAX sharded references on a 2 x 2 mesh of virtual devices and
    the port's ranks on a 2 x 2 gloo mesh, from the same numpy starts."""
    import jax
    from jax.sharding import Mesh
    from colaborativempc_tpu.geometry import make_track as j_make_track
    from colaborativempc_tpu.parallel import (
        batch_fleet_state, make_sharded_lpv_step as j_step, shard_fleet_state
        as j_shard,
    )
    from colaborativempc_tpu.runtime import init_lpv_fleet
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("scen", "agent"))
    starts, refs = {}, {}
    for name, cfg, init_cfg in (
            ("oval", jax_cfg(), jax_cfg()),
            ("oval2", jax_cfg(map_type="Oval2", lane=0, dynamic_lane=True),
             jax_cfg(map_type="Oval2", lane=1))):
        track = j_make_track(cfg.map_type)
        st = batch_fleet_state(init_lpv_fleet(track, init_cfg), 2)
        starts[name] = perturbed(np_record(st), 5)
        jst = type(st)(**{f: jax.numpy.asarray(v)
                          for f, v in starts[name].items()})
        new, m = j_step(track, cfg, mesh)(j_shard(jst, mesh))
        refs[name] = (np_record(new), np_record(m))
    ranks = spawn(lpv_cases_rank, 4, tmp_path_factory.mktemp("lpv"), starts)
    return starts, refs, ranks


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol)


def test_every_rank_holds_the_same_global_result(lpv_runs):
    _, _, ranks = lpv_runs
    for r in ranks[1:]:
        for case in ("f32", "f64", "lanes", "rollout"):
            for a, b in zip(ranks[0][case], r[case]):
                for f in a:
                    np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_fleet_mesh_factors_the_world_as_jax_does(lpv_runs):
    """``fleet_mesh`` over 4 ranks gives the agent axis the largest divisor
    of the world size that divides the fleet, as JAX's over 4 devices."""
    import jax
    from colaborativempc_tpu.parallel import fleet_mesh as j_fleet_mesh
    _, _, ranks = lpv_runs
    for n_agents, (shape, names, n_scen) in ranks[0]["fleet_mesh"].items():
        mesh, j_scen = j_fleet_mesh(n_agents, devices=jax.devices()[:4])
        assert shape == tuple(mesh.devices.shape) and n_scen == j_scen
        assert names == ("scen", "agent")


def test_sharded_lpv_step_matches_jax_sharded_step(lpv_runs):
    _, refs, ranks = lpv_runs
    (st, m), (jst, jm) = ranks[0]["f32"], refs["oval"]
    close(st["x_pred"], jst["x_pred"], 5e-4)
    close(st["x0"], jst["x0"], 5e-4)
    np.testing.assert_array_equal(m["feasible"], jm["feasible"])
    assert m["feasible"].all()
    close(m["min_dist"], jm["min_dist"], 1e-3)
    assert st["x_pred"].shape == (2, 4, 9, 9)


def test_sharded_lpv_step_float64_matches_single_process(lpv_runs):
    starts, _, ranks = lpv_runs
    cfg = lpv_cfg("float64")
    track = make_track(cfg.map_type, device="cpu", dtype=F64)
    ref, rm = tsim.make_lpv_fleet_step(track, cfg)(
        port_state(starts["oval"], F64))
    st, m = ranks[0]["f64"]
    for f in tsim.FleetState._fields:
        close(st[f], getattr(ref, f).numpy(), 1e-9)
    for f in tsim.StepMetrics._fields:
        close(m[f], getattr(rm, f).numpy(), 1e-9)
    np.testing.assert_array_equal(m["iterations"], rm.iterations.numpy())


def test_sharded_dynamic_lanes_match_jax(lpv_runs):
    """Oval2 with ``dynamic_lane``: the fleet starts on lane 1 while
    ``cfg.lane`` is 0; the shard-local lane switch keeps every agent on
    lane 1, and the step matches JAX's sharded step."""
    _, refs, ranks = lpv_runs
    (st, m), (jst, jm) = ranks[0]["lanes"], refs["oval2"]
    np.testing.assert_array_equal(st["lane"], jst["lane"])
    assert (st["lane"] == 1).all()
    close(st["x_pred"], jst["x_pred"], 5e-4)
    np.testing.assert_array_equal(m["feasible"], jm["feasible"])


def test_sharded_lpv_rollout_matches_per_step(lpv_runs):
    _, _, ranks = lpv_runs
    (s1, m1), (s2, ms) = ranks[0]["per_step"], ranks[0]["rollout"]
    for f in s1:
        close(s2[f], s1[f], 1e-6)
    assert ms["feasible"].shape == (3, 2, 4)          # (steps, S, n_ag)
    assert ms["min_dist"].shape == (3, 2)
    close(ms["min_dist"][-1], m1["min_dist"], 1e-6)


def flagship_rank(rank, world, rdv, start):
    mesh = join(rank, world, rdv, (2, 1))
    cfg = lpv_cfg(n_agents=3, N=20, iters=300, map_type="Highway")
    cfg = dataclasses.replace(cfg, dt=0.02)
    return sharded_step(mesh, cfg, start, F32)


def test_flagship_fleet_on_a_scenario_split(tmp_path):
    """The flagship shape (3 agents, N=20, ``admm_iters=300``, Highway) on
    a (2, 1) mesh, the fleet whole on each rank: the step equals the
    port's single-process step on the same 2-fleet batch to 1e-6."""
    cfg = dataclasses.replace(
        lpv_cfg(n_agents=3, N=20, iters=300, map_type="Highway"), dt=0.02)
    track = make_track(cfg.map_type, device="cpu")
    base = tsim.init_lpv_fleet(track, cfg, device="cpu")
    start = perturbed({f: np.broadcast_to(
        getattr(base, f).numpy()[None],
        (2,) + tuple(getattr(base, f).shape)).copy()
        for f in tsim.FleetState._fields}, 11)
    ref, rm = tsim.make_lpv_fleet_step(track, cfg)(port_state(start, F32))
    ranks = spawn(flagship_rank, 2, tmp_path, start)
    for st, m in ranks:
        for f in tsim.FleetState._fields:
            close(st[f], getattr(ref, f).numpy(), 1e-6)
        np.testing.assert_array_equal(m["feasible"], rm.feasible.numpy())
        np.testing.assert_array_equal(m["iterations"],
                                      rm.iterations.numpy())


def test_sharded_builders_need_a_process_group():
    """Without an initialised process group a sharded builder raises
    (nothing falls back to the single-process step)."""
    from colaborativempc_tpu_torch.parallel import (
        make_sharded_nl_ocd_step, fleet_mesh,
    )
    cfg = lpv_cfg()
    track = make_track(cfg.map_type, device="cpu")
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_sharded_lpv_step(track, cfg, mesh=object())
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_sharded_lpv_rollout(track, cfg, object(), 2)
    nl = dataclasses.replace(cfg, gains=tcfg.nl_gains())
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_sharded_nl_ocd_step(track, nl, object())
    with pytest.raises(RuntimeError, match="initialised process group"):
        fleet_mesh(4)


class OneRankMesh:
    """Stands for a mesh of one rank."""

    def size(self):
        return 1


def mismatch_rank(rank, world, rdv):
    """In a group of 2 ranks, a builder given a mesh of 1 refuses it."""
    join(rank, world, rdv, (2, 1))
    try:
        make_sharded_lpv_step(make_track("oval", device="cpu"), lpv_cfg(),
                              OneRankMesh())
    except ValueError as e:
        return str(e)
    return None


def test_a_mesh_smaller_than_the_world_raises(tmp_path):
    msgs = spawn(mismatch_rank, 2, tmp_path)
    assert all(m is not None and "holds 1 ranks" in m for m in msgs), msgs
