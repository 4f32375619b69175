"""Parity of the PyTorch port's OCD dual coordination with the JAX package.

Small pieces (bisector planes, the dual step, non-finite containment) on
seeded numpy inputs to 1e-12; then whole control steps of a 3-agent fleet
(N=6) in float64 for every coupling and both sweeps: equal OCD iteration
counts and feasible flags, plans, duals and planes within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colaborativempc_tpu import config as jcfg
from colaborativempc_tpu.geometry import make_track as j_make_track
from colaborativempc_tpu.planners.nl import NLSolution as JNLSolution
from colaborativempc_tpu.runtime import ocd as jocd
from colaborativempc_tpu.utils.precision import x64_island

from colaborativempc_tpu_torch import config as tcfg
from colaborativempc_tpu_torch import interop
from colaborativempc_tpu_torch.parallel import batch_fleet_state
from colaborativempc_tpu_torch.planners.nl import NLSolution
from colaborativempc_tpu_torch.runtime import ocd as tocd
from colaborativempc_tpu_torch.runtime import simulate as tsim

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)

F64 = torch.float64


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol)


def configs(n_agents=3, N=6, coupling="eu", sweep="jacobi", ocd=None,
            dtype="float64", map_type="Highway", **kw):
    args = dict(n_agents=n_agents, N=N, dt=0.02, map_type=map_type,
                coupling=coupling, dtype=dtype, **kw)
    o = dict(dict(max_it_ocd=12, sweep=sweep), **(ocd or {}))
    return (jcfg.ExperimentConfig(
                gains=jcfg.nl_gains(), ocd=jcfg.OCDConfig(**o),
                solver=jcfg.SolverConfig(admm_iters=60, sqp_iters=2), **args),
            tcfg.ExperimentConfig(
                gains=tcfg.nl_gains(), ocd=tcfg.OCDConfig(**o),
                solver=tcfg.SolverConfig(admm_iters=60, sqp_iters=2), **args))


def loop_state(seed, B=None, n=3, N=6):
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    x_pred = rng.normal(size=lead + (n, N + 1, 9))
    x_pred[..., 7] += np.arange(n)[:, None] * 0.3
    lam = rng.normal(size=lead + (n, n, N))
    return dict(x_pred=x_pred, u_pred=rng.normal(size=lead + (n, N, 2)),
                x_old=x_pred, lambdas=lam,
                alpha=rng.uniform(0.1, 0.5, size=lam.shape),
                g_prev=rng.normal(size=lam.shape))


def test_bisector_planes_match_jax():
    st = loop_state(0, B=2)
    with x64_island():
        ref = jax.vmap(jocd._bisector_planes)(jnp.asarray(st["x_pred"]))
    got = tocd._bisector_planes(torch.tensor(st["x_pred"]))
    assert tuple(got.shape) == (2, 3, 3, 6, 2)
    close(got, ref, 1e-12)


@pytest.mark.parametrize("kind", ["fixed", "adaptive", "projected"])
def test_dual_step_matches_jax(kind):
    ocd = dict(fixed=dict(lambda_lo=-np.inf),
               adaptive=dict(adaptive_alpha=True, lambda_lo=-np.inf),
               projected=dict(adaptive_alpha=True, lambda_lo=0.0))[kind]
    st = loop_state(1)
    g = np.random.default_rng(2).normal(size=st["lambdas"].shape)
    with x64_island():
        jst = jocd._OCDLoopState(**{f: jnp.asarray(st.get(f, 0.0))
                                    for f in jocd._OCDLoopState._fields})
        ref = jocd._dual_step(jcfg.OCDConfig(**ocd), jst, jnp.asarray(g))
    tst = tocd._OCDLoopState(**{f: torch.tensor(st.get(f, 0.0))
                                for f in tocd._OCDLoopState._fields})
    got = tocd._dual_step(tcfg.OCDConfig(**ocd), tst, torch.tensor(g))
    close(got[0], ref[0], 1e-12)
    close(got[1], ref[1], 1e-12)
    if kind == "projected":
        assert float(got[0].min()) == 0.0
    else:
        assert float(got[0].min()) < 0.0


def test_contain_nonfinite_matches_jax():
    """A NaN in one agent's solve keeps that agent's previous plan, resets
    its warm state and flags it infeasible; the discarded NaN leaks
    nowhere."""
    rng = np.random.default_rng(3)
    B, n, N, m = 2, 3, 5, 6
    xp, up = rng.normal(size=(B, n, N + 1, 9)), rng.normal(size=(B, n, N, 2))
    sx, su = rng.normal(size=xp.shape), rng.normal(size=up.shape)
    sx[0, 1, 3, 2] = np.nan
    su[1, 2, 0, 1] = np.inf
    w, y = rng.normal(size=(B, n, N, m)), rng.normal(size=(B, n, N, m))
    w[0, 1] = np.nan
    rs = rng.uniform(0.5, 2.0, size=(B, n, m))
    feas = np.array([[True, True, False], [True, True, True]])

    def sol(mod, NS):
        return NS(x_pred=mod.asarray(sx), u_pred=mod.asarray(su),
                  du_pred=None, s_pred=None, feasible=mod.asarray(feas),
                  w=mod.asarray(w), y=mod.asarray(y),
                  rho_scale=mod.asarray(rs), iterations=None, r_prim=None,
                  planes=None)

    class St:
        pass
    jst, tst = St(), St()
    with x64_island():
        jst.x_pred, jst.u_pred = jnp.asarray(xp), jnp.asarray(up)
        ref = jocd._contain_nonfinite(jst, sol(jnp, JNLSolution))
    tst.x_pred, tst.u_pred = torch.tensor(xp), torch.tensor(up)
    got = tocd._contain_nonfinite(tst, sol(torch, NLSolution))
    for g, r in zip(got, ref):
        close(g.numpy().astype(float), np.asarray(r, float), 0)
    assert all(bool(torch.isfinite(t).all()) for t in got[:5])
    assert got[5].tolist() == [[True, False, False], [True, True, False]]


def jax_fleet(jc, seed):
    """A JAX fleet state (float64 island) with perturbed speeds and
    non-zero duals."""
    jt = j_make_track("Highway", dtype=jnp.float64)
    st = jocd.init_nl_fleet(jt, jc)
    rng = np.random.default_rng(seed)
    x0 = np.asarray(st.x0).copy()
    x0[:, 0] += rng.normal(size=x0.shape[0]) * 0.1
    lam = rng.uniform(0.0, 0.5, size=st.lambdas.shape)
    return jt, st._replace(x0=jnp.asarray(x0), lambdas=jnp.asarray(lam))


def step_both(jc, tc, seed, steps=2):
    with x64_island():
        jt, st = jax_fleet(jc, seed)
        tst = batch_fleet_state(interop.ocd_state_from_numpy(st, dtype=F64, device="cpu"),
                                1, device="cpu")
        jstep = jocd.make_nl_ocd_step(jt, jc)
        refs = []
        for _ in range(steps):
            st, m = jstep(st)
            refs.append((st, m))
    tt = interop.track_from_numpy(jt, dtype=F64, device="cpu")
    tstep = tocd.make_nl_ocd_step(tt, tc)
    gots = []
    for _ in range(steps):
        tst, tm = tstep(tst)
        gots.append((tst, tm))
    return gots, refs


@pytest.mark.parametrize("coupling,sweep", [
    ("eu", "jacobi"), ("eu", "gauss_seidel"), ("hp", "jacobi"),
    ("hp_opt", "jacobi"), ("hp_opt", "gauss_seidel")])
def test_ocd_step_matches_jax(coupling, sweep):
    jc, tc = configs(coupling=coupling, sweep=sweep)
    gots, refs = step_both(jc, tc, seed=5)
    for (tst, tm), (st, m) in zip(gots, refs):
        assert int(tm.ocd_iterations[0]) == int(m.ocd_iterations)
        np.testing.assert_array_equal(tm.feasible[0].numpy(),
                                      np.asarray(m.feasible))
        for f in ("x0", "x_pred", "u_pred", "lambdas", "w", "y"):
            close(getattr(tst, f)[0], getattr(st, f), 1e-6)
        # rho multipliers reach ~1e6: compared relative to their size
        np.testing.assert_allclose(tst.rho_scale[0].numpy(),
                                   np.asarray(st.rho_scale), rtol=1e-9)
        for f in ("hold_count", "brake_count", "jam_count"):
            np.testing.assert_array_equal(getattr(tst, f)[0].numpy(),
                                          np.asarray(getattr(st, f)))
        for f in ("min_dist", "min_dist_exec", "lambda_max", "exec_beta"):
            close(getattr(tm, f)[0], getattr(m, f), 1e-6)
    assert int(tm.ocd_iterations[0]) > jc.ocd.min_it_ocd
    assert float(tst.lambdas.abs().max()) > 0.0


def test_single_agent_ocd_step_matches_jax():
    """One agent: the far-away placeholder neighbour with price 0 keeps the
    row count of init_nl_fleet."""
    jc, tc = configs(n_agents=1)
    gots, refs = step_both(jc, tc, seed=6, steps=3)
    for (tst, tm), (st, m) in zip(gots, refs):
        assert tuple(tst.w.shape) == (1, 1, jc.N, 5)
        assert int(tm.ocd_iterations[0]) == int(m.ocd_iterations)
        close(tst.x_pred[0], st.x_pred, 1e-6)
        assert bool(tm.feasible.all())


def test_gauss_seidel_plane_slot_defect_pinned():
    """Known JAX defect, carried over exactly: with three agents the
    Gauss-Seidel sweep hands agent 1 its neighbours in the order (2, 0) but
    writes the refined planes back in the order (0, 2), so pair (0, 1)'s
    plane lands in pair (1, 2)'s canonical slot."""
    jc, tc = configs(coupling="hp_opt", sweep="gauss_seidel")
    with x64_island():
        jt, st = jax_fleet(jc, 7)
        core = jocd._build_ocd_core(jt, jc)
        ls = core[2](st)
        ref = core[1](ls, st.x0, st.u_old)
    tt = interop.track_from_numpy(jt, dtype=F64, device="cpu")
    tcore = tocd._build_ocd_core(tt, tc)
    tstate = batch_fleet_state(interop.ocd_state_from_numpy(st, dtype=F64, device="cpu"), 1,
                               device="cpu")
    tls = tcore.loop_init(tstate)
    got = tcore.iteration(tls, tstate.x0, tstate.u_old)
    close(got.planes[0], ref.planes, 1e-6)
    for pl in (got.planes[0].numpy(), np.asarray(ref.planes)):
        # slot (1, 2) holds the iteration-start plane of pair (0, 1)
        close(pl[1, 2], tls.planes[0, 0, 1].numpy(), 1e-12)


def test_safety_layer_accepts_an_ocd_state():
    """escalate_holds, lateral_wall and separation_filter take the NL
    fleet state as they take the LPV one."""
    _, tc = configs(N=6)
    from colaborativempc_tpu_torch.geometry import make_track
    tt = make_track("Highway", device="cpu", dtype=F64)
    st = batch_fleet_state(tocd.init_nl_fleet(tt, tc, device="cpu"), 2,
                           device="cpu")
    counts = torch.tensor([[0, 3, 6], [1, 0, 9]], dtype=torch.int32)
    st = st._replace(hold_count=counts, w=torch.ones_like(st.w))
    esc = tsim.escalate_holds(tt, tc, st, st.lane)
    assert isinstance(esc, tocd.OCDFleetState)
    reset = (counts >= tc.hold_reset_k)
    assert torch.equal((esc.w == 0).all(-1).all(-1), reset)
    assert esc.hold_count.tolist() == [[0, 3, 0], [1, 0, 0]]
    x_wall, clip = tsim.lateral_wall(tt, tc, st.x0, st.x_pred[:, :, 1],
                                     st.lane)
    x_exec, beta = tsim.separation_filter(tc, st.x0, x_wall)
    assert tuple(x_exec.shape) == (2, 3, 9) and not bool(clip.any())
    assert bool((beta == 1.0).all())


def test_nl_step_refuses_what_is_not_ported_or_unknown():
    """An unknown sweep is refused. ``dynamic_lane``, once refused, runs:
    on Oval2 (two concentric lanes 1 m apart, of different lengths) agent 1
    starts on the inner lane with the outer lane's Frenet entries, switches
    onto it in the first step, and two
    float64 control steps (Jacobi and Gauss-Seidel) equal JAX's, lanes
    included."""
    for sweep in ("jacobi", "gauss_seidel"):
        jc, tc = configs(N=6, sweep=sweep, dynamic_lane=True,
                         map_type="Oval2")
        with x64_island():
            jt = j_make_track("Oval2", dtype=jnp.float64)
            st = jocd.init_nl_fleet(jt, jc)
            x0, xp = np.asarray(st.x0).copy(), np.asarray(st.x_pred).copy()
            for a in (x0, xp):
                th = a[1, ..., 5]
                a[1, ..., 7] -= np.sin(th)
                a[1, ..., 8] += np.cos(th)
            st = st._replace(x0=jnp.asarray(x0), x_pred=jnp.asarray(xp))
            tst = batch_fleet_state(interop.ocd_state_from_numpy(
                st, dtype=F64, device="cpu"), 1, device="cpu")
            jstep = jocd.make_nl_ocd_step(jt, jc)
            refs = []
            for _ in range(2):
                st, m = jstep(st)
                refs.append(jax.tree.map(np.asarray, (st, m)))
        tstep = tocd.make_nl_ocd_step(interop.track_from_numpy(jt, dtype=F64, device="cpu"),
                                      tc)
        for st, m in refs:
            tst, tm = tstep(tst)
            assert int(tm.ocd_iterations[0]) == int(m.ocd_iterations)
            np.testing.assert_array_equal(tst.lane[0].numpy(), st.lane)
            for f in ("x0", "x_pred", "u_pred", "lambdas"):
                close(getattr(tst, f)[0], getattr(st, f), 1e-6)
        assert tst.lane[0].tolist() == [0, 1, 0]
    _, tc = configs(N=6)
    from colaborativempc_tpu_torch.geometry import make_track
    tt = make_track("Highway", device="cpu")
    with pytest.raises(ValueError, match="sweep"):
        tocd.make_nl_ocd_step(tt, tc.__class__(**{
            **tc.__dict__, "ocd": tcfg.OCDConfig(sweep="red_black")}))


@pytest.mark.parametrize("hold", [True, False])
def test_nl_plan_holding_matches_jax(hold):
    """A 2-iteration ADMM budget with eps=1e-6 leaves agent 1 above the
    feasibility tolerance: with hold_on_infeasible it follows its previous
    plan and keeps its warm state while the duals keep their update;
    without it the unconverged plan is executed. Both as in JAX."""
    jc, tc = configs(n_agents=2, N=10, ocd=dict(max_it_ocd=4),
                     hold_on_infeasible=hold)
    sv = dict(admm_iters=2, eps=1e-6, epoch_len=2, sqp_iters=1)
    jc = jc.__class__(**{**jc.__dict__, "solver": jcfg.SolverConfig(**sv)})
    tc = tc.__class__(**{**tc.__dict__, "solver": tcfg.SolverConfig(**sv)})
    gots, refs = step_both(jc, tc, seed=8, steps=3)
    for (tst, tm), (st, m) in zip(gots, refs):
        np.testing.assert_array_equal(tm.feasible[0].numpy(),
                                      np.asarray(m.feasible))
        for f in ("x0", "x_pred", "u_pred", "lambdas", "w", "y"):
            close(getattr(tst, f)[0], getattr(st, f), 1e-6)
        for f in ("hold_count", "jam_count"):
            np.testing.assert_array_equal(getattr(tst, f)[0].numpy(),
                                          np.asarray(getattr(st, f)))
    assert gots[0][1].feasible[0].tolist() == [True, False]
    assert tst.hold_count[0].tolist() == ([0, 3] if hold else [0, 0])


def test_instrumented_step_times_every_iteration():
    """The instrumented step reproduces the fast step and reports one wall
    time per coordination iteration."""
    _, tc = configs(N=6)
    from colaborativempc_tpu_torch.geometry import make_track
    tt = make_track("Highway", device="cpu", dtype=F64)
    st = batch_fleet_state(tocd.init_nl_fleet(tt, tc, device="cpu"), 1,
                           device="cpu")
    fast, fm = tocd.make_nl_ocd_step(tt, tc)(st)
    seen = []
    inst, im, times = tocd.make_nl_ocd_instrumented(tt, tc)(
        st, on_iteration=lambda it, secs, dx: seen.append((it, dx)))
    assert len(times) == int(im.ocd_iterations[0]) == int(fm.ocd_iterations[0])
    assert [it for it, _ in seen] == list(range(1, len(times) + 1))
    for a, b in zip(inst, fast):
        assert torch.equal(a, b)
