"""Parity of the PyTorch port's LPV planner, safety layer and fleet rollout
with the JAX package, and pins of the two JAX reference defects the port
carries over on purpose.

Inputs come from numpy seeds and reach the port through
``colaborativempc_tpu_torch.interop``. Tolerances: 1e-9 for the float64 QP
assembly and the safety layer (same formulas, rounding only); 1e-8 for the
float64 solves; the whole slice at B=2 x 3 agents, N=8, admm_iters=100, 3
steps within 1e-6 in float64 (identical feasible / hold / brake counts) and
within 1e-3 in float32 (equal feasible flags) — float32 rounding can move a
problem's convergence across the eps test by one epoch, which shifts its
plan by up to the solver tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colaborativempc_tpu import config as jcfg
from colaborativempc_tpu.geometry import make_track as j_make_track
from colaborativempc_tpu.geometry import planes as jplanes
from colaborativempc_tpu.parallel import batch_fleet_state as j_batch
from colaborativempc_tpu.planners import lpv as jlpv
from colaborativempc_tpu.runtime import simulate as jsim
from colaborativempc_tpu.utils.precision import x64_island

from colaborativempc_tpu_torch import config as tcfg
from colaborativempc_tpu_torch import interop
from colaborativempc_tpu_torch.geometry import planes as tplanes
from colaborativempc_tpu_torch.parallel import batch_fleet_state
from colaborativempc_tpu_torch.planners import lpv as tlpv
from colaborativempc_tpu_torch.runtime import simulate as tsim

F32, F64 = torch.float32, torch.float64


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol)


def configs(dtype="float64", n_agents=3, N=10, iters=100, **kw):
    args = dict(n_agents=n_agents, N=N, dt=0.02, map_type="Highway",
                dtype=dtype, **kw)
    return (jcfg.ExperimentConfig(gains=jcfg.lpv_gains(),
                                  solver=jcfg.SolverConfig(admm_iters=iters),
                                  **args),
            tcfg.ExperimentConfig(gains=tcfg.lpv_gains(),
                                  solver=tcfg.SolverConfig(admm_iters=iters),
                                  **args))


def jax_fleet(cfg, seed=0, scale=0.05):
    """JAX track and a perturbed initial fleet (float64 island)."""
    jt = j_make_track("Highway", dtype=jnp.float64)
    st = jsim.init_lpv_fleet(jt, cfg)
    rng = np.random.default_rng(seed)
    dx = jnp.asarray(rng.normal(size=st.x_pred.shape) * scale)
    return jt, st._replace(x_pred=st.x_pred + dx)


def plan_inputs_jax(cfg, st, limits):
    ns = jnp.asarray(jsim._neighbour_index(cfg.n_agents))
    agents_xy = jnp.swapaxes(st.x_pred[:, :, 7:9], 0, 1)
    neigh = jnp.swapaxes(agents_xy[:, ns, :], 0, 1)
    N = cfg.N
    planes = jax.vmap(lambda e, q: jplanes.compute_hyperplanes(
        e[:N], q[:N], keep_sign=True))(st.x_pred[..., 7:9], neigh)
    weights = jax.vmap(lambda e, q, md: jplanes.separation_weights(
        e[1:], q[1:], md)[0])(st.x_pred[..., 7:9], neigh, limits.min_dist)
    return neigh, planes, weights


def test_build_lpv_qp_matches_jax():
    jc, tc = configs()
    with x64_island():
        jt, st = jax_fleet(jc)
        lim = jsim._per_agent_limits(jc)
        neigh, planes, weights = plan_inputs_jax(jc, st, lim)
        ref = jax.jit(jax.vmap(lambda l, xl, ul, pl, w: jlpv.build_lpv_qp(
            jt, jc.gains, l, jc.model, jc.N, jc.dt, xl, ul, pl, w)))(
                lim, st.x_pred, st.u_pred, planes, weights)
    tt = interop.track_from_numpy(jt, dtype=F64)
    fs = interop.fleet_state_from_numpy(st, dtype=F64)
    tneigh = torch.tensor(np.asarray(neigh))
    tpl = tplanes.compute_hyperplanes(fs.x_pred[:, :tc.N, 7:9],
                                      tneigh[:, :tc.N])
    tw, _ = tplanes.separation_weights(
        fs.x_pred[:, 1:, 7:9], tneigh[:, 1:],
        tsim._per_agent_limits(tc, "cpu").min_dist[:, None, None])
    close(tpl, planes, 1e-9)
    close(tw, weights, 1e-9)
    qp = tlpv.build_lpv_qp(tt, interop.gains_from_numpy(jc.gains, dtype=F64),
                           tsim._per_agent_limits(tc, "cpu"), tc.model, tc.N,
                           tc.dt, fs.x_pred, fs.u_pred, tpl, tw)
    got, want = interop.stage_qp_to_numpy(qp), ref
    for f in ("D", "E", "lo", "hi", "soft_lo", "soft_hi"):
        close(got[f], getattr(want, f), 1e-9)
    for f in ("F", "G", "d"):
        close(got["dyn"][f], getattr(want.dyn, f), 1e-9)
    for f in ("Q", "q", "R", "r", "S"):
        close(got["cost"][f], getattr(want.cost, f), 1e-9)
    # the float32 cast of the limits reaches the QP: sm = 0.9 is inexact
    assert float(qp.hi[0, 0, 1]) == float(np.float32(0.9)) * 0.75


@pytest.mark.parametrize("n_agents", [1, 3])
def test_lpv_solve_matches_jax(n_agents):
    jc, tc = configs(n_agents=n_agents)
    with x64_island():
        jt, st = jax_fleet(jc, seed=3)
        lim = jsim._per_agent_limits(jc)
        neigh = plan_inputs_jax(jc, st, lim)[0] if n_agents > 1 else None

        def one(l, x0, xl, ul, uo, w, y, rs, nb):
            return jlpv.lpv_solve(jt, jc.gains, l, jc.model, jc.N, jc.dt,
                                  x0, xl, ul, uo,
                                  nb if n_agents > 1 else None, w0=w, y0=y,
                                  rho_scale0=rs, admm_iters=100)
        ref = jax.jit(jax.vmap(one))(
            lim, st.x0, st.x_pred, st.u_pred, st.u_old, st.w, st.y,
            st.rho_scale, neigh if n_agents > 1 else jnp.zeros(n_agents))
    tt = interop.track_from_numpy(jt, dtype=F64)
    fs = interop.fleet_state_from_numpy(st, dtype=F64)
    got = tlpv.lpv_solve(
        tt, tc.gains, tsim._per_agent_limits(tc, "cpu"), tc.model, tc.N,
        tc.dt, fs.x0, fs.x_pred, fs.u_pred, fs.u_old,
        None if neigh is None else torch.tensor(np.asarray(neigh)),
        w0=fs.w, y0=fs.y, rho_scale0=fs.rho_scale, admm_iters=100)
    for f in ("x_pred", "u_pred", "du_pred", "s_pred", "planes", "w", "y",
              "rho_scale", "r_prim"):
        close(getattr(got, f), getattr(ref, f), 1e-8)
    np.testing.assert_array_equal(got.feasible.numpy(),
                                  np.asarray(ref.feasible))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))


def _safety_inputs(seed):
    """Three fleets of 4 agents packed near each other, candidates moving
    into one another; lateral / velocity / heading fields out of bounds on
    some agents."""
    rng = np.random.default_rng(seed)
    B, n = 3, 4
    x_cur = np.zeros((B, n, 9))
    x_cur[..., 0] = rng.uniform(0.5, 2.0, size=(B, n))
    x_cur[..., 3] = rng.uniform(-0.3, 0.3, size=(B, n))
    x_cur[..., 6] = rng.uniform(2.0, 3.0, size=(B, n))
    x_cur[..., 7] = x_cur[..., 6] + rng.normal(size=(B, n)) * 0.05
    x_cur[..., 8] = 1.5 + x_cur[..., 3]
    x_cur[0, 1, 6] = x_cur[0, 2, 6]                 # priority tie
    x_cand = x_cur.copy()
    x_cand[..., 0] += rng.normal(size=(B, n)) * 2.0
    x_cand[..., 1] = rng.normal(size=(B, n)) * 4.0
    x_cand[..., 2] = rng.normal(size=(B, n)) * 10.0
    x_cand[..., 3] += rng.normal(size=(B, n)) * 1.5
    x_cand[..., 4] = rng.normal(size=(B, n)) * 3.0
    x_cand[..., 6] += rng.uniform(-0.2, 0.4, size=(B, n))
    centre = x_cur[..., 7:9].mean(axis=1, keepdims=True)
    x_cand[..., 7:9] += 0.6 * (centre - x_cur[..., 7:9])
    return x_cur, x_cand


def test_safety_layer_matches_jax():
    jc, tc = configs(n_agents=4)
    x_cur, x_cand = _safety_inputs(61)
    lanes = np.zeros(x_cur.shape[:2], np.int32)
    counts = np.array([[0, 2, 3, 7]] * 3, np.int32)
    with x64_island():
        jt = j_make_track("Highway", dtype=jnp.float64)
        xc, xe = jnp.asarray(x_cur), jnp.asarray(x_cand)
        ref_wall = jax.jit(jax.vmap(lambda a, b, ln: jsim.lateral_wall(
            jt, jc, a, b, ln)))(xc, xe, jnp.asarray(lanes))
        ref_filt = jax.jit(jax.vmap(
            lambda a, b: jsim.separation_filter(jc, a, b)))(xc, ref_wall[0])
        ref_vx = jsim.hold_vx_scale(jc, jnp.asarray(counts), jnp.float64)
        _, st = jax_fleet(jc, seed=4)
        st = j_batch(st, 3)._replace(
            x0=xc, hold_count=jnp.asarray(counts),
            brake_count=jnp.asarray(counts[:, ::-1]),
            w=jnp.ones((3, 4, jc.N, 7)), y=jnp.ones((3, 4, jc.N, 7)))
        ref_esc = jax.jit(lambda s, ln: jsim.escalate_holds(jt, jc, s, ln))(
            st, jnp.asarray(lanes))
    tt = interop.track_from_numpy(jt, dtype=F64)
    wall = tsim.lateral_wall(tt, tc, torch.tensor(x_cur),
                             torch.tensor(x_cand), torch.tensor(lanes))
    close(wall[0], ref_wall[0], 1e-9)
    np.testing.assert_array_equal(wall[1].numpy(), np.asarray(ref_wall[1]))
    assert bool(wall[1].any()) and not bool(wall[1].all())
    filt = tsim.separation_filter(tc, torch.tensor(x_cur), wall[0])
    close(filt[0], ref_filt[0], 1e-9)
    close(filt[1], ref_filt[1], 1e-9)
    assert float(filt[1].min()) < 1.0            # the filter binds
    close(tsim.hold_vx_scale(tc, torch.tensor(counts), F64), ref_vx, 0)
    esc = tsim.escalate_holds(tt, tc, interop.fleet_state_from_numpy(
        st, dtype=F64), torch.tensor(lanes))
    for f in tsim.FleetState._fields:
        close(getattr(esc, f), getattr(ref_esc, f), 1e-9)


def _rollouts(dtype_name, B=2, steps=3, N=8, iters=100):
    jc, tc = configs(dtype=dtype_name, N=N, iters=iters)
    with x64_island(dtype_name == "float64"):
        jdt = jnp.float64 if dtype_name == "float64" else jnp.float32
        jt = j_make_track("Highway", dtype=jdt)
        st = j_batch(jsim.init_lpv_fleet(jt, jc), B)
        rng = np.random.default_rng(0)
        dx = rng.normal(size=st.x0.shape) * 0.02
        st = st._replace(x0=st.x0 + jnp.asarray(dx, st.x0.dtype))
        ref = jax.vmap(jsim.make_lpv_fleet_rollout(jt, jc, steps))(st)
    tdt = F64 if dtype_name == "float64" else F32
    tt = interop.track_from_numpy(jt, dtype=tdt)
    got = tsim.make_lpv_fleet_rollout(tt, tc, steps)(
        interop.fleet_state_from_numpy(st, dtype=tdt))
    return got, ref


@pytest.mark.parametrize("dtype_name,tol", [("float64", 1e-6),
                                            ("float32", 1e-3)])
def test_fleet_rollout_matches_jax(dtype_name, tol):
    (fin, (xh, uh, m)), (jfin, (jxh, juh, jm)) = _rollouts(dtype_name)
    close(fin.x_pred, jfin.x_pred, tol)
    close(xh, jxh, tol)
    close(uh, juh, tol)
    np.testing.assert_array_equal(m.feasible.numpy(), np.asarray(jm.feasible))
    if dtype_name == "float64":
        for f in ("hold_count", "brake_count", "jam_count"):
            np.testing.assert_array_equal(getattr(fin, f).numpy(),
                                          np.asarray(getattr(jfin, f)))
        np.testing.assert_array_equal(m.iterations.numpy(),
                                      np.asarray(jm.iterations))
        close(m.min_dist_exec, jm.min_dist_exec, tol)
        close(m.exec_beta, jm.exec_beta, tol)
    assert tuple(xh.shape) == (2, 3, 3, 9)


def test_fleet_entry_points_batch_and_refuse_unported_paths():
    _, tc = configs(dtype="float32", N=8)
    from colaborativempc_tpu_torch.geometry import make_track
    tt = make_track("Highway", device="cpu")
    base = tsim.init_lpv_fleet(tt, tc, device="cpu")
    st = batch_fleet_state(base, 3, device="cpu")
    assert tuple(st.x_pred.shape) == (3, 3, 9, 9)
    assert st.x0.data_ptr() != base.x0.data_ptr()
    st.x0[0, 0, 0] += 1.0                      # scenarios are copies
    assert float(st.x0[1, 0, 0]) == float(base.x0[0, 0])
    with pytest.raises(NotImplementedError):
        tsim.make_lpv_fleet_step(
            tt, tc.__class__(**{**tc.__dict__, "dynamic_lane": True}))
    with pytest.raises(NotImplementedError):
        tsim.make_lpv_fleet_step(tt, tc.__class__(**{
            **tc.__dict__, "solver": tcfg.SolverConfig(assoc=True)}))


def test_lateral_wall_s_clamp_defect_pinned():
    """Known JAX defect, carried over exactly: the s-clamp is detected on
    the re-added absolute s_cur + (s_cand - s_cur), which can differ from
    s_cand by one ulp, so a candidate inside the envelope counts as clamped
    and has its (X, Y) rebuilt."""
    jc, tc = configs(dtype="float32", n_agents=1)
    rng = np.random.default_rng(7)
    for _ in range(1000):
        # s_cand - s_cur is inexact when s_cand < s_cur / 2 (Sterbenz); a
        # small backward step near s = 0 stays inside the arc-advance bound
        sc = np.float32(rng.uniform(0.12, 0.2))
        se = np.float32(rng.uniform(sc - 0.1, sc / 2))
        if np.float32(sc + np.float32(se - sc)) != se:
            break
    else:
        pytest.fail("no rounding case found")
    x_cur = np.array([[1.0, 0, 0, 0.1, 0, 0, sc, 0, 1.6]], np.float32)
    x_cand = np.array([[1.0, 0, 0, 0.1, 0, 0, se, 0.5, 1.6]], np.float32)
    jt = j_make_track("Highway")
    ref_x, ref_c = jsim.lateral_wall(jt, jc, jnp.asarray(x_cur),
                                     jnp.asarray(x_cand),
                                     jnp.zeros(1, jnp.int32))
    tt = interop.track_from_numpy(jt, dtype=F32)
    got_x, got_c = tsim.lateral_wall(tt, tc, torch.tensor(x_cur),
                                     torch.tensor(x_cand),
                                     torch.zeros(1, dtype=torch.int32))
    assert bool(ref_c[0]) and bool(got_c[0])
    assert float(got_x[0, 6]) != float(se)      # s moved by one ulp
    close(got_x, ref_x, 1e-6)


def test_degraded_escape_finiteness_defect_pinned(monkeypatch):
    """Known JAX defect, carried over exactly: the degraded-execution
    escape (jam_count >= hold_exec_k) checks only x_pred / u_pred for
    finiteness, then adopts the solve's w even when it is not finite."""
    jc, tc = configs(dtype="float32", N=8)

    def j_fake(track, gains, limits, model, N, dt, x0, x_lin, u_lin, u_old,
               neighbours_xy, w0=None, y0=None, rho_scale0=None, **kw):
        return jlpv.LPVSolution(
            x_pred=x_lin, u_pred=u_lin, du_pred=jnp.zeros_like(u_lin),
            s_pred=jnp.zeros((N, 3), x_lin.dtype),
            planes=jnp.zeros((N, 2, 3), x_lin.dtype),
            feasible=jnp.asarray(False), w=jnp.full_like(w0, jnp.nan),
            y=y0, rho_scale=rho_scale0, iterations=jnp.asarray(100),
            r_prim=jnp.asarray(1.0, x_lin.dtype))

    def t_fake(track, gains, limits, model, N, dt, x0, x_lin, u_lin, u_old,
               neighbours_xy, w0=None, y0=None, rho_scale0=None, **kw):
        P = x_lin.shape[0]
        return tlpv.LPVSolution(
            x_pred=x_lin, u_pred=u_lin, du_pred=torch.zeros_like(u_lin),
            s_pred=x_lin.new_zeros((P, N, 3)),
            planes=x_lin.new_zeros((P, N, 2, 3)),
            feasible=torch.zeros(P, dtype=torch.bool),
            w=torch.full_like(w0, torch.nan), y=y0, rho_scale=rho_scale0,
            iterations=torch.full((P,), 100),
            r_prim=x_lin.new_ones((P,)))

    monkeypatch.setattr(jsim, "lpv_solve", j_fake)
    monkeypatch.setattr(tsim, "lpv_solve", t_fake)
    jt = j_make_track("Highway")
    jam = np.array([0, jc.hold_exec_k, jc.hold_exec_k + 5], np.int32)
    st = jsim.init_lpv_fleet(jt, jc)._replace(jam_count=jnp.asarray(jam))
    ref, _ = jsim.make_lpv_fleet_step(jt, jc)(st)
    tt = interop.track_from_numpy(jt, dtype=F32)
    tst = batch_fleet_state(interop.fleet_state_from_numpy(st, dtype=F32), 1)
    got, _ = tsim.make_lpv_fleet_step(tt, tc)(tst)
    adopted = np.array([False, True, True])
    for w in (np.asarray(ref.w), got.w[0].numpy()):
        assert np.array_equal(np.isnan(w).all(axis=(1, 2)), adopted)
    close(got.x_pred[0], ref.x_pred, 1e-6)
