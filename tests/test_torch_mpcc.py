"""Parity of the PyTorch port's MPCC racing family with the JAX package:
the racing stage QP and its normalisation, the SQP solve, the closed-loop
race with its failure ladder, the gain battery and the JSON config
surface (the Pacejka model and the spline tables are in
tests/test_torch_pacejka_spline.py).

The same numpy inputs (seeded) go through both packages on the CPU. The
JAX side runs in float64 inside ``x64_island``; the port's functions are
batched over a leading race axis where JAX vmaps. Tolerances: 1e-9 (and
1e-12 relative) for the float64 QP assembly, 1e-6 for float64 solves and
closed-loop races, 1e-3 for float32 solves.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colaborativempc_tpu.dynamics import pacejka as jpac
from colaborativempc_tpu.geometry import make_track as j_make_track
from colaborativempc_tpu.ops import admm as jadmm
from colaborativempc_tpu.planners import mpcc as jmpcc
from colaborativempc_tpu.runtime import battery as jbat
from colaborativempc_tpu.runtime import racing as jrace
from colaborativempc_tpu.utils.precision import x64_island

from colaborativempc_tpu_torch import interop
from colaborativempc_tpu_torch.dynamics import pacejka as tpac
from colaborativempc_tpu_torch.geometry import make_track
from colaborativempc_tpu_torch.ops import admm as tadmm
from colaborativempc_tpu_torch.planners import mpcc as tmpcc
from colaborativempc_tpu_torch.runtime import battery as tbat
from colaborativempc_tpu_torch.runtime import racing as trace

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
JP, TP = jpac.PacejkaParams(), tpac.PacejkaParams()


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol)


def jdtype(dtype):
    return jnp.float64 if dtype == F64 else jnp.float32


def tracks(name="oval_mt", dtype=F64):
    with x64_island():
        jt = j_make_track(name, dtype=jdtype(dtype))
    return jt, interop.track_from_numpy(jt, dtype=dtype, device="cpu")


def race_configs(**kw):
    return jmpcc.MPCCConfig(**kw), tmpcc.MPCCConfig(**kw)


def jax_state(jc, jt, dtype):
    st = jrace.init_mpcc(jt, jc)
    return jax.tree.map(lambda a: a.astype(jdtype(dtype))
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, st)


def warm_inputs(rng, N, track):
    """SQP inputs of two races as numpy arrays, as the racing step forms
    them: the relocalised plant state, the warm guess and the last input
    after 3 and 6 steps of a float64 JAX race from a cold start, the input
    guess perturbed (sigma 0.03)."""
    x0, xb, ub, uo = _race_states(N)
    return x0, xb, ub + rng.normal(size=ub.shape) * 0.03, uo


@functools.lru_cache(maxsize=None)
def _race_states(N):
    jc = jmpcc.MPCCConfig(N=N, admm_iters=100)
    picks = []
    with x64_island():
        track = j_make_track("oval_mt", dtype=jnp.float64)
        st = jax_state(jc, track, F64)
        step = jrace.make_mpcc_step(track, jc)
        for k in range(6):
            st, _ = step(st)
            if k in (2, 5):
                x0 = jrace._relocalize_unwrapped(track, st.x)
                xb, ub = jrace._warm_guess(track, jc, x0, st.x_bar, st.u_bar)
                picks.append([np.asarray(v) for v in (x0, xb, ub, st.u_old)])
    return tuple(np.stack(v) for v in zip(*picks))


def test_build_mpcc_qp_and_scaling_match_jax():
    """The 7-row racing QP and its normalisation (``scale_stage_qp``) equal
    JAX's in float64, for shared and per-race gains."""
    jt, tt = tracks()
    rng = np.random.default_rng(7)
    N, dt = 8, 0.05
    x0, xb, ub, _ = warm_inputs(rng, N, jt)
    gains = [jmpcc.MPCCGains(), jmpcc.MPCCGains(q_contour=120.0,
                                                q_progress=2.0, w_soft=3e3)]
    norm = jmpcc.MPCCNormalization.default(dt)
    with x64_island():
        gstack = jax.tree.map(lambda *v: jnp.asarray(v), *gains)
        tz, tc = (v.astype(jnp.float64) for v in (norm.t_z, norm.t_du))

        def build(xb, ub, g):
            qp = jmpcc.build_mpcc_qp(jt, g, JP, N, dt, xb, ub)
            return qp, jadmm.scale_stage_qp(qp, tz, tc)
        both = jax.jit(jax.vmap(build))(xb, ub, gstack)
    refs, scaled = ([jax.tree.map(lambda a: a[b], r) for b in range(2)]
                    for r in both)
    tg = tmpcc.MPCCGains(*(torch.tensor([a, b], dtype=F64)
                           for a, b in zip(*gains)))
    got = tmpcc.build_mpcc_qp(tt, tg, TP, N, dt, torch.tensor(xb),
                              torch.tensor(ub))
    tn = interop.mpcc_normalization_from_numpy(norm)
    got_s = tadmm.scale_stage_qp(got, tn.t_z, tn.t_du)
    for b in range(2):
        for g, r in ((got, refs[b]), (got_s, scaled[b])):
            flat = interop.to_numpy(g)
            ref = jax.tree.map(np.asarray, r._asdict())
            for f in ("D", "E", "lo", "hi", "soft_lo", "soft_hi"):
                np.testing.assert_allclose(flat[f][b], ref[f], rtol=1e-12,
                                           atol=1e-9)
            for part in ("dyn", "cost"):
                for f, v in flat[part].items():
                    np.testing.assert_allclose(
                        v[b], np.asarray(getattr(getattr(r, part), f)),
                        rtol=1e-12, atol=1e-9)


def test_cold_start_qps_match_jax():
    """The epoch's MPCC inputs of three cold-started races spread over
    oval_mt (cold guess, 7-row racing QP, normalisation) equal JAX's in
    float32 within 1e-3 of each array's scale."""
    N = 8
    jc, tc = race_configs(N=N)
    qp, z0 = trace.cold_start_qps(make_track("oval_mt", device="cpu"), tc, 3)
    assert qp.lo.shape == (3, N, 7) and z0.shape == (3, 11)
    norm = jc.normalization()
    x0 = (z0 * tc.normalization().t_z)[:, :9].numpy()
    jt = j_make_track("oval_mt")

    def build(x0):
        xb, ub = jrace._cold_guess(jt, jc, x0)
        return jadmm.scale_stage_qp(
            jmpcc.build_mpcc_qp(jt, jc.gains, jc.model, N, jc.dt, xb, ub,
                                jc.bounds), norm.t_z, norm.t_du)
    ref = jax.vmap(build)(jnp.asarray(x0))
    flat = interop.to_numpy(qp)
    for f in ("D", "E", "lo", "hi"):
        r = np.asarray(getattr(ref, f))
        fin = np.isfinite(r)
        assert np.array_equal(np.isfinite(flat[f]), fin)
        close(flat[f][fin], r[fin], 1e-3 * max(1.0, np.abs(r[fin]).max()))
    for part in ("dyn", "cost"):
        for f, v in flat[part].items():
            r = np.asarray(getattr(getattr(ref, part), f))
            close(v, r, 1e-3 * max(1.0, np.abs(r).max()))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("assoc", [False, True])
def test_mpcc_solve_matches_jax(normalize, assoc):
    """The SQP solve of two races, normalised and raw, with the sequential
    and the associative affine solve: float64 within 1e-6 with equal ADMM
    iteration counts and failure counts, float32 within 1e-3."""
    jt, tt = tracks()
    rng = np.random.default_rng(11)
    N, dt = 8, 0.05
    x0, xb, ub, uo = warm_inputs(rng, N, jt)
    norm = jmpcc.MPCCNormalization.default(dt) if normalize else None
    kw = dict(admm_iters=120, assoc=assoc, sqp_iters=2)
    for dtype, tol in ((F64, 1e-6), (F32, 1e-3)):
        jd = jdtype(dtype)
        with x64_island(dtype == F64):
            jtd = jt if dtype == F64 else j_make_track("oval_mt")
            ref = jax.vmap(lambda *a: jmpcc.mpcc_solve(
                jtd, jmpcc.MPCCGains(), JP, N, dt, *a, norm=norm, **kw))(
                *(jnp.asarray(v, jd) for v in (x0, xb, ub, uo)))
        tn = None if norm is None else interop.mpcc_normalization_from_numpy(
            norm)
        got = tmpcc.mpcc_solve(
            interop.track_from_numpy(jt, dtype=dtype, device="cpu"),
            interop.mpcc_gains_from_numpy(jmpcc.MPCCGains()),
            interop.pacejka_from_numpy(JP), N, dt,
            *(torch.tensor(v, dtype=dtype) for v in (x0, xb, ub, uo)),
            bounds=interop.mpcc_bounds_from_numpy(jmpcc.MPCCBounds()),
            norm=tn, **kw)
        for f in ("x_pred", "u_pred", "w", "y"):
            # relative to the array's scale: raw solves reach O(1e3)
            r = np.asarray(getattr(ref, f))
            close(getattr(got, f), r, tol * max(1.0, np.abs(r).max()))
        assert np.array_equal(got.feasible.numpy(), np.asarray(ref.feasible))
        if dtype == F64:
            np.testing.assert_array_equal(got.iterations.numpy(),
                                          np.asarray(ref.iterations))
            np.testing.assert_array_equal(got.sqp_fails.numpy(),
                                          np.asarray(ref.sqp_fails))


def test_race_from_cold_start_matches_jax():
    """A 10-step closed-loop race from a cold start (projection, guesses,
    SQP, RK4 plant): float64 states within 1e-6 of JAX
    ``make_mpcc_rollout``, equal ADMM iterations, feasible flags and
    resets."""
    jc, tc = race_configs(N=8, admm_iters=100)
    steps = 10
    with x64_island():
        jt = j_make_track("oval_mt", dtype=jnp.float64)
        st = jax_state(jc, jt, F64)
        jfin, jm = jrace.make_mpcc_rollout(jt, jc, steps)(st)
        jfin, jm = jax.tree.map(np.asarray, (jfin, jm))
    tt = interop.track_from_numpy(jt, dtype=F64, device="cpu")
    fin, m = trace.make_mpcc_rollout(tt, tc, steps)(
        interop.mpcc_state_from_numpy(st, dtype=F64, device="cpu"))
    for f in ("x", "x_bar", "u_bar", "u_old", "w", "y"):
        close(getattr(fin, f)[0], getattr(jfin, f), 1e-6)
    for f in ("iterations", "feasible", "reset", "sqp_fails"):
        np.testing.assert_array_equal(getattr(m, f)[0].numpy(),
                                      getattr(jm, f))
    close(m.s[0], jm.s, 1e-6)
    assert tuple(m.s.shape) == (1, steps) and float(m.s[0, -1]) > 0.3


def test_failure_reset_path_matches_jax():
    """tests/test_mpcc.py:252 on both packages: a poisoned warm guess makes
    every QP fail; the plant stays finite on the held input, the guess is
    invalidated, the next step cold-starts and the race recovers — with the
    same states and counters in float64."""
    jc, tc = race_configs(N=8, n_sqp=2, n_reset=1, admm_iters=60)
    with x64_island():
        jt = j_make_track("oval_mt", dtype=jnp.float64)
        jstep = jrace.make_mpcc_step(jt, jc)
        st = jax_state(jc, jt, F64)
        for _ in range(3):
            st, _ = jstep(st)
        st = st._replace(x_bar=st.x_bar * jnp.nan)
        jtrace = []
        for _ in range(4):
            st, jm = jstep(st)
            jtrace.append(jax.tree.map(np.asarray, (st, jm)))
    tt = interop.track_from_numpy(jt, dtype=F64, device="cpu")
    tstep = trace.make_mpcc_step(tt, tc)
    with x64_island():
        tst = interop.mpcc_state_from_numpy(jax_state(jc, jt, F64),
                                            dtype=F64, device="cpu")
    for _ in range(3):
        tst, _ = tstep(tst)
    tst = tst._replace(x_bar=tst.x_bar * torch.nan)
    for k, (js, jm) in enumerate(jtrace):
        tst, m = tstep(tst)
        close(tst.x[0], js.x, 1e-6)
        for f in ("valid_guess", "n_non_solves"):
            assert getattr(tst, f)[0].item() == getattr(js, f).item()
        for f in ("sqp_fails", "reset"):
            assert getattr(m, f)[0].item() == getattr(jm, f).item()
        if k == 0:
            assert int(m.sqp_fails[0]) == tc.n_sqp
            assert not bool(tst.valid_guess[0])
        if k == 1:
            assert bool(m.reset[0]) and bool(tst.valid_guess[0])
    assert bool(torch.isfinite(tst.x).all())


def test_mpcc_battery_matches_jax_and_standalone_races():
    """``run_mpcc_battery`` on 4 configs x 10 steps in float64 against the
    JAX battery's own pieces (its float32 gain grid through
    ``_make_mpcc_step_fn`` vmapped over races); then each race of the
    float32 battery equals its standalone run (per-race ADMM freeze)."""
    cfg_kw = dict(N=8, admm_iters=80)
    jc, tc = race_configs(**cfg_kw)
    jgrid = jbat.mpcc_gain_grid(jmpcc.MPCCGains(), q_contour=[20.0, 120.0],
                                q_progress=[0.5, 2.0])
    tgrid = tbat.mpcc_gain_grid(tmpcc.MPCCGains(), q_contour=[20.0, 120.0],
                                q_progress=[0.5, 2.0])
    steps = 10
    with x64_island():
        jt = j_make_track("oval_mt", dtype=jnp.float64)
    tt = interop.track_from_numpy(jt, dtype=F64, device="cpu")
    st0 = interop.to_numpy(trace.init_mpcc(tt, tc, races=4, dtype=F64,
                                           device="cpu"))
    with x64_island():
        gains = jax.tree.map(lambda *xs: jnp.stack(
            [jnp.asarray(x, jnp.float32) for x in xs]), *jgrid)
        step_fn = jrace._make_mpcc_step_fn(jt, jc)

        def race(g, st):
            return jax.lax.scan(lambda s, _: step_fn(g, s), st, None,
                                length=steps)
        jst0 = jrace.MPCCState(**{k: jnp.asarray(v) for k, v in st0.items()})
        jfin, jm = jax.tree.map(np.asarray, jax.jit(jax.vmap(race))(gains,
                                                                    jst0))
    res = tbat.run_mpcc_battery(tc, tgrid, steps, track=tt, dtype=F64,
                                device="cpu")
    close(res.s_hist, jm.s.T, 1e-6)
    close(res.ey_hist, jm.ey.T, 1e-6)
    close(res.progress, jfin.x[:, 6], 1e-6)
    np.testing.assert_array_equal(res.feasible_frac, jm.feasible.mean(1))
    np.testing.assert_array_equal(res.resets, jm.reset.sum(1) - 1)
    assert res.n_configs == 4 and np.isnan(res.lap_time).all()

    t32 = make_track("oval_mt", device="cpu")
    both = tbat.run_mpcc_battery(tc, tgrid[1:3], 5, track=t32, device="cpu")
    for i, g in enumerate(tgrid[1:3]):
        alone = tbat.run_mpcc_battery(tc, [g], 5, track=t32, device="cpu")
        close(both.s_hist[:, i], alone.s_hist[:, 0], 1e-6)
        close(both.ey_hist[:, i], alone.ey_hist[:, 0], 1e-6)


def _reference_layout(tmp_path):
    params = tmp_path / "Params"
    params.mkdir()
    files = dict(
        model=dict(m=0.05, Iz=3e-5, E_long=0.8, maxAlpha=0.5, Cm1=0.3),
        cost=dict(qC=40.0, qMu=3.0, qVs=2.0, rdDelta=0.004, rdD=0.002,
                  sc_quad_track=200.0),
        bounds=dict(deltau=0.3, Dl=-0.2, Du=0.9, vxl=0.1),
        normalization=dict(vx=4.0, s=25.0, dDelta=10.0, D=1.0))
    for name, d in files.items():
        (params / f"{name}.json").write_text(json.dumps(d))
    (params / "track.json").write_text(json.dumps(dict(X=[0, 1], Y=[0, 1])))
    master = dict(Ts=0.04, n_sqp=2, n_reset=4, sqp_mixing=0.75, n_sim=90,
                  v0=0.8, model_path="Params/model.json",
                  cost_path="Params/cost.json",
                  bounds_path="Params/bounds.json",
                  track_path="Params/track.json",
                  normalization_path="Params/normalization.json")
    (params / "config.json").write_text(json.dumps(master))
    return str(params / "config.json")


def test_mpcc_config_from_json_both_layouts(tmp_path):
    """The reference master layout (model/cost/bounds/normalization/track
    files) loads to the JAX package's config, and the flat layout round
    trips across both packages."""
    path = _reference_layout(tmp_path)
    ref = jmpcc.mpcc_config_from_json(path, N=12)
    got = tmpcc.mpcc_config_from_json(path, N=12)
    assert dataclasses_equal(got, ref)
    close(got.normalization().t_z, ref.normalization().t_z, 0.0)
    close(got.normalization().t_du, ref.normalization().t_du, 0.0)

    flat = str(tmp_path / "flat.json")
    cfg = tmpcc.MPCCConfig(N=14, dt=0.04, map_type="oval",
                           gains=tmpcc.MPCCGains(q_contour=33.0),
                           bounds=tmpcc.MPCCBounds(delta_max=0.3),
                           model=tpac.PacejkaParams(m=0.05), assoc=True)
    tmpcc.mpcc_config_to_json(cfg, flat)
    assert tmpcc.mpcc_config_from_json(flat) == cfg
    assert dataclasses_equal(cfg, jmpcc.mpcc_config_from_json(flat))
    jflat = str(tmp_path / "jflat.json")
    jmpcc.mpcc_config_to_json(jmpcc.mpcc_config_from_json(flat), jflat)
    assert tmpcc.mpcc_config_from_json(jflat) == cfg
    for N, assoc in ((60, None), (20, None), (60, False), (20, True)):
        t, j = (c(N=N, assoc=assoc) for c in (tmpcc.MPCCConfig,
                                              jmpcc.MPCCConfig))
        assert t.resolved_assoc() == j.resolved_assoc()
        assert t.resolved_epoch_len() == j.resolved_epoch_len()


def dataclasses_equal(got, ref) -> bool:
    """Equal on every field of the port's config. The JAX config's one
    other field is ``unroll``, a scan option of XLA the port has no use
    for."""
    import dataclasses
    a, b = dataclasses.asdict(got), dataclasses.asdict(ref)
    assert set(b) - set(a) == {"unroll"} and set(a) <= set(b)
    del b["unroll"]
    for k in ("gains", "bounds", "model"):
        a[k] = tuple(float(v) for v in getattr(got, k))
        b[k] = tuple(float(v) for v in getattr(ref, k))
    return a == b


def test_run_mpcc_experiment_and_save(tmp_path):
    """The host loop: n_sim steps, every state finite, the reference CSV
    schema under <path>/csv/0/, and the same first steps as the rollout."""
    cfg = tmpcc.MPCCConfig(N=8, n_sim=4, save_data=True, admm_iters=60,
                           path=str(tmp_path / "mpcc"))
    track = make_track("oval_mt", device="cpu")
    res = trace.run_mpcc_experiment(cfg, track=track, device="cpu")
    assert res.steps == 4 and np.isfinite(res.states).all()
    assert res.resets.tolist() == [True, False, False, False]
    states = np.loadtxt(tmp_path / "mpcc" / "csv" / "0" / "states.dat")
    assert states.shape == (4, 9)
    fin, _ = trace.make_mpcc_rollout(track, cfg, 4)(
        trace.init_mpcc(track, cfg, device="cpu"))
    close(res.states[-1], fin.x[0], 1e-6)


def test_rejected_qp_blend_defect_pinned(monkeypatch):
    """Known JAX defect, carried over exactly: a non-finite QP solution is
    rejected (mixing weight 0, splitting state kept, counted as a failure),
    but the blend ``mix * x_new + (1 - mix) * x_lin`` gives 0 * nan = nan,
    so the rejected solution still poisons the SQP iterate. The racing step's
    finiteness check then holds the previous plan (mpc.cpp:255-258)."""
    jt, tt = tracks()
    x0, xb, ub, uo = warm_inputs(np.random.default_rng(3), 8, jt)
    j_orig, t_orig = jmpcc.admm_solve, tmpcc.admm_solve
    monkeypatch.setattr(jmpcc, "admm_solve", lambda *a, **k: (
        lambda s: s._replace(z=s.z * jnp.nan))(j_orig(*a, **k)))
    monkeypatch.setattr(tmpcc, "admm_solve", lambda *a, **k: (
        lambda s: s._replace(z=s.z * torch.nan))(t_orig(*a, **k)))
    w0 = np.full((8, 7), 0.25)
    with x64_island():
        ref = jmpcc.mpcc_solve(jt, jmpcc.MPCCGains(), JP, 8, 0.05,
                               *(jnp.asarray(v[0]) for v in (x0, xb, ub, uo)),
                               sqp_iters=2, admm_iters=30,
                               w0=jnp.asarray(w0))
    got = tmpcc.mpcc_solve(tt, tmpcc.MPCCGains(), TP, 8, 0.05,
                           *(torch.tensor(v[:1]) for v in (x0, xb, ub, uo)),
                           sqp_iters=2, admm_iters=30,
                           w0=torch.tensor(w0[None]))
    for x in (np.asarray(ref.x_pred), got.x_pred[0].numpy()):
        assert np.isnan(x).all()
    close(got.w[0], w0, 0)
    close(ref.w, w0, 0)
    assert int(got.sqp_fails[0]) == int(ref.sqp_fails) == 2
