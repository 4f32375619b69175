"""Parity of the port's open-loop tools with the JAX package, on the CPU:
the integrators (``step_euler``, ``step_rk4``), the rollouts
(``rollout_euler``, ``rollout_rk4`` with substeps), ``plane_signed_distance``,
system identification (``regression``, ``gbellmf``) and the track outline
of the plotting module; then every plot function, the animation and
``ExperimentIO``'s live plot write their files.

Inputs are made with numpy from a seed and carried into both packages.
Tolerances: float64 1e-9 (the same formulas, agreeing to rounding), float32
1e-5 over a 30-step rollout, ``plane_signed_distance`` 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colaborativempc_tpu.config import ModelParams as JModelParams
from colaborativempc_tpu.dynamics import bicycle as jbicycle
from colaborativempc_tpu.geometry import planes as jplanes
from colaborativempc_tpu.geometry import tracks as jtracks
from colaborativempc_tpu.runtime import plotting as jplotting
from colaborativempc_tpu.utils import rollout as jrollout
from colaborativempc_tpu.utils import sysid as jsysid
from colaborativempc_tpu.utils.precision import x64_island

from colaborativempc_tpu_torch import interop
from colaborativempc_tpu_torch.config import (
    ExperimentConfig, ModelParams, x0_database,
)
from colaborativempc_tpu_torch.dynamics import bicycle as tbicycle
from colaborativempc_tpu_torch.geometry import make_track, planes as tplanes
from colaborativempc_tpu_torch.runtime import io as tio
from colaborativempc_tpu_torch.runtime import plotting as tplotting
from colaborativempc_tpu_torch.utils import gbellmf, regression
from colaborativempc_tpu_torch.utils import rollout as trollout

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)

F64, F32 = torch.float64, torch.float32
TOL = {"float64": 1e-9, "float32": 1e-5}
P, JP = ModelParams(), JModelParams()


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol)


def rand_states(rng, n):
    x = np.zeros((n, 9))
    x[:, 0] = rng.uniform(0.1, 3.0, n)          # both sides of vx = 0.2
    x[:, 1:3] = rng.normal(0.0, 0.1, (n, 2))
    x[:, 3] = rng.uniform(-0.3, 0.3, n)
    x[:, 4:6] = rng.normal(0.0, 0.2, (n, 2))
    x[:, 6] = rng.uniform(0.0, 10.0, n)
    x[:, 7:9] = rng.normal(0.0, 2.0, (n, 2))
    return x


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["step_euler", "step_rk4"])
def test_integrator_step_matches_jax(name, dtype):
    rng = np.random.default_rng(1)
    x, u = rand_states(rng, 16), rng.normal(0.0, 0.3, (16, 2))
    k = rng.uniform(-0.5, 0.5, 16)
    jfn = jax.vmap(getattr(jbicycle, name), in_axes=(0, 0, 0, None, None))
    with x64_island(dtype == "float64"):
        ref = np.asarray(jfn(*(jnp.asarray(a, dtype) for a in (x, u, k)),
                             0.025, JP))
    tdt = getattr(torch, dtype)
    got = getattr(tbicycle, name)(*(torch.tensor(a, dtype=tdt)
                                    for a in (x, u, k)), 0.025, P)
    assert got.dtype == tdt
    close(got, ref, TOL[dtype])


def highway(dtype):
    with x64_island(dtype == "float64"):
        jt = jtracks.make_track("Highway", dtype=getattr(jnp, dtype))
    return jt, interop.track_from_numpy(jt, dtype=getattr(torch, dtype),
                                        device="cpu")


def rollout_inputs(seed, T=30):
    rng = np.random.default_rng(seed)
    x0 = x0_database(1)[0].copy()
    x0[0], x0[6] = 1.5, 1.5
    us = np.stack([rng.normal(0.0, 0.05, T), rng.normal(0.3, 0.3, T)], -1)
    return x0, us


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind,substeps", [("euler", 1), ("rk4", 1),
                                           ("rk4", 4)])
def test_rollout_matches_jax(kind, substeps, dtype):
    """Highway, T=30 at dt 0.025: the trajectory crosses from the straight
    into the first curve (s = 2), so the per-step curvature lookup is
    exercised."""
    jt, tt = highway(dtype)
    x0, us = rollout_inputs(2)
    kw = {} if kind == "euler" else dict(substeps=substeps)
    with x64_island(dtype == "float64"):
        ref = np.asarray(getattr(jrollout, f"rollout_{kind}")(
            jt, jnp.asarray(x0, dtype), jnp.asarray(us, dtype), 0.025, JP,
            **kw))
    tdt = getattr(torch, dtype)
    got = getattr(trollout, f"rollout_{kind}")(
        tt, torch.tensor(x0, dtype=tdt), torch.tensor(us, dtype=tdt), 0.025,
        P, **kw)
    assert got.shape == (31, 9) and got.dtype == tdt
    assert ref[0, 6] < 2.0 < ref[-1, 6]
    close(got, ref, TOL[dtype])


def test_rollout_takes_leading_batch_axes():
    """A batch of starts and input sequences equals each rolled out alone."""
    _, tt = highway("float64")
    starts = [rollout_inputs(s, T=12) for s in (3, 4, 5)]
    x0 = torch.tensor(np.stack([s[0] for s in starts]), dtype=F64)
    x0[:, 6] += torch.tensor([0.0, 3.0, 6.0], dtype=F64)
    us = torch.tensor(np.stack([s[1] for s in starts]), dtype=F64)
    for fn in (trollout.rollout_euler, trollout.rollout_rk4):
        got = fn(tt, x0, us, 0.025, P)
        assert got.shape == (3, 13, 9)
        for b in range(3):
            close(got[b], fn(tt, x0[b], us[b], 0.025, P), 0.0)


def test_rk4_beats_euler():
    """RK4 at dt is closer than Euler to a fine-stepped reference, as in
    the JAX package's own test (tests/test_dynamics.py)."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rand_states(rng, 1)[0], dtype=F64)
    x[0] = 1.5 + abs(float(x[0]))
    u = torch.tensor([0.1, 1.0], dtype=F64)
    k, dt = 0.3, 0.02
    x_fine = x
    for _ in range(100):
        x_fine = tbicycle.step_rk4(x_fine, u, k, dt / 100, P)
    e_euler = float(torch.linalg.norm(tbicycle.step_euler(x, u, k, dt, P)
                                      - x_fine))
    e_rk4 = float(torch.linalg.norm(tbicycle.step_rk4(x, u, k, dt, P)
                                    - x_fine))
    assert e_rk4 < e_euler and e_rk4 < 1e-3


def test_plane_signed_distance_matches_jax():
    rng = np.random.default_rng(5)
    planes = rng.normal(size=(7, 3, 3))
    xy = rng.normal(size=(7, 3, 2))
    with x64_island():
        ref = np.asarray(jplanes.plane_signed_distance(
            jnp.asarray(planes), jnp.asarray(xy)))
        ref_b = np.asarray(jplanes.plane_signed_distance(
            jnp.asarray(planes), jnp.asarray(xy[0, 0])))
    close(tplanes.plane_signed_distance(torch.tensor(planes),
                                        torch.tensor(xy)), ref, 1e-12)
    close(tplanes.plane_signed_distance(torch.tensor(planes),
                                        torch.tensor(xy[0, 0])), ref_b, 1e-12)


def test_regression_matches_jax():
    """Ridge identification of a known linear system from a noisy
    trajectory: (A, B, residual extremes) equal JAX's in float64."""
    rng = np.random.default_rng(6)
    A = np.eye(3) + 0.05 * rng.normal(size=(3, 3))
    B = rng.normal(size=(3, 2))
    u = rng.normal(size=(40, 2))
    x = np.zeros((40, 3))
    x[0] = rng.normal(size=3)
    for k in range(39):
        x[k + 1] = A @ x[k] + B @ u[k] + 1e-3 * rng.normal(size=3)
    with x64_island():
        ref = [np.asarray(r) for r in jsysid.regression(
            jnp.asarray(x), jnp.asarray(u), 1e-6)]
    got = regression(torch.tensor(x), torch.tensor(u), 1e-6)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        close(g, r, 1e-9)
    close(got[0], A, 1e-2)


@pytest.mark.parametrize("b", [0.0, -1.0, 2.0, 0.5])
def test_gbellmf_matches_jax_with_both_zero_branches(b):
    """x == c gives t == 0: 0.5 when b == 0, 0 when b < 0."""
    x = np.array([-1.0, 0.5, 1.0, 1.0, 2.5, 4.0])
    with x64_island():
        ref = np.asarray(jsysid.gbellmf(jnp.asarray(x), 1.5, b, 1.0))
    got = gbellmf(torch.tensor(x), 1.5, b, 1.0)
    close(got, ref, 1e-12)
    if b == 0.0:
        assert float(got[2]) == 0.5
    elif b < 0:
        assert float(got[2]) == 0.0


@pytest.mark.parametrize("name", ["Highway", "Oval2"])
def test_track_outline_matches_jax(name):
    with x64_island():
        jt = jtracks.make_track(name, dtype=jnp.float64)
        lanes = range(jt.n_lanes)
        ref = [jplotting.track_outline(jt, lane, n=200) for lane in lanes]
    tt = make_track(name, device="cpu", dtype=F64)
    for lane, r in zip(lanes, ref):
        got = tplotting.track_outline(tt, lane, n=200)
        assert len(got) == len(r) == 5
        for g, rr in zip(got, r):
            close(g[0], rr[0], 1e-9)
            close(g[1], rr[1], 1e-9)


def states_of_a_run(T=6, n=2):
    rng = np.random.default_rng(8)
    x = np.repeat(x0_database(n)[None], T, axis=0)
    x[:, :, 0] = 1.0
    x[:, :, 6] += np.arange(T)[:, None] * 0.05
    x[:, :, 7] += np.arange(T)[:, None] * 0.05
    return x + 1e-3 * rng.normal(size=x.shape)


def test_plot_functions_write_their_files(tmp_path):
    track = make_track("Highway", device="cpu")
    st = states_of_a_run()
    preds = np.repeat(st[:, :, None], 4, axis=2)
    out = [tplotting.plot_experiment(track, st, path=str(tmp_path),
                                     show_cars_every=2),
           tplotting.plot_experiment(track, torch.tensor(st),
                                     path=str(tmp_path), name="t.png"),
           tplotting.plot_performance(st, 0.025, path=str(tmp_path)),
           tplotting.animate_experiment(track, st, path=str(tmp_path),
                                        preds=preds, every=2)]
    for f, name in zip(out, ["track.png", "t.png", "perf.png", "run.gif"]):
        assert f == str(tmp_path / name) and (tmp_path / name).stat().st_size
    ax = tplotting.plot_track(track, lanes=[0])
    assert ax.get_xlabel() == "x [m]"
    tplotting.pyplot().close(ax.figure)
    cx, cy = tplotting.car_polygon(1.0, 2.0, 0.0)
    close(cx, [1.2, 1.2, 0.8, 0.8], 1e-12)
    close(cy, [2.1, 1.9, 1.9, 2.1], 1e-12)


def test_experiment_io_live_plot_every(tmp_path):
    """``live_plot_every=2`` writes live.png on the second step, not the
    first, with the track built on the CPU."""
    from types import SimpleNamespace
    cfg = ExperimentConfig(n_agents=2, N=4, map_type="Highway", verb=0)
    io = tio.ExperimentIO(cfg, path=str(tmp_path), live_plot_every=2)
    st = states_of_a_run(T=3)
    for it in range(3):
        state = SimpleNamespace(x0=st[it], u_old=np.zeros((2, 2)),
                                x_pred=np.repeat(st[it][:, None], 5, 1),
                                u_pred=np.zeros((2, 4, 2)))
        io.update(it, state, SimpleNamespace(), 0.01)
        assert (tmp_path / "live.png").exists() == (it >= 1)
    assert io._track.s0.device.type == "cpu"
