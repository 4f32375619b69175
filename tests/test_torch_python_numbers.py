"""Python numbers at the port's public functions keep their float64 value.

A function that turns a Python number or list into a tensor must make it
in the target dtype at once: ``torch.as_tensor(0.1).to(torch.float64)``
passes through float32 and gives 0.10000000149011612, where JAX (and
``torch.as_tensor(0.1, dtype=torch.float64)``) give 0.1. Each case hands
Python numbers to one such site and holds the port to the JAX package in
float64 on the CPU:

* ``build_mpcc_qp`` with ``MPCCGains()`` of Python floats (its gain
  columns): every field within 1e-12 of its scale, the cost diagonals
  equal to 1e-12 relative;
* ``scale_stage_qp`` with ``tz`` / ``tc`` as lists;
* ``cartesian_to_frenet`` with float ``x``, ``y``, ``psi``;
* ``project_on_spline`` with float ``x``, ``y``, ``s_guess``;
* ``mpcc_solve`` with ``rho_scale0=0.1``: the plans, ``w`` and the final
  ``rho_scale`` within 1e-12 of their scale after one SQP iteration of 40
  ADMM iterations, the scaled dual ``y`` within 1e-11 (its sums amplify
  rounding: 5.9e-13 measured). With the float32 round trip the plans sat
  5.9e-10 away.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colaborativempc_tpu.geometry import frenet as jfrenet
from colaborativempc_tpu.geometry import make_track as j_make_track
from colaborativempc_tpu.geometry import spline as jspl
from colaborativempc_tpu.ops import admm as jadmm
from colaborativempc_tpu.ops import lqr as jlqr
from colaborativempc_tpu.planners import mpcc as jmpcc
from colaborativempc_tpu.runtime import racing as jrace
from colaborativempc_tpu.dynamics import pacejka as jpac
from colaborativempc_tpu.utils.precision import x64_island

from colaborativempc_tpu_torch import interop
from colaborativempc_tpu_torch.dynamics import pacejka as tpac
from colaborativempc_tpu_torch.geometry import frenet as tfrenet
from colaborativempc_tpu_torch.geometry import spline as tspl
from colaborativempc_tpu_torch.ops import admm as tadmm
from colaborativempc_tpu_torch.ops import lqr as tlqr
from colaborativempc_tpu_torch.planners import mpcc as tmpcc

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)

F64 = torch.float64
REL = 1e-12


def close_to_scale(got, ref, rel=REL):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref)
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    scale = max(1.0, float(np.abs(ref[fin]).max())) if fin.any() else 1.0
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=rel * scale)


def tracks(name):
    with x64_island():
        jt = j_make_track(name, dtype=jnp.float64)
    return jt, interop.track_from_numpy(jt, dtype=F64, device="cpu")


def guesses(N):
    """A rough forward guess of one race on oval_mt: states along the
    centreline at 1.5 m/s, small inputs."""
    rng = np.random.default_rng(3)
    xb = np.zeros((1, N + 1, 9))
    xb[0, :, 3] = 1.5
    xb[0, :, 6] = 0.5 + 0.075 * np.arange(N + 1)
    ub = 0.05 * rng.normal(size=(1, N, 2))
    ub[..., 1] += 0.3
    return xb, ub


def mpcc_qps(N=8, dt=0.05):
    jt, tt = tracks("oval_mt")
    xb, ub = guesses(N)
    with x64_island():
        s = jnp.asarray(xb[0, :, 6])
        X, Y, th = jfrenet.frenet_to_cartesian(jt, s, 0.0 * s, 0)
        xb[0, :, 7], xb[0, :, 8], xb[0, :, 5] = X, Y, th
        ref = jmpcc.build_mpcc_qp(jt, jmpcc.MPCCGains(), jpac.PacejkaParams(),
                                  N, dt, jnp.asarray(xb[0]),
                                  jnp.asarray(ub[0]))
    got = tmpcc.build_mpcc_qp(tt, tmpcc.MPCCGains(), tpac.PacejkaParams(),
                              N, dt, torch.tensor(xb), torch.tensor(ub))
    return ref, got


def case_build_mpcc_qp():
    ref, got = mpcc_qps()
    for f in ("Q", "R"):
        g = torch.diagonal(getattr(got.cost, f)[0], dim1=-2, dim2=-1)
        r = np.diagonal(np.asarray(getattr(ref.cost, f)), axis1=-2, axis2=-1)
        np.testing.assert_allclose(g.numpy(), r, rtol=REL, atol=0)
    flat = interop.to_numpy(got)
    for part in ("dyn", "cost"):
        for f, v in flat[part].items():
            close_to_scale(v[0], getattr(getattr(ref, part), f))
    for f in ("D", "E", "lo", "hi", "soft_lo", "soft_hi"):
        close_to_scale(flat[f][0], getattr(ref, f))


def case_scale_stage_qp():
    rng = np.random.default_rng(4)
    P, N, nz, nc, mr = 2, 5, 11, 2, 7
    shapes = dict(F=(P, N, nz, nz), G=(P, N, nz, nc), d=(P, N, nz),
                  Q=(P, N + 1, nz, nz), q=(P, N + 1, nz), R=(P, N, nc, nc),
                  r=(P, N, nc), S=(P, N, nz, nc), D=(P, N, mr, nz),
                  E=(P, N, mr, nc))
    a = {k: rng.normal(size=v) for k, v in shapes.items()}
    a["lo"], a["hi"] = -np.ones((P, N, mr)), np.ones((P, N, mr))
    tz = [0.1 * (i + 1) for i in range(nz)]
    tc = [0.3, 0.7]

    def qp(mod, lqr, t):
        return mod.StageQP(
            dyn=lqr.LQRDynamics(t(a["F"]), t(a["G"]), t(a["d"])),
            cost=lqr.LQRCost(t(a["Q"]), t(a["q"]), t(a["R"]), t(a["r"]),
                             t(a["S"])),
            D=t(a["D"]), E=t(a["E"]), lo=t(a["lo"]), hi=t(a["hi"]))
    with x64_island():
        ref = jax.vmap(lambda q: jadmm.scale_stage_qp(
            q, jnp.asarray(tz), jnp.asarray(tc)))(
            qp(jadmm, jlqr, lambda x: jnp.asarray(x)))
    got = tadmm.scale_stage_qp(qp(tadmm, tlqr, torch.tensor), tz, tc)
    for part in ("dyn", "cost"):
        for f in getattr(got, part)._fields:
            close_to_scale(getattr(getattr(got, part), f),
                           getattr(getattr(ref, part), f))
    for f in ("D", "E"):
        close_to_scale(getattr(got, f), getattr(ref, f))


def case_cartesian_to_frenet():
    jt, tt = tracks("Oval2")
    with x64_island():
        X, Y, th = jfrenet.frenet_to_cartesian(jt, jnp.asarray(3.1), 0.05, 0)
    x, y, psi = float(X) + 0.01, float(Y) - 0.01, float(th) + 0.1
    with x64_island():
        ref = jfrenet.cartesian_to_frenet(jt, x, y, psi, lane=0)
    got = tfrenet.cartesian_to_frenet(tt, x, y, psi, lane=0)
    assert bool(got[3]) and bool(ref[3])
    for g, r in zip(got[:3], ref[:3]):
        close_to_scale(g, r)


def case_project_on_spline():
    jt, tt = tracks("oval_mt")
    with x64_island():
        X, Y, _ = jfrenet.frenet_to_cartesian(jt, jnp.asarray(1.7), 0.1, 0)
    x, y, s_guess = float(X) + 0.01, float(Y) - 0.02, 1.6
    with x64_island():
        ref = jspl.project_on_spline(jt, x, y, s_guess)
    got = tspl.project_on_spline(tt, x, y, s_guess)
    close_to_scale(got, ref)


def case_mpcc_solve_rho_scale0():
    """Warm SQP inputs of one race after 3 steps of a float64 JAX race from
    a cold start (cold guesses give ill-conditioned QPs, whose float64
    solves differ by far more than rounding between two packages)."""
    jt, tt = tracks("oval_mt")
    N, dt = 8, 0.05
    jc = jmpcc.MPCCConfig(N=N, dt=dt, admm_iters=100)
    with x64_island():
        st = jrace.init_mpcc(jt, jc)
        st = jax.tree.map(lambda a: a.astype(jnp.float64)
                          if jnp.issubdtype(a.dtype, jnp.floating) else a, st)
        step = jrace.make_mpcc_step(jt, jc)
        for _ in range(3):
            st, _ = step(st)
        x0 = jrace._relocalize_unwrapped(jt, st.x)
        xb, ub = jrace._warm_guess(jt, jc, x0, st.x_bar, st.u_bar)
        x0, xb, ub, uo = (np.asarray(v)[None] for v in (x0, xb, ub, st.u_old))
    kw = dict(admm_iters=40, sqp_iters=1, rho_scale0=0.1)
    with x64_island():
        ref = jmpcc.mpcc_solve(jt, jmpcc.MPCCGains(), jpac.PacejkaParams(),
                               N, dt, *(jnp.asarray(v[0])
                                        for v in (x0, xb, ub, uo)), **kw)
    got = tmpcc.mpcc_solve(tt, tmpcc.MPCCGains(), tpac.PacejkaParams(), N,
                           dt, *(torch.tensor(v) for v in (x0, xb, ub, uo)),
                           **kw)
    for f in ("x_pred", "u_pred", "w", "rho_scale"):
        close_to_scale(getattr(got, f)[0], getattr(ref, f))
    close_to_scale(got.y[0], ref.y, 1e-11)
    np.testing.assert_array_equal(got.iterations.numpy()[0],
                                  np.asarray(ref.iterations))


CASES = {
    "build_mpcc_qp": case_build_mpcc_qp,
    "scale_stage_qp": case_scale_stage_qp,
    "cartesian_to_frenet": case_cartesian_to_frenet,
    "project_on_spline": case_project_on_spline,
    "mpcc_solve_rho_scale0": case_mpcc_solve_rho_scale0,
}


@pytest.mark.parametrize("site", sorted(CASES))
def test_python_numbers_match_jax_in_float64(site):
    CASES[site]()
