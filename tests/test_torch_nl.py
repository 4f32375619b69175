"""Parity of the PyTorch port's nonlinear SQP planner with the JAX package.

The same numpy inputs (a perturbed 3-agent fleet on the Highway track,
random positive coupling prices, bisector planes) go through the JAX
functions, vmapped over agents, and the port's batched ones. Tolerances:
1e-9 for the float64 linearisation and QP assembly (same formulas; the
port's Jacobian is analytic where JAX differentiates, so rounding only);
1e-6 for float64 SQP solves; 1e-3 for float32 solves, whose ADMM runs may
end an epoch apart on a problem at the tolerance edge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colaborativempc_tpu import config as jcfg
from colaborativempc_tpu.geometry import curvature as j_curvature
from colaborativempc_tpu.geometry import make_track as j_make_track
from colaborativempc_tpu.planners import nl as jnl
from colaborativempc_tpu.runtime import ocd as jocd
from colaborativempc_tpu.runtime import simulate as jsim
from colaborativempc_tpu.utils.precision import x64_island

from colaborativempc_tpu_torch import config as tcfg
from colaborativempc_tpu_torch import interop
from colaborativempc_tpu_torch.geometry import curvature
from colaborativempc_tpu_torch.planners import nl as tnl
from colaborativempc_tpu_torch.runtime import simulate as tsim

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol)


def configs(dtype="float64", n_agents=3, N=8, coupling="eu"):
    args = dict(n_agents=n_agents, N=N, dt=0.02, map_type="Highway",
                coupling=coupling, dtype=dtype)
    return (jcfg.ExperimentConfig(gains=jcfg.nl_gains(), **args),
            tcfg.ExperimentConfig(gains=tcfg.nl_gains(), **args))


def nl_inputs(jc, seed=0):
    """Per-agent SQP inputs as numpy arrays, built with the JAX package:
    a perturbed warm-start fleet, its neighbour plans, positive prices,
    master masks and the canonical bisector planes."""
    jdt = jnp.float64 if jc.dtype == "float64" else jnp.float32
    jt = j_make_track("Highway", dtype=jdt)
    st = jocd.init_nl_fleet(jt, jc)
    n, N = jc.n_agents, jc.N
    rng = np.random.default_rng(seed)
    x_bar = np.asarray(st.x_pred) + rng.normal(size=st.x_pred.shape) * 0.03
    u_bar = rng.normal(size=st.u_pred.shape) * 0.05
    ns = jsim._neighbour_index(n)
    ids = np.arange(n)
    neigh = np.swapaxes(np.swapaxes(x_bar[:, :, 7:9], 0, 1)[:, ns], 0, 1)
    lambdas = rng.uniform(0.0, 2.0, size=(n, n, N))
    planes = np.asarray(jocd._bisector_planes(jnp.asarray(x_bar)))
    return dict(
        track=jt, x0=x_bar[:, 0], x_bar=x_bar, u_bar=u_bar,
        u_old=rng.normal(size=(n, 2)) * 0.05,
        lam=lambdas[ids[:, None], ns], neigh=neigh,
        mmask=(ids[:, None] < ns).astype(np.float32),
        planes=planes[np.minimum(ids[:, None], ns),
                      np.maximum(ids[:, None], ns)])


def torch_args(inp, dtype):
    t = lambda k: torch.tensor(inp[k], dtype=dtype)  # noqa: E731
    return dict(x_bar=t("x_bar"), u_bar=t("u_bar"), lambdas=t("lam"),
                neigh_xy=t("neigh"),
                master_mask=torch.tensor(inp["mmask"]), planes0=t("planes"))


def test_linearize_horizon_matches_jax():
    jc, tc = configs()
    with x64_island():
        inp = nl_inputs(jc, seed=1)
        xb = inp["x_bar"][:, :jc.N].copy()
        xb[0, :3, 0] = 0.1         # below the low-velocity switch
        kap = jax.vmap(lambda s: j_curvature(inp["track"], s))(
            jnp.asarray(xb[..., 6]))
        ref = jax.jit(jax.vmap(lambda x, u, k: jnl._linearize_horizon(
            x, u, k, jc.dt, jc.model)))(jnp.asarray(xb),
                                        jnp.asarray(inp["u_bar"]), kap)
    tt = interop.track_from_numpy(inp["track"], dtype=F64, device="cpu")
    x, u = torch.tensor(xb), torch.tensor(inp["u_bar"])
    got = tnl._linearize_horizon(x, u, curvature(tt, x[..., 6]), tc.dt,
                                 tc.model)
    for g, r in zip(got, ref):
        close(g, r, 1e-9)
    # the analytic Jacobian is the derivative of the ported model
    from colaborativempc_tpu_torch.dynamics import f_continuous
    k = curvature(tt, x[1, 4, 6])
    jx = torch.autograd.functional.jacobian(
        lambda v: v + tc.dt * f_continuous(v, u[1, 4], k, tc.model), x[1, 4])
    close(got[0][1, 4], jx, 1e-12)


@pytest.mark.parametrize("coupling", ["eu", "hp", "hp_opt"])
def test_build_nl_qp_matches_jax(coupling):
    jc, tc = configs(coupling=coupling)
    with x64_island():
        inp = nl_inputs(jc, seed=2)
        lim = jsim._per_agent_limits(jc)
        ref = jax.jit(jax.vmap(lambda l, xb, ub, lam, nb, mm, pl:
                               jnl.build_nl_qp(
                                   inp["track"], jc.gains, l, jc.model,
                                   jc.N, jc.dt, xb, ub, lam, nb, mm,
                                   coupling=coupling, planes0=pl)))(
            lim, *(jnp.asarray(inp[k]) for k in
                   ("x_bar", "u_bar", "lam", "neigh", "mmask", "planes")))
    tt = interop.track_from_numpy(inp["track"], dtype=F64, device="cpu")
    qp = tnl.build_nl_qp(tt, tc.gains, tsim._per_agent_limits(tc, "cpu"),
                         tc.model, tc.N, tc.dt, coupling=coupling,
                         **torch_args(inp, F64))
    got = interop.stage_qp_to_numpy(qp)
    nc = 2 + (4 if coupling == "hp_opt" else 0)
    assert got["E"].shape == (3, tc.N, 10 if coupling == "hp_opt" else 6, nc)
    for f in ("D", "E", "lo", "hi", "soft_lo", "soft_hi"):
        close(got[f], getattr(ref, f), 1e-9)
    for f in ("F", "G", "d"):
        close(got["dyn"][f], getattr(ref.dyn, f), 1e-9)
    for f in ("Q", "q", "R", "r", "S"):
        close(got["cost"][f], getattr(ref.cost, f), 1e-9)


def test_build_nl_qp_takes_per_problem_gains():
    """A gain battery hands every problem its own gains: each problem's QP
    equals the JAX QP built with that problem's gains."""
    jc, tc = configs(coupling="eu")
    grid = [jcfg.nl_gains()._replace(q=jcfg.nl_gains().q.at[3].set(v),
                                     dr=jcfg.nl_gains().dr * s)
            for v, s in ((150.0, 1.0), (300.0, 0.5), (600.0, 2.0))]
    with x64_island():
        inp = nl_inputs(jc, seed=3)
        lim = jsim._per_agent_limits(jc)
        gstack = jax.tree.map(lambda *xs: jnp.stack(xs), *grid)
        ref = jax.jit(jax.vmap(lambda g, l, xb, ub, lam, nb, mm:
                               jnl.build_nl_qp(
                                   inp["track"], g, l, jc.model, jc.N,
                                   jc.dt, xb, ub, lam, nb, mm)))(
            gstack, lim, *(jnp.asarray(inp[k]) for k in
                           ("x_bar", "u_bar", "lam", "neigh", "mmask")))
    tt = interop.track_from_numpy(inp["track"], dtype=F64, device="cpu")
    gains = interop.gains_from_numpy(
        {f: np.stack([np.asarray(getattr(g, f)) for g in grid])
         for f in ("q", "qs", "r", "dr", "wq")}, dtype=F64, device="cpu")
    assert tuple(gains.q.shape) == (3, 9)
    args = torch_args(inp, F64)
    args.pop("planes0")
    qp = tnl.build_nl_qp(tt, gains, tsim._per_agent_limits(tc, "cpu"),
                         tc.model, tc.N, tc.dt, **args)
    close(qp.cost.Q, ref.cost.Q, 1e-9)
    close(qp.cost.R, ref.cost.R, 1e-9)
    close(qp.cost.q, ref.cost.q, 1e-9)


def _solve_both(jc, tc, inp, tdt, admm_iters=100, sqp_iters=2):
    with x64_island(jc.dtype == "float64"):
        lim = jsim._per_agent_limits(jc)
        n, N = jc.n_agents, jc.N
        m = 4 + (3 * (n - 1) if jc.coupling == "hp_opt" else n - 1)
        ref = jax.jit(jax.vmap(lambda l, x0, xb, ub, uo, lam, nb, mm, pl:
                               jnl.nl_solve(
                                   inp["track"], jc.gains, l, jc.model, N,
                                   jc.dt, x0, xb, ub, uo, lam, nb, mm,
                                   sqp_iters=sqp_iters, coupling=jc.coupling,
                                   admm_iters=admm_iters, planes0=pl)))(
            lim, *(jnp.asarray(inp[k], jnp.float64 if jc.dtype == "float64"
                               else jnp.float32) for k in
                   ("x0", "x_bar", "u_bar", "u_old", "lam", "neigh")),
            jnp.asarray(inp["mmask"]), jnp.asarray(inp["planes"]))
    tt = interop.track_from_numpy(inp["track"], dtype=tdt, device="cpu")
    got = tnl.nl_solve(
        tt, tc.gains, tsim._per_agent_limits(tc, "cpu"), tc.model, tc.N,
        tc.dt, torch.tensor(inp["x0"], dtype=tdt),
        u_old=torch.tensor(inp["u_old"], dtype=tdt),
        sqp_iters=sqp_iters, coupling=tc.coupling, admm_iters=admm_iters,
        **torch_args(inp, tdt))
    assert tuple(got.w.shape) == (n, N, m)
    return got, ref


@pytest.mark.parametrize("coupling", ["eu", "hp", "hp_opt"])
def test_nl_solve_matches_jax_float64(coupling):
    jc, tc = configs(coupling=coupling)
    with x64_island():
        inp = nl_inputs(jc, seed=4)
    got, ref = _solve_both(jc, tc, inp, F64)
    for f in ("x_pred", "u_pred", "du_pred", "s_pred", "w", "y",
              "rho_scale", "r_prim", "planes"):
        close(getattr(got, f), getattr(ref, f), 1e-6)
    np.testing.assert_array_equal(got.feasible.numpy(),
                                  np.asarray(ref.feasible))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    if coupling == "hp_opt":     # the masters moved their planes
        assert float((got.planes - torch.tensor(inp["planes"])).abs().max()) > 0


@pytest.mark.parametrize("coupling", ["eu", "hp_opt"])
def test_nl_solve_matches_jax_float32(coupling):
    jc, tc = configs(dtype="float32", coupling=coupling)
    inp = nl_inputs(jc, seed=5)
    got, ref = _solve_both(jc, tc, inp, F32)
    close(got.x_pred, ref.x_pred, 1e-3)
    close(got.u_pred, ref.u_pred, 1e-3)
    np.testing.assert_array_equal(got.feasible.numpy(),
                                  np.asarray(ref.feasible))
