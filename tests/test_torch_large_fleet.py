"""Parity of the PyTorch port with the JAX package at fleet sizes past the
CUDA kernels' former limits (32 rows, 32 controls, 8 neighbours): the
plain versions that the kernels are held to on the card, on the CPU.

- ``build_nl_qp``, eu with 9 neighbours (10 agents) and hp_opt with 10
  (11 agents: nc = 22, m = 34), N=5: float64 within 1e-9, as
  ``test_torch_nl.py`` (same formulas, rounding only).
- ``admm_solve``'s plain path against JAX's XLA ``admm_solve``, at an LPV
  stage of 35 rows (32 agents) and hp_opt's nc = 22, m = 34, N=5:
  float64 within 1e-6.
- ``admm_epoch_batched_plain`` against JAX's Pallas
  ``admm_epoch_batched(interpret=True)`` at mr = 35 and at nc = 34, mr = 52
  (17 agents), P=2, N=4: float32 within the tolerances
  ``test_torch_ops.py`` holds the epoch twin to (1e-3 on z, c, w, y, 1e-4
  on the residuals).
- One LPV fleet step of 32 agents (B=1, N=5) and one NL-OCD eu step of 10
  agents (N=5), float64, within 1e-6 with equal feasible flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colaborativempc_tpu.geometry import make_track as j_make_track
from colaborativempc_tpu.ops import admm as jadmm
from colaborativempc_tpu.ops.pallas_lqr import admm_epoch_batched as j_epoch
from colaborativempc_tpu.parallel import batch_fleet_state as j_batch
from colaborativempc_tpu.planners import nl as jnl
from colaborativempc_tpu.runtime import ocd as jocd
from colaborativempc_tpu.runtime import simulate as jsim
from colaborativempc_tpu.utils.precision import x64_island

from test_torch_nl import configs as nl_configs
from test_torch_nl import nl_inputs, torch_args
from test_torch_ocd import configs as ocd_configs
from test_torch_ocd import jax_fleet as ocd_fleet
from test_torch_fleet import configs as lpv_configs
from test_torch_ops import constrained_problem, jax_qp, port_qp, stack

from colaborativempc_tpu_torch import interop
from colaborativempc_tpu_torch.ops import admm as tadmm
from colaborativempc_tpu_torch.ops import cuda_lqr
from colaborativempc_tpu_torch.parallel import batch_fleet_state
from colaborativempc_tpu_torch.planners import nl as tnl
from colaborativempc_tpu_torch.runtime import ocd as tocd
from colaborativempc_tpu_torch.runtime import simulate as tsim

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("coupling,agents", [("eu", 10), ("hp_opt", 11)])
def test_build_nl_qp_matches_jax_past_eight_neighbours(coupling, agents):
    jc, tc = nl_configs(n_agents=agents, N=5, coupling=coupling)
    with x64_island():
        inp = nl_inputs(jc, seed=12)
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
    nb = agents - 1
    nc = 2 + (2 * nb if coupling == "hp_opt" else 0)
    m = 4 + (3 * nb if coupling == "hp_opt" else nb)
    assert got["E"].shape == (agents, 5, m, nc)
    for f in ("D", "E", "lo", "hi", "soft_lo", "soft_hi"):
        close(got[f], getattr(ref, f), 1e-9)
    for f in ("F", "G", "d"):
        close(got["dyn"][f], getattr(ref.dyn, f), 1e-9)
    for f in ("Q", "q", "R", "r", "S"):
        close(got["cost"][f], getattr(ref.cost, f), 1e-9)


@pytest.mark.parametrize("nc,m", [(2, 35), (22, 34)])
def test_admm_solve_matches_jax_past_32_rows_and_controls(nc, m):
    """float64, iters=150, rho=5, eps=1e-6, epoch_len=25, 2 problems of
    N=5 with 11 states: the solution (z, c, w) within 1e-6, iteration
    counts and feasible flags equal. As in ``test_torch_ops.py``, the
    scaled duals are not compared: the port's explicit Quu_inv and JAX's
    Cholesky solves round apart, and where a row's dual residual is near
    zero the adaptive rho carries that into y (here 5e-5 of y's size at
    nc=22, while z, c and w agree to 1e-10)."""
    rng = np.random.default_rng(61 + nc)
    pb = stack([constrained_problem(rng, N=5, nz=11, nc=nc, m=m)
                for _ in range(2)])
    kw = dict(iters=150, rho=5.0, eps=1e-6, epoch_len=25)
    with x64_island():
        ref = jax.vmap(lambda qp, z0: jadmm.admm_solve(qp, z0, **kw))(
            jax_qp(pb, jnp.float64), jnp.asarray(pb["z0"]))
    got = tadmm.admm_solve(port_qp(pb, F64), torch.tensor(pb["z0"]), **kw)
    assert tuple(got.w.shape) == (2, 5, m)
    for f in ("z", "c", "w"):
        close(getattr(got, f), getattr(ref, f), 1e-6)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.feasible.numpy(),
                                  np.asarray(ref.feasible))


@pytest.mark.parametrize("nc,mr", [(2, 35), (34, 52)])
def test_plain_epoch_twin_matches_pallas_interpret_past_32(nc, mr):
    EL, RHO, ALPHA = 25, 10.0, 1.6
    rng = np.random.default_rng(70 + mr)
    probs, w0s, y0s = [], [], []
    for _ in range(2):
        p = constrained_problem(rng, N=4, nz=11, nc=nc, m=mr)
        probs.append(p)
        w0s.append(np.clip(rng.normal(size=(4, mr)) * 0.1, p["lo"], p["hi"]))
        y0s.append(rng.normal(size=(4, mr)) * 0.05)
    pb, w0, y0 = stack(probs), np.stack(w0s), np.stack(y0s)
    data = jax.vmap(lambda qp: jadmm.admm_epoch_inputs(qp, rho=RHO))(
        jax_qp(pb, jnp.float32))
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    ref = j_epoch(data, f32(pb["z0"]), f32(w0), f32(y0), epoch_len=EL,
                  alpha=ALPHA, interpret=True)
    tdata = interop.epoch_data_from_numpy(data, dtype=F32, device="cpu")
    t32 = lambda a: torch.tensor(a, dtype=F32)  # noqa: E731
    got = cuda_lqr.admm_epoch_batched(tdata, t32(pb["z0"]), t32(w0),
                                      t32(y0), epoch_len=EL, alpha=ALPHA)
    assert tuple(got[2].shape) == (2, 4, mr)
    for g, r in zip(got[:4], ref[:4]):
        close(g, r, 1e-3)
    for g, r in zip(got[4:], ref[4:]):
        close(g, r, 1e-4)


def test_lpv_fleet_step_matches_jax_at_32_agents():
    """One step of a 32-agent LPV fleet (35 rows per stage) on the Highway
    track, B=1, N=5, float64."""
    jc, tc = lpv_configs(n_agents=32, N=5, iters=100)
    with x64_island():
        jt = j_make_track("Highway", dtype=jnp.float64)
        st = j_batch(jsim.init_lpv_fleet(jt, jc), 1)
        rng = np.random.default_rng(4)
        st = st._replace(x0=st.x0 + jnp.asarray(
            rng.normal(size=st.x0.shape) * 0.02))
        jfin, jm = jax.vmap(jsim.make_lpv_fleet_step(jt, jc))(st)
    tt = interop.track_from_numpy(jt, dtype=F64, device="cpu")
    fin, m = tsim.make_lpv_fleet_step(tt, tc)(
        interop.fleet_state_from_numpy(st, dtype=F64, device="cpu"))
    close(fin.x_pred, jfin.x_pred, 1e-6)
    close(fin.x0, jfin.x0, 1e-6)
    np.testing.assert_array_equal(m.feasible.numpy(), np.asarray(jm.feasible))
    close(m.min_dist_exec, jm.min_dist_exec, 1e-6)
    assert tuple(m.feasible.shape) == (1, 32)


def test_nl_ocd_step_matches_jax_at_10_agents():
    """One NL-OCD control step of a 10-agent fleet (9 neighbours), eu,
    Jacobi, N=5, float64: OCD iterations, feasible flags, plans and
    prices."""
    jc, tc = ocd_configs(n_agents=10, N=5, coupling="eu", sweep="jacobi")
    with x64_island():
        jt, st = ocd_fleet(jc, seed=8)
        tst = batch_fleet_state(interop.ocd_state_from_numpy(
            st, dtype=F64, device="cpu"), 1, device="cpu")
        st, m = jocd.make_nl_ocd_step(jt, jc)(st)
    tt = interop.track_from_numpy(jt, dtype=F64, device="cpu")
    tst, tm = tocd.make_nl_ocd_step(tt, tc)(tst)
    assert int(tm.ocd_iterations[0]) == int(m.ocd_iterations)
    np.testing.assert_array_equal(tm.feasible[0].numpy(),
                                  np.asarray(m.feasible))
    for f in ("x0", "x_pred", "u_pred", "lambdas"):
        close(getattr(tst, f)[0], getattr(st, f), 1e-6)
    assert tuple(tst.lambdas.shape) == (1, 10, 10, 5)
