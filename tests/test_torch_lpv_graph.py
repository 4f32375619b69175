"""The LPV fleet step's two phases (``runtime/simulate.py _hold_phase``,
``_plant_phase``), run op by op on CPU tensors.

On CUDA tensors with the single-process exchange the step replays each
phase from a CUDA graph (``utils/graphs.py graphed``); on CPU tensors, and
in the sharded step, it runs the same two phase functions op by op. Here
the split step is held bit for bit, over 8 steps at B=1 and B=4, to the
step as it was before the split (a frozen copy below), in cases where the
reset and cold rungs of the hold ladder fire, the degraded escape
executes, the separation filter brakes and the lateral wall clamps, with
dynamic lanes, with one agent, and with every rung and filter off. The
replay against the op-by-op step on a card is tests/test_torch_cuda.py's
``test_cuda_graphed_lpv_step_keeps_the_bits``; that the phases move
nothing between host and device is tests/test_torch_graphs.py's.
"""

import numpy as np
import pytest
import torch

from colaborativempc_tpu_torch import config as tcfg
from colaborativempc_tpu_torch.config.params import SysLimits, lpv_gains
from colaborativempc_tpu_torch.geometry import make_track
from colaborativempc_tpu_torch.planners.lpv import LPVSolution
from colaborativempc_tpu_torch.runtime import simulate as tsim
from colaborativempc_tpu_torch.runtime.simulate import (
    FleetState, LocalExchange, StepMetrics, _exchange_filter, _gains_on,
    _neighbour_index, _pairwise_min_dist, _per_agent_limits,
    batch_fleet_state, escalate_holds, hold_vx_scale, lateral_wall,
    switch_lanes,
)
from colaborativempc_tpu_torch.utils.tracing import span

torch.set_num_threads(2)

STEPS = 8


def lpv_solve(*args, **kw):
    """The module's solver as the step finds it at call time."""
    return tsim.lpv_solve(*args, **kw)


def frozen_lpv_step(track, cfg, ex=None):
    """``runtime/simulate.py _lpv_step`` before its phases were split out
    and graphed: the reference of the bits."""
    ex = LocalExchange() if ex is None else ex
    dev = track.s0.device
    dtype = torch.float32 if cfg.dtype == "float32" else torch.float64
    gains = _gains_on(cfg.gains if cfg.gains is not None else lpv_gains(),
                      dev, dtype)
    n = cfg.n_agents
    ns = torch.as_tensor(_neighbour_index(n), device=dev)
    multi = n > 1
    limits_pa = _per_agent_limits(cfg, dev)

    def step(state):
        with span("cmpc.step"):
            return control_step(state)

    def control_step(state):
        B, A = state.x0.shape[:2]
        P = B * A
        dtype = state.x0.dtype
        gids = ex.gids(A, dev)

        def flat(t):
            return t.reshape((P,) + t.shape[2:])

        def unflat(t):
            return t.reshape((B, A) + t.shape[1:])

        with span("cmpc.hold"):
            if cfg.dynamic_lane:
                state = switch_lanes(track, state)
                lanes = state.lane
            else:
                lanes = torch.full((B, A), cfg.lane, dtype=torch.int32,
                                   device=dev)
            # recovery feasibility pass: pre-escalation hold-or-brake counts
            vxs = hold_vx_scale(
                cfg, torch.maximum(state.hold_count, state.brake_count),
                dtype)
            lim = SysLimits(*(v[gids] for v in limits_pa))
            limits_step = SysLimits(*(
                flat(torch.broadcast_to(v, (B, A))) for v in
                lim._replace(vx_ref=lim.vx_ref * vxs)))
            state = escalate_holds(track, cfg, state, lanes)

        # the "communication": everyone reads everyone's (X, Y) plan
        with span("cmpc.exchange"):
            if multi:
                xy = ex.gather(state.x_pred[..., 7:9])      # (B, n, N+1, 2)
                nb = ns[gids]                               # (A, n - 1)
                # (P, N+1, nb, 2)
                neigh = flat(xy[:, nb].permute(0, 1, 3, 2, 4))
                boost_sc = (cfg.hold_sep_boost if cfg.hold_on_infeasible
                            else 0.0)
                hold_f = ex.gather((state.hold_count > 0).to(dtype)
                                   * boost_sc)
                neigh_boost = flat(hold_f[:, nb])
            else:
                neigh, neigh_boost = None, None

        sol: LPVSolution = lpv_solve(
            track, gains, limits_step, cfg.model, cfg.N, cfg.dt,
            flat(state.x0), flat(state.x_pred), flat(state.u_pred),
            flat(state.u_old), neigh, neigh_boost=neigh_boost,
            w0=flat(state.w), y0=flat(state.y),
            rho_scale0=flat(state.rho_scale),
            admm_iters=cfg.solver.admm_budget(), rho=cfg.solver.rho,
            alpha_relax=cfg.solver.alpha_relax, eps=cfg.solver.eps,
            lane=flat(lanes), epoch_len=cfg.solver.epoch_len,
            assoc=bool(cfg.solver.assoc))
        sol = LPVSolution(*(unflat(t) for t in sol))

        with span("cmpc.hold"):
            jam_count = torch.where(sol.feasible,
                                    torch.zeros_like(state.jam_count),
                                    state.jam_count + 1)
            if cfg.hold_on_infeasible:
                # a plan whose residual exceeded the feasibility tolerance
                # is not executed: the agent follows its previous plan one
                # more stage; after hold_exec_k consecutive failures a
                # finite unconverged plan is executed under the envelope
                # and the safety filter
                ok = sol.feasible
                if cfg.hold_exec_k is not None:
                    finite = (torch.isfinite(sol.x_pred).all(-1).all(-1)
                              & torch.isfinite(sol.u_pred).all(-1).all(-1))
                    degraded = ((~ok) & finite
                                & (state.jam_count >= cfg.hold_exec_k))
                    ok = ok | degraded
                ok3 = ok[..., None, None]
                hold_x = torch.cat([state.x_pred[:, :, 1:],
                                    state.x_pred[:, :, -1:]], dim=2)
                hold_u = torch.cat([state.u_pred[:, :, 1:],
                                    state.u_pred[:, :, -1:]], dim=2)
                x_pred = torch.where(ok3, sol.x_pred, hold_x)
                u_pred = torch.where(ok3, sol.u_pred, hold_u)
                w = torch.where(ok3, sol.w, state.w)
                y = torch.where(ok3, sol.y, state.y)
                rho_scale = torch.where(ok[..., None], sol.rho_scale,
                                        state.rho_scale)
                # hold_count tracks solver feasibility, not the override
                hold_count = torch.where(sol.feasible,
                                         torch.zeros_like(state.hold_count),
                                         state.hold_count + 1)
            else:
                x_pred, u_pred = sol.x_pred, sol.u_pred
                w, y, rho_scale = sol.w, sol.y, sol.rho_scale
                hold_count = state.hold_count

        # physical envelope, then the executed-separation filter
        with span("cmpc.safety"):
            x0_cand, wall_clip = lateral_wall(track, cfg, state.x0,
                                              x_pred[:, :, 1, :], lanes)
            x0_exec, exec_beta, exec_xy = _exchange_filter(
                cfg, ex, gids, state.x0, x0_cand)

        with span("cmpc.plant"):
            brake_count = torch.where(exec_beta < 1.0, state.brake_count + 1,
                                      torch.zeros_like(state.brake_count))
            new_state = FleetState(
                x0=x0_exec, x_pred=x_pred, u_pred=u_pred,
                u_old=u_pred[:, :, 0, :], w=w, y=y, rho_scale=rho_scale,
                lane=lanes, hold_count=hold_count, brake_count=brake_count,
                jam_count=jam_count)
            dd = exec_xy[..., :, None, :] - exec_xy[..., None, :, :]
            dexec = torch.sqrt(torch.sum(dd * dd, dim=-1) + 1e-12)
            dexec = dexec + torch.eye(n, dtype=dexec.dtype, device=dev) * 1e9
            metrics = StepMetrics(
                feasible=sol.feasible, iterations=sol.iterations,
                r_prim=sol.r_prim,
                min_dist=_pairwise_min_dist(
                    ex.gather(x_pred[..., 7:9]).transpose(1, 2)),
                min_dist_exec=torch.amin(dexec, dim=(-2, -1)),
                slack_max=torch.amax(torch.abs(sol.s_pred), dim=(-2, -1)),
                exec_beta=exec_beta, wall_clip=wall_clip)
        return new_state, metrics

    return step



X0_CLOSE = np.array([[1.3, -0.16, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0],
                     [1.3, -0.16, 0.0, -0.08, 0.0, 0.0, 0.05, 0.0, 1.0],
                     [1.3, -0.16, 0.0, 0.45, 0.0, 0.0, 0.0, 0.0, 1.45]])

# name: (ExperimentConfig keywords, x0 rows or None for the database's)
CASES = {
    # a budget of one epoch: the solves fail, the reset and cold rungs fire
    "ladder": (dict(solver=tcfg.SolverConfig(admm_iters=5, epoch_len=5),
                    hold_reset_k=2, hold_cold_k=4, hold_exec_k=None), None),
    # failing solves past hold_exec_k: the degraded escape executes
    "degraded": (dict(solver=tcfg.SolverConfig(admm_iters=5, epoch_len=5),
                      hold_exec_k=2, hold_sep_boost=0.5), None),
    # agents 0 and 1 start inside exec_sep_frac * min_dist: the filter
    # brakes; a narrow wall clamps the executed ey
    "close": (dict(solver=tcfg.SolverConfig(admm_iters=60),
                   exec_ey_wall=0.1), X0_CLOSE),
    "dynamic_lane": (dict(map_type="Oval2", dynamic_lane=True,
                          solver=tcfg.SolverConfig(admm_iters=30)), None),
    "one_agent": (dict(n_agents=1, solver=tcfg.SolverConfig(admm_iters=30),
                       dtype="float64"), None),
    "bare": (dict(hold_on_infeasible=False, exec_sep_frac=None,
                  exec_ey_wall=None,
                  solver=tcfg.SolverConfig(admm_iters=30)), None),
}


def _system(case, B):
    kw, x0s = CASES[case]
    cfg = tcfg.ExperimentConfig(**{"N": 8, "dt": 0.025, "gains": lpv_gains(),
                                   **kw})
    track = make_track(cfg.map_type, device="cpu",
                       dtype=torch.float32 if cfg.dtype == "float32"
                       else torch.float64)
    if x0s is None:
        x0s = tcfg.x0_database(cfg.n_agents)
    state = batch_fleet_state(tsim.init_lpv_fleet(track, cfg, x0s,
                                                  device="cpu"), B,
                              device="cpu")
    pert = np.random.default_rng(11).normal(scale=0.03,
                                            size=(B, cfg.n_agents, 9))
    pert[0] = 0.0
    pert[..., 5:] = 0.0
    state = state._replace(x0=state.x0 + torch.as_tensor(
        pert, dtype=state.x0.dtype))
    if case == "dynamic_lane":
        # agent 1 of fleet 0 moved 1 m to the left of its heading, onto
        # Oval2's other lane (its Frenet entries left as they were): it
        # switches lanes in the first step
        x0, xp = state.x0.clone(), state.x_pred.clone()
        for x in (x0[0, 1], xp[0, 1]):
            x[..., 7] -= torch.sin(x[..., 5])
            x[..., 8] += torch.cos(x[..., 5])
        state = state._replace(x0=x0, x_pred=xp)
    return cfg, track, state


def _run(step, state):
    seen = []
    for _ in range(STEPS):
        prev = [t.clone() for t in state]
        state, m = step(state)
        seen.append((prev, [t.clone() for t in state], list(m)))
    return seen


def _bits_equal(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(torch.uint8) if a.is_floating_point()
                            else a, b.view(torch.uint8)
                            if b.is_floating_point() else b))


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_split_lpv_step_keeps_the_bits(case, B):
    cfg, track, start = _system(case, B)
    records, replays = (tsim.make_lpv_fleet_step.graph_records,
                        tsim.make_lpv_fleet_step.graph_replays)
    got = _run(tsim.make_lpv_fleet_step(track, cfg), start)
    ref = _run(frozen_lpv_step(track, cfg), start)
    names = FleetState._fields + StepMetrics._fields
    for k, ((_, gs, gm), (_, rs, rm)) in enumerate(zip(got, ref)):
        for name, g, r in zip(names, gs + gm, rs + rm):
            assert _bits_equal(g, r), (k, name)
    # CPU tensors record and replay nothing
    assert (tsim.make_lpv_fleet_step.graph_records,
            tsim.make_lpv_fleet_step.graph_replays) == (records, replays)

    # the case reaches the code it is there for (the reference's steps)
    hc = [torch.maximum(p[8], p[9]) for p, _, _ in ref]
    feas = torch.stack([m[0] for _, _, m in ref])
    beta = torch.stack([m[6] for _, _, m in ref])
    clip = torch.stack([m[7] for _, _, m in ref])
    if case == "ladder":
        assert any(bool((h >= cfg.hold_reset_k).any()) for h in hc)
        assert any(bool((h >= cfg.hold_cold_k).any()) for h in hc)
    if case == "degraded":
        jam = torch.stack([p[10] for p, _, _ in ref])
        assert bool(((jam >= cfg.hold_exec_k) & ~feas).any())
    if case == "close":
        assert bool((beta < 1.0).any()) and bool(clip.any())
    if case == "dynamic_lane":
        assert bool((ref[0][1][7][0] != ref[0][0][7][0]).any())
    if case == "bare":
        assert not bool(clip.any()) and bool((beta == 1.0).all())
