"""Closed-loop collaborative LPV fleet step and rollout (PyTorch port).

Twin of the fleet part of ``colaborativempc_tpu/runtime/simulate.py``
(reference scheduler ``planner/scripts/LPV_HP_N_main.py:57-122``). The JAX
step is per fleet and vmapped over scenarios; here every state tensor is
batched ``(B, n_ag, ...)`` and the planner sees the B*n_ag agent problems
as one flat batch of P QPs. The planning convention matches the reference:
the MPC prediction IS the plant (x0 <- xPred[1]). The rollout is a Python
loop over control steps.

Two defects of the JAX reference are carried over exactly, so the port
stays comparable with it (both are pinned in tests/test_torch_fleet.py):
``lateral_wall`` detects an s-clamp on the re-added absolute s (a 1-ulp
difference marks a healthy step as clamped), and the degraded-execution
escape checks only ``x_pred``/``u_pred`` for finiteness before adopting
``w``, ``y`` and ``rho_scale``.
"""

from __future__ import annotations

import contextlib
import functools
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from colaborativempc_tpu_torch.config.params import (
    ExperimentConfig, Gains, SysLimits, lpv_gains, x0_database,
)
from colaborativempc_tpu_torch.geometry import (
    Track, check_end, frenet_to_cartesian, halfwidth, make_track, relocalize,
    select_lane, wrap_to_pi,
)
from colaborativempc_tpu_torch.planners.lpv import lpv_solve, LPVSolution
from colaborativempc_tpu_torch.utils.device import resolve_device, synchronize
from colaborativempc_tpu_torch.utils.graphs import graphed
from colaborativempc_tpu_torch.utils.tracing import span
from colaborativempc_tpu_torch.utils.warmstart import (
    initialise_agents, warmstart_trajectory,
)


class FleetState(NamedTuple):
    """Per-agent planning state carried across control steps; every field
    has leading ``(B, n_ag)`` axes (``init_lpv_fleet`` gives ``(n_ag,)``,
    :func:`batch_fleet_state` adds B)."""
    x0: torch.Tensor          # (.., 9) current states
    x_pred: torch.Tensor      # (.., N+1, 9) last predictions (linearisation)
    u_pred: torch.Tensor      # (.., N, 2)
    u_old: torch.Tensor       # (.., 2) last applied inputs
    w: torch.Tensor           # (.., N, m) ADMM splitting warm start
    y: torch.Tensor           # (.., N, m)
    rho_scale: torch.Tensor   # (.., m) per-row-class adaptive-rho warm start
    lane: torch.Tensor        # (..,) int32 lane each x0's Frenet row lives on
    hold_count: torch.Tensor  # (..,) int32 consecutive plan-holds (ladder)
    brake_count: torch.Tensor  # (..,) int32 consecutive filter brakings
    jam_count: torch.Tensor   # (..,) int32 consecutive infeasible solves,
    #                           never reset by the ladder (hold_exec_k)


def batch_fleet_state(state, n_scen: int, device="cuda"):
    """Tile a single-fleet ``(n_ag, ...)`` state — a ``FleetState`` or an
    ``OCDFleetState`` — into a scenario batch ``(n_scen, n_ag, ...)`` on
    ``device`` (each scenario its own copy; the default ``cuda`` raises
    without a card)."""
    dev = resolve_device(device)
    return type(state)(*(
        x.to(dev)[None].expand((n_scen,) + x.shape).clone() for x in state))


class StepMetrics(NamedTuple):
    feasible: torch.Tensor       # (B, n_ag)
    iterations: torch.Tensor     # (B, n_ag)
    r_prim: torch.Tensor         # (B, n_ag)
    min_dist: torch.Tensor       # (B,) min pairwise distance over horizon
    min_dist_exec: torch.Tensor  # (B,) min pairwise distance of x0 states
    slack_max: torch.Tensor      # (B, n_ag) max slack magnitude
    exec_beta: torch.Tensor      # (B, n_ag) separation-filter advance
    #                              fraction (1.0 = filter inactive)
    wall_clip: torch.Tensor      # (B, n_ag) track-limits wall clamped this
    #                              agent's executed state


def _neighbour_index(n_agents: int) -> np.ndarray:
    """ns[i] = all agent ids except i (reference main scripts' ``ns``)."""
    return np.array([[j for j in range(n_agents) if j != i]
                     for i in range(n_agents)], dtype=np.int64)


class LocalExchange:
    """The plan exchange of a step whose batch holds every agent of each
    fleet: the world-size-1 case of ``parallel/multihost.py AgentExchange``,
    which a sharded step uses in its place. Its ``gather`` returns the
    tensor itself and the local agents are the global ids ``0..A-1``."""

    def gids(self, n_local: int, device) -> torch.Tensor:
        """Global ids of this shard's ``n_local`` agents."""
        return torch.arange(n_local, device=device)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """``(B, A_local, ...)`` -> ``(B, n_agents, ...)``."""
        return t

    def all_agents(self, flag: torch.Tensor) -> torch.Tensor:
        """Per-fleet ``(B,)`` flag, true where it holds on every shard."""
        return flag

    def any_fleet(self, flag: torch.Tensor) -> bool:
        """Whether ``flag`` holds for any fleet on any shard of the agent
        axis (one host sync)."""
        return bool(flag.any())


def _exchange_filter(cfg: ExperimentConfig, ex, gids: torch.Tensor,
                     x_cur: torch.Tensor, x_cand: torch.Tensor):
    """The executed-separation filter over the agent exchange: the betas
    need every agent's anchor and candidate, so both are gathered, and the
    projection is applied to this shard's agents. Returns ``(x_exec,
    beta)`` of the local agents and the executed (X, Y) of every agent,
    ``(B, n_agents, 2)``."""
    if cfg.exec_sep_frac is None:
        return (x_cand, torch.ones_like(x_cand[..., 0]),
                ex.gather(x_cand[..., 7:9]))
    x_all, beta_all = separation_filter(cfg, ex.gather(x_cur),
                                        ex.gather(x_cand))
    beta = beta_all[:, gids]
    return _apply_exec_beta(x_cur, x_cand, beta), beta, x_all[..., 7:9]


def _pairwise_min_dist(agents_xy: torch.Tensor) -> torch.Tensor:
    """Min distance between any agent pair over horizon stages 1..N;
    ``agents_xy (B, N+1, n_ag, 2)`` -> ``(B,)``."""
    p = agents_xy[:, 1:]
    d = p[..., :, None, :] - p[..., None, :, :]
    dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
    n = p.shape[-2]
    dist = dist + torch.eye(n, dtype=dist.dtype, device=dist.device) * 1e9
    return torch.amin(dist, dim=(1, 2, 3))


def _gains_on(g: Gains, device, dtype) -> Gains:
    """Gains as tensors on ``device``; a step function moves them there once
    when it is built, since a host-to-device copy inside the step would
    synchronise the host. ``wq`` stays a float unless it is per fleet."""
    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64) if not isinstance(
            v, torch.Tensor) else v).to(device=device, dtype=dtype)
    wq = g.wq
    if np.ndim(wq) > 0:
        wq = t(wq)
    return Gains(q=t(g.q), qs=t(g.qs), r=t(g.r), dr=t(g.dr), wq=wq)


def _per_problem(gains: Gains, n: int) -> Gains:
    """Per-fleet gains ``(B, k)`` repeated for the n agents of each fleet
    (the flat ``B*n`` problem batch); shared gains as they are."""
    if gains.q.ndim == 1:
        return gains

    def rep(v):
        if isinstance(v, torch.Tensor) and v.ndim > 0:
            return v.repeat_interleave(n, dim=0)
        return v
    return Gains(*(rep(v) for v in gains))


def _per_agent_limits(cfg: ExperimentConfig, device) -> SysLimits:
    """Limits as ``(n_agents,)`` float32 tensors. Heterogeneous fleets set
    any SysLimits field to an (n_agents,) array; scalars broadcast. The cast
    to float32 holds in a float64 run too, as in the JAX fleet step
    (``simulate.py:90-93``): ``sm=0.9`` is not exact in float32, and float64
    parity depends on taking the same value."""
    return SysLimits(*(
        torch.tensor(np.broadcast_to(np.asarray(v, np.float32),
                                     (cfg.n_agents,)).copy(), device=device)
        for v in cfg.limits))


def _sep_filter_beta(p0: torch.Tensor, p1: torch.Tensor, floor,
                     prio: torch.Tensor, n_pass: int = 4) -> torch.Tensor:
    """Per-agent advance fractions bounding the executed pairwise distance
    (the JAX ``_sep_filter_beta``, batched over leading axes: ``p0``/``p1``
    ``(..., n, 2)``, ``prio (..., n)``).

    Executed position p(beta) = p0 + beta (p1 - p0); no pair ends below
    g = min(floor, its standstill distance). Braking is priority-asymmetric:
    per pair the agent with lower arc progress (ties by index) is the
    follower and brakes alone when a stopped follower suffices, else both
    scale by the symmetric common factor. Passes iterate because the
    per-agent betas couple the pairs; an all-stop fallback backstops the
    guarantee. Exactly 1.0 wherever no pair would cross the floor.
    """
    n = p0.shape[-2]
    dev = p0.device
    delta = p1 - p0
    eyeb = torch.eye(n, dtype=torch.bool, device=dev)
    a0 = p0[..., :, None, :] - p0[..., None, :, :]          # (.., i, j, 2)
    d0sq = torch.sum(a0 * a0, dim=-1)
    f2 = floor * floor
    g2 = torch.minimum(f2, d0sq)                             # guarantee^2
    idx = torch.arange(n, device=dev)
    pi, pj = prio[..., :, None], prio[..., None, :]
    follows = (pi < pj) | ((pi == pj) & (idx[:, None] > idx[None, :]))

    def brake_root(ab, bb, c):
        # largest t in [0, 1] with the convex d^2(t) >= g^2, shaved by 1e-3
        # so a braked agent stops marginally short of the floor
        disc = ab * ab - bb * c
        root = ((-ab - torch.sqrt(torch.clamp_min(disc, 0.0)))
                / torch.clamp_min(bb, 1e-12))
        return torch.clamp(root, 0.0, 1.0) * (1.0 - 1e-3)

    beta = torch.ones_like(p0[..., 0])
    for _ in range(n_pass):
        q = p0 + beta[..., None] * delta
        # symmetric rule: both members scale by t
        b = (beta[..., :, None, None] * delta[..., :, None, :]
             - beta[..., None, :, None] * delta[..., None, :, :])
        bb = torch.sum(b * b, dim=-1)
        ab = torch.sum(a0 * b, dim=-1)
        d1sq = d0sq + 2.0 * ab + bb
        t_sym = brake_root(ab, bb, d0sq - g2)
        # follower-only rule: i moves along its segment, j fixed at q_j
        a_f = p0[..., :, None, :] - q[..., None, :, :]
        af2 = torch.sum(a_f * a_f, dim=-1)
        b_f = torch.broadcast_to((beta[..., None] * delta)[..., :, None, :],
                                 a_f.shape)
        ab_f = torch.sum(a_f * b_f, dim=-1)
        bb_f = torch.sum(b_f * b_f, dim=-1)
        c_f = af2 - g2
        fol_ok = c_f >= 0.0
        t_fol = brake_root(ab_f, bb_f, torch.clamp_min(c_f, 0.0))
        ones = torch.ones_like(d1sq)
        t_ij = torch.where(
            d1sq >= g2, ones,
            torch.where(follows,
                        torch.where(fol_ok, t_fol, t_sym),
                        torch.where(fol_ok.transpose(-1, -2), ones, t_sym)))
        t_ij = torch.where(eyeb, ones, t_ij)
        beta = beta * torch.amin(t_ij, dim=-1)
    # all-stop fallback when a pair is still below the floor and materially
    # closer than it stood (margin well above float32 rounding)
    p = p0 + beta[..., None] * delta
    dd = p[..., :, None, :] - p[..., None, :, :]
    dsq = torch.sum(dd * dd, dim=-1)
    margin = torch.clamp_min(1e-4 * d0sq, 1e-7)
    bad = torch.any((dsq < f2) & (dsq < d0sq - margin) & ~eyeb, dim=-1)
    bad = torch.any(bad, dim=-1)
    return torch.where(bad[..., None], torch.zeros_like(beta), beta)


def _apply_exec_beta(x_cur: torch.Tensor, x_cand: torch.Tensor,
                     beta: torch.Tensor) -> torch.Tensor:
    """Brake along the plan: interpolate the full state row between the
    current state (beta=0) and the plan's first stage (beta=1) and scale
    (vx, vy, wz) by beta, so the executed state is a truthful brake.
    Bit-identical to the candidate wherever beta == 1."""
    lerp = x_cur + beta[..., None] * (x_cand - x_cur)
    vel_scaled = torch.cat([lerp[..., 0:3] * beta[..., None], lerp[..., 3:]],
                           dim=-1)
    return torch.where((beta >= 1.0)[..., None], x_cand, vel_scaled)


def separation_filter(cfg: ExperimentConfig, x_cur: torch.Tensor,
                      x_cand: torch.Tensor):
    """Executed-separation safety filter (``cfg.exec_sep_frac``) on
    ``(B, n_ag, 9)`` current and candidate states. Returns
    ``(x_exec, beta)``; identity when no pair would cross the floor."""
    if cfg.exec_sep_frac is None:
        return x_cand, torch.ones_like(x_cand[..., 0])
    dth = float(np.max(np.asarray(cfg.limits.min_dist)))
    floor = torch.full((), cfg.exec_sep_frac, dtype=x_cand.dtype,
                       device=x_cand.device) * dth
    beta = _sep_filter_beta(x_cur[..., 7:9], x_cand[..., 7:9], floor,
                            prio=x_cur[..., 6])
    return _apply_exec_beta(x_cur, x_cand, beta), beta


def lateral_wall(track: Track, cfg: ExperimentConfig, x_cur: torch.Tensor,
                 x_cand: torch.Tensor, lanes: torch.Tensor):
    """Physical execution envelope on the executed stage
    (``cfg.exec_ey_wall``), elementwise over leading axes: arc advance in
    [-max_vel dt, 2 max_vel dt]; |ey| <= max(wall * halfwidth(s), current
    |ey|); vx in [min_vel, max_vel], |vy| <= max_vel, |wz| <= 4 pi; epsi
    wrapped when outside [-pi, pi]; (X, Y) rebuilt from the Frenet pose
    whenever s or ey moved. Returns ``(x_exec, clamped)``.

    Carries the JAX defect: ``s_new = s_cur + ds`` is compared with the
    candidate's absolute s, so a 1-ulp rounding difference counts as a
    moved pose and rebuilds (X, Y) on a healthy step."""
    if cfg.exec_ey_wall is None:
        return x_cand, torch.zeros(x_cand.shape[:-1], dtype=torch.bool,
                                   device=x_cand.device)
    lim = cfg.limits
    max_v = float(np.max(np.asarray(lim.max_vel)))
    min_v = float(np.min(np.asarray(lim.min_vel)))
    xc, xe = x_cur, x_cand
    dt = torch.full((), cfg.dt, dtype=xe.dtype, device=xe.device)
    ds = torch.clamp(xe[..., 6] - xc[..., 6], -max_v * dt, 2.0 * max_v * dt)
    s_new = xc[..., 6] + ds
    hw = halfwidth(track, s_new, lanes)
    wall = torch.full((), cfg.exec_ey_wall, dtype=xe.dtype, device=xe.device)
    bound = torch.maximum(hw * wall, torch.abs(xc[..., 3]))
    ey_new = torch.clamp(xe[..., 3], -bound, bound)
    pose_moved = (ey_new != xe[..., 3]) | (s_new != xe[..., 6])
    px, py, _ = frenet_to_cartesian(track, s_new, ey_new, lanes)
    vx_c = torch.clamp(xe[..., 0], min_v, max_v)
    vy_c = torch.clamp(xe[..., 1], -max_v, max_v)
    wz_c = torch.clamp(xe[..., 2], -4.0 * math.pi, 4.0 * math.pi)
    ep_c = torch.where(torch.abs(xe[..., 4]) > math.pi, wrap_to_pi(xe[..., 4]),
                       xe[..., 4])
    xe2 = torch.stack([
        vx_c, vy_c, wz_c, ey_new, ep_c, xe[..., 5], s_new,
        torch.where(pose_moved, px, xe[..., 7]),
        torch.where(pose_moved, py, xe[..., 8])], dim=-1)
    clamped = (pose_moved | (vx_c != xe[..., 0]) | (vy_c != xe[..., 1])
               | (wz_c != xe[..., 2]) | (ep_c != xe[..., 4]))
    return torch.where(clamped[..., None], xe2, xe), clamped


def hold_vx_scale(cfg: ExperimentConfig, count: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Recovery feasibility pass (``cfg.hold_vx_frac``): per-agent vx_ref
    multipliers, exactly 1.0 below the ``hold_reset_k`` rung and
    ``hold_vx_frac`` at and beyond it. ``count`` is max(hold_count,
    brake_count) before escalation."""
    ones = torch.ones(count.shape, dtype=dtype, device=count.device)
    if not cfg.hold_on_infeasible or cfg.hold_vx_frac is None:
        return ones
    k = cfg.hold_reset_k if cfg.hold_reset_k is not None else 3
    return torch.where(count >= k, torch.full_like(ones, cfg.hold_vx_frac),
                       ones)


def escalate_holds(track: Track, cfg: ExperimentConfig, state, lanes:
                   torch.Tensor):
    """Recovery escalation ladder, applied before the step's solve. With
    ``count = max(hold_count, brake_count)``: at ``hold_reset_k`` the
    agent's ADMM warm state (w, y, rho_scale) resets; at ``hold_cold_k``
    the agent is cold re-initialised from a fresh warm-start trajectory at
    its current state and its counters restart. Identity when no agent is
    escalating. ``state`` is a ``FleetState`` or a ``runtime/ocd.py
    OCDFleetState`` (any record with those fields), with leading axes
    ``hold_count.shape``."""
    if not cfg.hold_on_infeasible or (cfg.hold_reset_k is None
                                      and cfg.hold_cold_k is None):
        return state
    hc = torch.maximum(state.hold_count, state.brake_count)

    def bc(mask, ref):
        return mask.reshape(mask.shape + (1,) * (ref.ndim - mask.ndim))

    x_pred, u_pred = state.x_pred, state.u_pred
    hold_count, brake_count = state.hold_count, state.brake_count
    if cfg.hold_cold_k is not None:
        cold = hc >= cfg.hold_cold_k
        x_ws, u_ws = warmstart_trajectory(track, state.x0, cfg.N, cfg.dt,
                                          lane=lanes)
        x_pred = torch.where(bc(cold, x_pred), x_ws, x_pred)
        u_pred = torch.where(bc(cold, u_pred), u_ws.to(u_pred.dtype), u_pred)
        hold_count = torch.where(cold, torch.zeros_like(hold_count),
                                 hold_count)
        brake_count = torch.where(cold, torch.zeros_like(brake_count),
                                  brake_count)
    else:
        cold = torch.zeros(hc.shape, dtype=torch.bool, device=hc.device)
    reset = cold
    if cfg.hold_reset_k is not None:
        reset = reset | (hc >= cfg.hold_reset_k)
    w = torch.where(bc(reset, state.w), torch.zeros_like(state.w), state.w)
    y = torch.where(bc(reset, state.y), torch.zeros_like(state.y), state.y)
    rho_scale = torch.where(bc(reset, state.rho_scale),
                            torch.ones_like(state.rho_scale), state.rho_scale)
    return state._replace(x_pred=x_pred, u_pred=u_pred, w=w, y=y,
                          rho_scale=rho_scale, hold_count=hold_count,
                          brake_count=brake_count)


def switch_lanes(track: Track, state):
    """Per-step dynamic lane switch (reference ``set_lane``/``checkLane``):
    each agent's pose picks its lane, and the Frenet entries of x0 and of
    the linearisation trajectory are relocalised onto it, the previously
    selected lane threaded as ``old_lane`` so the lap count in s stays
    exact across lanes of different lengths. ``state`` is a ``FleetState``
    or an ``OCDFleetState``; returns it with ``x0``, ``x_pred`` and
    ``lane`` replaced."""
    lanes, x0 = select_lane(track, state.x0, prev_lane=state.lane)
    stages = state.x_pred.shape[:-1]
    x_pred = relocalize(track, state.x_pred, lanes[..., None].expand(stages),
                        old_lane=state.lane[..., None].expand(stages))
    x_pred = torch.cat([x0[..., None, :], x_pred[..., 1:, :]], dim=-2)
    return state._replace(x0=x0, x_pred=x_pred, lane=lanes)


def make_lpv_fleet_step(track: Track, cfg: ExperimentConfig):
    """The one-control-step function for a batch of fleets:
    ``state (B, n_ag, ...) -> (new_state, StepMetrics)``. With
    ``cfg.dynamic_lane`` every step first re-selects each agent's lane
    (:func:`switch_lanes`); ``cfg.solver.assoc`` reaches ``admm_solve``.
    On CUDA tensors the step's own ops before and after the solve are
    replayed from two CUDA graphs, counted in
    ``make_lpv_fleet_step.graph_records`` and ``.graph_replays``."""
    return _lpv_step(track, cfg, LocalExchange())


make_lpv_fleet_step.graph_records = 0   # graphs recorded (two per layout)
make_lpv_fleet_step.graph_replays = 0   # phases run by a replay (two a step)


def _hold_phase(track: Track, cfg: ExperimentConfig, ex, ns: torch.Tensor,
                limits_pa: SysLimits, *fields: torch.Tensor):
    """A step's ops before the solve: the lane switch, the hold ladder and
    the plan exchange, on a :class:`FleetState`'s ``fields``. Returns the
    escalated state's fields, the lanes, the step's flat limits and, in a
    fleet of more than one agent, the neighbours' plans and hold boosts."""
    state = FleetState(*fields)
    B, A = state.x0.shape[:2]
    P = B * A
    dtype, dev = state.x0.dtype, track.s0.device
    gids = ex.gids(A, dev)

    def flat(t):
        return t.reshape((P,) + t.shape[2:])

    with span("cmpc.hold"):
        if cfg.dynamic_lane:
            state = switch_lanes(track, state)
            lanes = state.lane
        else:
            lanes = torch.full((B, A), cfg.lane, dtype=torch.int32,
                               device=dev)
        # recovery feasibility pass: pre-escalation hold-or-brake counts
        vxs = hold_vx_scale(
            cfg, torch.maximum(state.hold_count, state.brake_count), dtype)
        lim = SysLimits(*(v[gids] for v in limits_pa))
        limits_step = SysLimits(*(
            flat(torch.broadcast_to(v, (B, A))) for v in
            lim._replace(vx_ref=lim.vx_ref * vxs)))
        state = escalate_holds(track, cfg, state, lanes)

    # the "communication": everyone reads everyone's (X, Y) plan
    with span("cmpc.exchange"):
        if cfg.n_agents > 1:
            xy = ex.gather(state.x_pred[..., 7:9])          # (B, n, N+1, 2)
            nb = ns[gids]                                   # (A, n - 1)
            # (P, N+1, nb, 2)
            neigh = flat(xy[:, nb].permute(0, 1, 3, 2, 4))
            boost_sc = (cfg.hold_sep_boost if cfg.hold_on_infeasible
                        else 0.0)
            hold_f = ex.gather((state.hold_count > 0).to(dtype) * boost_sc)
            neighbours = (neigh, flat(hold_f[:, nb]))
        else:
            neighbours = ()
    return (*state, lanes, *limits_step, *neighbours)


def _plant_phase(track: Track, cfg: ExperimentConfig, ex,
                 *fields: torch.Tensor):
    """A step's ops after the solve, on the escalated :class:`FleetState`'s
    fields, the lanes and the flat :class:`LPVSolution`'s fields: the jam
    and hold bookkeeping with the degraded escape, the physical envelope,
    the executed-separation filter and the plant. Returns the fields of
    the next :class:`FleetState` and of the :class:`StepMetrics`."""
    k = len(FleetState._fields)
    state, lanes = FleetState(*fields[:k]), fields[k]
    B, A = state.x0.shape[:2]
    n, dev = cfg.n_agents, track.s0.device
    gids = ex.gids(A, dev)
    sol = LPVSolution(*(t.reshape((B, A) + t.shape[1:])
                        for t in fields[k + 1:]))

    with span("cmpc.hold"):
        jam_count = torch.where(sol.feasible,
                                torch.zeros_like(state.jam_count),
                                state.jam_count + 1)
        if cfg.hold_on_infeasible:
            # a plan whose residual exceeded the feasibility tolerance is
            # not executed: the agent follows its previous plan one more
            # stage; after hold_exec_k consecutive failures a finite
            # unconverged plan is executed under the envelope and the
            # safety filter
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
    return (*new_state, *metrics)


def _lpv_step(track: Track, cfg: ExperimentConfig, ex):
    """The LPV fleet step over the agent exchange ``ex``: the state holds
    ``(B, A, ...)`` blocks of this shard's fleets and agents, every agent
    reads every agent's (X, Y) plan and hold flag through ``ex.gather``,
    and per-agent limits follow the global agent ids. A
    :class:`LocalExchange` makes it the single-process step.

    The step's own ops around the solve (:func:`_hold_phase`,
    :func:`_plant_phase`) are two fixed-shape stretches of hundreds of
    tiny kernels each. With a :class:`LocalExchange` on CUDA tensors each
    is replayed from one CUDA graph (``utils/graphs.py``: the same kernels,
    the same bits); another exchange's ``gather`` is a collective, which a
    graph does not record, so there both run op by op."""
    dev = track.s0.device
    dtype = torch.float32 if cfg.dtype == "float32" else torch.float64
    gains = _gains_on(cfg.gains if cfg.gains is not None else lpv_gains(),
                      dev, dtype)
    ns = torch.as_tensor(_neighbour_index(cfg.n_agents), device=dev)
    hold = functools.partial(_hold_phase, track, cfg, ex, ns,
                             _per_agent_limits(cfg, dev))
    plant = functools.partial(_plant_phase, track, cfg, ex)
    replay = isinstance(ex, LocalExchange)
    if replay:
        hold = graphed(hold, counter=make_lpv_fleet_step)
        plant = graphed(plant, counter=make_lpv_fleet_step)
    n_state, n_lim = len(FleetState._fields), len(SysLimits._fields)

    def step(state: FleetState):
        with span("cmpc.step"):
            return control_step(state)

    def control_step(state: FleetState):
        B, A = state.x0.shape[:2]
        P = B * A
        # on the card a span holds each replay (the phases' own spans
        # stamp only while they run op by op)
        card = replay and state.x0.is_cuda

        def flat(t):
            return t.reshape((P,) + t.shape[2:])

        with span("cmpc.hold") if card else contextlib.nullcontext():
            out = hold(*state)
        state, lanes = FleetState(*out[:n_state]), out[n_state]
        limits_step = SysLimits(*out[n_state + 1:n_state + 1 + n_lim])
        neigh, neigh_boost = out[n_state + 1 + n_lim:] or (None, None)

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

        if card:
            with span("cmpc.plant"):
                # the graph's buffers: a returned state outlives the replay
                out = tuple(t.clone() for t in plant(*state, lanes, *sol))
        else:
            out = plant(*state, lanes, *sol)
        return FleetState(*out[:n_state]), StepMetrics(*out[n_state:])

    return step


def make_lpv_fleet_rollout(track: Track, cfg: ExperimentConfig, steps: int):
    """Fixed-step closed-loop rollout: ``state -> (final_state, (x0_hist,
    u_hist, metrics))`` with history axes ``(B, steps, ...)`` — the layout
    of the vmapped JAX rollout."""
    step = make_lpv_fleet_step(track, cfg)

    def rollout(state: FleetState):
        xs, us, ms = [], [], []
        for _ in range(steps):
            state, m = step(state)
            xs.append(state.x0)
            us.append(state.u_old)
            ms.append(m)
        metrics = StepMetrics(*(torch.stack(f, 1) for f in zip(*ms)))
        return state, (torch.stack(xs, 1), torch.stack(us, 1), metrics)

    return rollout


def init_lpv_fleet(track: Track, cfg: ExperimentConfig,
                   x0s: Optional[np.ndarray] = None,
                   device="cuda") -> FleetState:
    """Initial ``(n_ag, ...)`` fleet state on ``device`` (which must hold
    ``track``; the default ``cuda`` raises without a card): warm-start plans
    from the x0 database rows, whose (X, Y, theta) are recomputed from the
    track geometry (the reference feeds the corrected row to the planner,
    LPV_HP_N_main.py:92)."""
    dev = resolve_device(device)
    dtype = torch.float32 if cfg.dtype == "float32" else torch.float64
    if x0s is None:
        x0s = x0_database(cfg.n_agents)
    x0s = torch.tensor(np.asarray(x0s, np.float64), dtype=dtype, device=dev)
    _, x_pred, u_pred = initialise_agents(track, x0s, cfg.N, cfg.dt,
                                          lane=cfg.lane)
    n = cfg.n_agents
    m = 4 + (n - 1 if n > 1 else 1)

    def full(shape, v, dt=dtype):
        return torch.full(shape, v, dtype=dt, device=dev)

    return FleetState(
        x0=x_pred[:, 0, :], x_pred=x_pred, u_pred=u_pred,
        u_old=full((n, 2), 0.0),
        w=full((n, cfg.N, m), 0.0), y=full((n, cfg.N, m), 0.0),
        rho_scale=full((n, m), 1.0),
        lane=full((n,), cfg.lane, torch.int32),
        hold_count=full((n,), 0, torch.int32),
        brake_count=full((n,), 0, torch.int32),
        jam_count=full((n,), 0, torch.int32))


class ExperimentResult(NamedTuple):
    states: np.ndarray         # (T, n_ag, 9) applied states per step
    inputs: np.ndarray         # (T, n_ag, 2)
    feasible: np.ndarray       # (T, n_ag)
    min_dist: np.ndarray       # (T,) over predictions
    min_dist_exec: np.ndarray  # (T,) over executed states
    step_times: np.ndarray     # (T,) wall clock per control step
    iterations: np.ndarray     # (T, n_ag) ADMM iterations
    steps: int
    finished: bool             # lap completed (vs max_it exhausted)
    exec_beta: np.ndarray = np.ones((0, 0))          # (T, n_ag)
    wall_clip: np.ndarray = np.zeros((0, 0), bool)   # (T, n_ag)


def resolve_single_fleet_schedule(cfg: ExperimentConfig) -> ExperimentConfig:
    """Fill unset solver knobs with the single-fleet long-horizon (N >= 48)
    latency schedule of the JAX package: ``epoch_len`` 15, the associative
    Riccati path, ``admm_iters`` 1000. Each knob fills in only when left
    unset (None), so a pin always wins. On the card every epoch is the
    kernel whatever ``assoc`` says (``ops/admm.py admm_solve``)."""
    if cfg.N < 48:
        return cfg
    import dataclasses
    sv = cfg.solver
    return dataclasses.replace(cfg, solver=sv._replace(
        epoch_len=15 if sv.epoch_len is None else sv.epoch_len,
        assoc=True if sv.assoc is None else sv.assoc,
        admm_iters=1000 if sv.admm_iters is None else sv.admm_iters))


def _fleet0(record):
    """Fleet 0 of a batched record as numpy arrays (what the IO hooks and
    the result histories take)."""
    return type(record)(*(t[0].detach().cpu().numpy() for t in record))


def run_lpv_experiment(cfg: ExperimentConfig,
                       x0s: Optional[np.ndarray] = None,
                       track: Optional[Track] = None,
                       io=None,
                       checkpoint_path: Optional[str] = None,
                       checkpoint_every: int = 50,
                       profile_dir: Optional[str] = None,
                       device="cuda") -> ExperimentResult:
    """Closed-loop decentralised LPV experiment of one fleet (reference
    ``LPV_HP_N_main.main``): the host loop handles termination and IO, each
    control step is ``make_lpv_fleet_step`` on a batch of one fleet.

    ``checkpoint_path`` enables an exact mid-run resume
    (``runtime/checkpoint.py``); ``profile_dir`` records a
    ``torch.profiler`` trace of the loop into ``profile_dir/trace.json``.
    The solver knobs left unset follow ``resolve_single_fleet_schedule``.
    """
    import os
    from colaborativempc_tpu_torch.runtime.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    cfg = resolve_single_fleet_schedule(cfg)
    dev = resolve_device(device)
    dtype = torch.float32 if cfg.dtype == "float32" else torch.float64
    if track is None:
        track = make_track(cfg.map_type, device=dev, dtype=dtype)
    step = make_lpv_fleet_step(track, cfg)
    state = batch_fleet_state(init_lpv_fleet(track, cfg, x0s, device=dev), 1,
                              device=dev)
    it = 0
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        state, it = load_checkpoint(checkpoint_path, state)
    prof = None
    if profile_dir is not None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()

    hist = {k: [] for k in ("states", "inputs", "feas", "dist", "dist_e",
                            "times", "iters", "beta", "wall")}
    finished = False
    while it < cfg.max_it:
        t0 = time.perf_counter()
        state, metrics = step(state)
        synchronize(dev)
        hist["times"].append(time.perf_counter() - t0)
        st0, m0 = _fleet0(state), _fleet0(metrics)
        hist["states"].append(st0.x0)
        hist["inputs"].append(st0.u_old)
        hist["feas"].append(m0.feasible)
        hist["dist"].append(float(m0.min_dist))
        hist["dist_e"].append(float(m0.min_dist_exec))
        hist["beta"].append(m0.exec_beta)
        hist["wall"].append(m0.wall_clip)
        hist["iters"].append(m0.iterations)
        if io is not None:
            io.update(it, st0, m0, hist["times"][-1])
        # the reference accepts inaccurate and budget-capped solves and
        # stops only on a hard failure (LPV_Planner.py:241-249): abort on a
        # non-finite state, continue on an infeasible flag
        if not bool(np.all(np.isfinite(hist["states"][-1]))):
            break
        if cfg.verb >= 1 and not bool(np.all(hist["feas"][-1])):
            bad = np.where(~hist["feas"][-1])[0].tolist()
            print(f"[step {it}] inaccurate solve accepted (agents {bad})")
        # lap termination on any agent (reference checkEnd, misc.py:28-48)
        if bool(check_end(track, state.x0[0, :, 6], laps=cfg.laps,
                          lane=cfg.lane).any()):
            finished = True
            break
        it += 1
        if checkpoint_path is not None and it % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, state, it)

    if prof is not None:
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    if checkpoint_path is not None:
        save_checkpoint(checkpoint_path, state, it)
    return ExperimentResult(
        states=np.asarray(hist["states"]), inputs=np.asarray(hist["inputs"]),
        feasible=np.asarray(hist["feas"]), min_dist=np.asarray(hist["dist"]),
        min_dist_exec=np.asarray(hist["dist_e"]),
        step_times=np.asarray(hist["times"]),
        iterations=np.asarray(hist["iters"]),
        steps=len(hist["states"]), finished=finished,
        exec_beta=np.asarray(hist["beta"]),
        wall_clip=np.asarray(hist["wall"]))
