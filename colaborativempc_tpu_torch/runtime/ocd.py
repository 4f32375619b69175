"""OCD (Optimality Condition Decomposition) dual coordination (PyTorch port).

Twin of ``colaborativempc_tpu/runtime/ocd.py`` (reference
``planner/scripts/NL_EU_N_main.py:100-168``, ``NL_HP_N_main.py:98-163``).
Every state tensor is batched ``(B, n_ag, ...)``: B fleets coordinate at
once, where the JAX step is per fleet and vmapped. One coordination
iteration solves every agent's SQP sub-problem (one batch of B*n_ag
problems for the Jacobi sweep; for Gauss-Seidel, n_ag batches of B problems
in agent order, each against the rows its predecessors already updated),
exchanges the trajectories, applies the projected dual ascent on master
pairs and tests convergence as the reference does: every trajectory within
``atol`` for more than ``it_conv`` consecutive iterations, at least
``min_it_ocd`` iterations, at most ``max_it_ocd``.

Per-fleet freeze: the JAX ``while_loop`` under ``vmap`` runs until every
fleet stops, and a stopped fleet's whole loop state (``it_ocd`` included)
is carried unchanged. Here a per-fleet ``stop`` mask selects the old state
of stopped fleets after every iteration, and the host reads once per
iteration whether any fleet still runs — so each fleet gets the result and
the iteration counts of its standalone run.

A defect of the JAX reference is carried over exactly, so the two stay
comparable (pinned in tests/test_torch_ocd.py): the Gauss-Seidel sweep
orders each agent's neighbours ``i+1, i+2, ...`` (cyclically), but the
refined planes are written back to the pair slots in the Jacobi order
``0, 1, ...`` — with three agents and ``hp_opt``, agent 1's refined plane
of pair (1, 2) lands in an unread slot and pair (0, 1)'s plane overwrites
slot (1, 2).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from colaborativempc_tpu_torch.config.params import (
    ExperimentConfig, SysLimits, nl_gains, x0_database,
)
from colaborativempc_tpu_torch.geometry import Track, check_end, make_track
from colaborativempc_tpu_torch.parallel.fleet import batch_fleet_state
from colaborativempc_tpu_torch.planners.nl import NLSolution, nl_solve
from colaborativempc_tpu_torch.runtime.simulate import (
    _fleet0, _gains_on, _neighbour_index, _per_agent_limits, _per_problem,
    escalate_holds, lateral_wall, resolve_single_fleet_schedule,
    separation_filter,
)
from colaborativempc_tpu_torch.utils.device import resolve_device, synchronize
from colaborativempc_tpu_torch.utils.warmstart import initialise_agents


class OCDFleetState(NamedTuple):
    """Carried across control steps; leading axes ``(B, n_ag)``
    (``init_nl_fleet`` gives ``(n_ag,)``, ``batch_fleet_state`` adds B)."""
    x0: torch.Tensor           # (.., 9)
    x_pred: torch.Tensor       # (.., N+1, 9)
    u_pred: torch.Tensor       # (.., N, 2)
    u_old: torch.Tensor        # (.., 2)
    lambdas: torch.Tensor      # (.., n_ag, N) coupling prices (persist)
    w: torch.Tensor            # (.., N, m)
    y: torch.Tensor
    rho_scale: torch.Tensor    # (.., m)
    lane: torch.Tensor         # (..,) int32
    hold_count: torch.Tensor   # (..,) int32 consecutive plan-holds
    brake_count: torch.Tensor  # (..,) int32 consecutive filter brakings
    jam_count: torch.Tensor    # (..,) int32 consecutive infeasible solves


class _OCDLoopState(NamedTuple):
    x_pred: torch.Tensor       # (B, n, N+1, 9)
    u_pred: torch.Tensor
    x_old: torch.Tensor
    lambdas: torch.Tensor      # (B, n, n, N)
    alpha: torch.Tensor        # per-(pair, stage) dual step (adaptive_alpha)
    g_prev: torch.Tensor       # previous residual (sign memory)
    planes: torch.Tensor       # (B, n, n, N, 2) pair planes (hp_opt); the
    #                            canonical slot (i, j), i < j, holds (theta, b)
    w: torch.Tensor
    y: torch.Tensor
    rho_scale: torch.Tensor
    it_ocd: torch.Tensor       # (B,)
    conv_count: torch.Tensor   # (B,)
    finished: torch.Tensor     # (B,)
    feasible: torch.Tensor     # (B, n)


class OCDStepMetrics(NamedTuple):
    ocd_iterations: torch.Tensor  # (B,) coordination iterations this step
    feasible: torch.Tensor        # (B, n)
    min_dist: torch.Tensor        # (B,) min predicted pairwise distance
    min_dist_exec: torch.Tensor   # (B,) min executed pairwise distance
    lambda_max: torch.Tensor      # (B,) max |lambda|
    exec_beta: torch.Tensor       # (B, n) separation-filter advance fraction
    wall_clip: torch.Tensor       # (B, n) track-limits wall clamps


def _bisector_planes(x_pred: torch.Tensor) -> torch.Tensor:
    """Canonical pair planes from the incumbent trajectories ``(..., n, N+1,
    9)``: for pair (i, j) the normal ``a = unit(p_j - p_i)`` and offset
    ``b = -a.mid`` (compute_plane.py:41-68). Returns ``(..., n, n, N, 2)``
    of (theta, b); only the i < j slots are read."""
    p = x_pred[..., 1:, 7:9]                                 # (.., n, N, 2)
    diff = p[..., None, :, :, :] - p[..., :, None, :, :]     # (i, j): j - i
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-9)
    a = diff / dist[..., None]
    theta = torch.atan2(a[..., 1], a[..., 0])
    mid = 0.5 * (p[..., None, :, :, :] + p[..., :, None, :, :])
    b = -torch.sum(a * mid, dim=-1)
    return torch.stack([theta, b], dim=-1)


def _dual_step(ocd, st: _OCDLoopState, g: torch.Tensor):
    """One dual-ascent step on the coupling prices: the fixed step of the
    reference (``lambdas += alpha g``, NL_EU_N_main.py:138-139), or with
    ``ocd.adaptive_alpha`` an RPROP-style per-element step that grows while
    the residual keeps its sign and shrinks when it flips; then projected
    onto ``[ocd.lambda_lo, inf)``. Returns ``(lambdas, alpha)``."""
    if not ocd.adaptive_alpha:
        lam = st.lambdas + ocd.alpha * g
        alpha = st.alpha
    else:
        corr = g * st.g_prev
        one = torch.ones_like(corr)
        mult = torch.where(corr > 0, ocd.alpha_grow * one,
                           torch.where(corr < 0, ocd.alpha_shrink * one, one))
        alpha = torch.clamp(st.alpha * mult, ocd.alpha / ocd.alpha_span,
                            ocd.alpha * ocd.alpha_span)
        lam = st.lambdas + alpha * g
    if ocd.lambda_lo is not None and ocd.lambda_lo > -np.inf:
        lam = torch.clamp_min(lam, ocd.lambda_lo)
    return lam, alpha


def _expand(mask: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ref.ndim - mask.ndim))


def _contain_nonfinite(st, sol):
    """Per-agent containment of non-finite sub-problem solutions: an agent
    whose solve produced inf/NaN keeps its previous prediction, has its ADMM
    warm state reset and is flagged infeasible. Leading axes follow
    ``sol.x_pred.shape[:-2]``. Returns ``(x_pred, u_pred, w, y, rho_scale,
    feasible, ok)``."""
    ok = (torch.isfinite(sol.x_pred).all(-1).all(-1)
          & torch.isfinite(sol.u_pred).all(-1).all(-1))

    def keep(new, old):
        return torch.where(_expand(ok, new), new, old)

    return (keep(sol.x_pred, st.x_pred), keep(sol.u_pred, st.u_pred),
            keep(sol.w, torch.zeros_like(sol.w)),
            keep(sol.y, torch.zeros_like(sol.y)),
            keep(sol.rho_scale, torch.ones_like(sol.rho_scale)),
            sol.feasible & ok, ok)


class _OCDCore(NamedTuple):
    prepare: object
    iteration: object
    loop_init: object
    running: object
    finalize: object


def _build_ocd_core(track: Track, cfg: ExperimentConfig) -> _OCDCore:
    """The pieces of one control step: the pre-solve escalation ladder, one
    coordination iteration, the loop state initialiser, the per-fleet
    "still running" predicate and the finaliser (plan-holding, envelope,
    separation filter, shift)."""
    if cfg.ocd.sweep not in ("jacobi", "gauss_seidel"):
        raise ValueError(
            f"OCDConfig.sweep must be 'jacobi' or 'gauss_seidel', got "
            f"{cfg.ocd.sweep!r}")
    if cfg.dynamic_lane:
        raise NotImplementedError("dynamic_lane is not ported yet")
    if cfg.solver.assoc:
        raise NotImplementedError(
            "the associative-scan ADMM path is not ported yet")
    n, N, ocd = cfg.n_agents, cfg.N, cfg.ocd
    dev = track.s0.device
    dtype = torch.float32 if cfg.dtype == "float32" else torch.float64
    limits_pa = _per_agent_limits(cfg, dev)
    ns = torch.as_tensor(_neighbour_index(n), device=dev)      # (n, nb)
    ids = torch.arange(n, device=dev)
    # master_mask[i, j] = 1 where i < ns[i, j] (NL_Planner_Eu.py:45-50)
    master_mask = ((ids[:, None] < ns).to(torch.float32) if n > 1 else
                   torch.ones((1, 1), dtype=torch.float32, device=dev))
    default_gains = _gains_on(cfg.gains if cfg.gains is not None
                              else nl_gains(), dev, dtype)
    sv = cfg.solver
    solve_kw = dict(
        sqp_iters=sv.sqp_iters, sqp_mix=sv.line_search,
        u_trust=(sv.u_trust_delta, sv.u_trust_acc), coupling=cfg.coupling,
        lane=cfg.lane, admm_iters=sv.admm_budget(), rho=sv.rho,
        alpha_relax=sv.alpha_relax, eps=sv.eps, epoch_len=sv.epoch_len)
    gauss_seidel = ocd.sweep == "gauss_seidel" and n > 1
    dth = float(np.max(np.asarray(cfg.limits.min_dist)))

    def solve(gains, limits, x0, x_bar, u_bar, u_old, lam, neigh, mmask, w,
              y, rs, pl) -> NLSolution:
        return nl_solve(track, gains, limits, cfg.model, N, cfg.dt, x0,
                        x_bar, u_bar, u_old, lam, neigh, mmask, w0=w, y0=y,
                        rho_scale0=rs, planes0=pl, **solve_kw)

    def prepare(state: OCDFleetState) -> OCDFleetState:
        lanes = torch.full(state.lane.shape, cfg.lane, dtype=torch.int32,
                           device=dev)
        return escalate_holds(track, cfg, state, lanes)

    def placeholder_planes(x_pred):
        # single agent: bisector to the far-away placeholder neighbour, so
        # the (inactive) plane row is maximally slack
        pp = x_pred[..., 1:, 7:9]                            # (B, 1, N, 2)
        far = torch.full_like(pp, 1e6)
        d = far - pp
        dn = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-9)
        a = d / dn[..., None]
        th = torch.atan2(a[..., 1], a[..., 0])
        b = -torch.sum(a * 0.5 * (pp + far), dim=-1)
        return torch.stack([th, b], dim=-1)[:, :, None]      # (B, 1, 1, N, 2)

    def jacobi(st, x0, u_old, gains, lam, neigh, pl_i):
        B = x0.shape[0]

        def flat(t):
            return t.reshape((B * n,) + t.shape[2:])
        limits = SysLimits(*(v.repeat(B) for v in limits_pa))
        mm = master_mask.expand((B,) + master_mask.shape)
        sol = solve(_per_problem(gains, n), limits, flat(x0),
                    flat(st.x_pred), flat(st.u_pred), flat(u_old), flat(lam),
                    flat(neigh), flat(mm), flat(st.w), flat(st.y),
                    flat(st.rho_scale), flat(pl_i))
        return NLSolution(*(t.reshape((B, n) + t.shape[1:]) for t in sol))

    def gauss_seidel_sweep(st, x0, u_old, gains):
        # agents solve in id order, each against the freshest neighbour
        # plans (OCD_ROS_main.py:178-241); a non-finite solve is contained
        # before its row is written, so later agents never read it
        B = x0.shape[0]
        x_all = st.x_pred.clone()
        sols = []
        for i in range(n):
            nb_ids = torch.roll(ids, -(i + 1))[: n - 1]
            lo_ids, hi_ids = nb_ids.clamp(max=i), nb_ids.clamp(min=i)
            sol_i = solve(
                gains, SysLimits(*(v[i].expand(B) for v in limits_pa)),
                x0[:, i], x_all[:, i], st.u_pred[:, i], u_old[:, i],
                st.lambdas[:, i][:, nb_ids],
                x_all[:, nb_ids][..., 7:9].transpose(1, 2),
                (i < nb_ids).to(x_all.dtype).expand(B, n - 1),
                st.w[:, i], st.y[:, i], st.rho_scale[:, i],
                st.planes[:, lo_ids, hi_ids])
            ok_i = (torch.isfinite(sol_i.x_pred).all(-1).all(-1)
                    & torch.isfinite(sol_i.u_pred).all(-1).all(-1))
            x_all[:, i] = torch.where(ok_i[:, None, None], sol_i.x_pred,
                                      x_all[:, i])
            sols.append(sol_i)
        return NLSolution(*(torch.stack(f, 1) for f in zip(*sols)))

    def ocd_iteration(st: _OCDLoopState, x0, u_old,
                      gains=None) -> _OCDLoopState:
        if gains is None:
            gains = default_gains
        B = x0.shape[0]
        dtype = st.x_pred.dtype
        if n == 1:
            # a far-away placeholder neighbour with price 0 keeps the row
            # count of init_nl_fleet
            neigh = torch.full((B, 1, N + 1, 1, 2), 1e6, dtype=dtype,
                               device=dev)
            lam = torch.zeros((B, 1, 1, N), dtype=dtype, device=dev)
            pl_i = placeholder_planes(st.x_pred)
        else:
            neigh = st.x_pred[:, ns][..., 7:9].transpose(2, 3)  # (B,n,N+1,nb,2)
            lam = st.lambdas[:, ids[:, None], ns]                # (B, n, nb, N)
            # canonical pair plane (min, max) regardless of role
            pl_i = st.planes[:, torch.minimum(ids[:, None], ns),
                             torch.maximum(ids[:, None], ns)]
        if gauss_seidel:
            sol = gauss_seidel_sweep(st, x0, u_old, gains)
        else:
            sol = jacobi(st, x0, u_old, gains, lam, neigh, pl_i)
        x_new, u_new, w_new, y_new, rs_new, feas, ok = _contain_nonfinite(
            st, sol)
        pl_new = torch.where(ok[..., None, None, None], sol.planes, pl_i)
        planes = st.planes
        if n > 1:
            # masters write their refined planes back to the canonical slots;
            # slave writes land in unread (i > j) slots
            planes = planes.clone()
            planes[:, ids[:, None], ns] = pl_new

        p = x_new[..., 1:, 7:9]                              # (B, n, N, 2)
        if cfg.coupling == "hp_opt":
            # g = dth/2 - (a.p_slave + b) on the refined plane
            # (NL_HP_N_main.py:127-133)
            th, bpl = planes[..., 0], planes[..., 1]
            val = (torch.cos(th) * p[:, None, :, :, 0]
                   + torch.sin(th) * p[:, None, :, :, 1] + bpl)
            g = dth / 2.0 - val
        else:
            # "eu": g = dth - ||p_i - p_j||; "hp": half of it
            diff = p[:, :, None] - p[:, None, :]            # (B, i, j, N, 2)
            dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-9)
            g = dth - dist
            if cfg.coupling == "hp":
                g = 0.5 * g
        upper = (ids[:, None] < ids[None, :]).to(g.dtype)[:, :, None]
        g = g * upper
        lambdas, alpha = _dual_step(ocd, st, g)

        # convergence test (NL_EU_N_main.py:141-157)
        conv = (torch.abs(st.x_pred - x_new) < ocd.atol).flatten(1).all(1)
        conv_count = torch.where(conv, st.conv_count + 1,
                                 torch.zeros_like(st.conv_count))
        finished = (conv_count > ocd.it_conv) | (st.it_ocd >= ocd.max_it_ocd)
        new_st = _OCDLoopState(
            x_pred=x_new, u_pred=u_new, x_old=st.x_pred, lambdas=lambdas,
            alpha=alpha, g_prev=g, planes=planes, w=w_new, y=y_new,
            rho_scale=rs_new, it_ocd=st.it_ocd + 1, conv_count=conv_count,
            finished=finished, feasible=feas)
        # per-fleet freeze: a fleet whose stop predicate held on entry keeps
        # its whole loop state
        stop = (st.it_ocd > ocd.min_it_ocd) & st.finished
        return _OCDLoopState(*(torch.where(_expand(stop, new), old, new)
                               for old, new in zip(st, new_st)))

    def loop_init(state: OCDFleetState) -> _OCDLoopState:
        B = state.x0.shape[0]

        def fill(v, dt):
            return torch.full((B,), v, dtype=dt, device=dev)
        return _OCDLoopState(
            x_pred=state.x_pred, u_pred=state.u_pred, x_old=state.x_pred,
            lambdas=state.lambdas,
            alpha=torch.full_like(state.lambdas, ocd.alpha),
            g_prev=torch.zeros_like(state.lambdas),
            planes=_bisector_planes(state.x_pred),
            w=state.w, y=state.y, rho_scale=state.rho_scale,
            it_ocd=fill(0, torch.int64), conv_count=fill(0, torch.int64),
            finished=fill(False, torch.bool),
            feasible=torch.ones((B, n), dtype=torch.bool, device=dev))

    def running(st: _OCDLoopState) -> torch.Tensor:
        # at least min_it_ocd iterations, then until finished
        return ~((st.it_ocd > ocd.min_it_ocd) & st.finished)

    def finalize(out: _OCDLoopState, state: OCDFleetState):
        # an agent whose final solve ended above the feasibility tolerance
        # follows its previous plan one more stage (duals keep their updated
        # values); after hold_exec_k consecutive failures a finite plan is
        # executed under the envelope and the separation filter
        jam_count = torch.where(out.feasible,
                                torch.zeros_like(state.jam_count),
                                state.jam_count + 1)
        if cfg.hold_on_infeasible:
            ok = out.feasible
            if cfg.hold_exec_k is not None:
                finite = (torch.isfinite(out.x_pred).all(-1).all(-1)
                          & torch.isfinite(out.u_pred).all(-1).all(-1))
                ok = ok | ((~ok) & finite
                           & (state.jam_count >= cfg.hold_exec_k))
            ok3 = ok[..., None, None]
            hold_x = torch.cat([state.x_pred[:, :, 1:],
                                state.x_pred[:, :, -1:]], dim=2)
            hold_u = torch.cat([state.u_pred[:, :, 1:],
                                state.u_pred[:, :, -1:]], dim=2)
            x_fin = torch.where(ok3, out.x_pred, hold_x)
            u_fin = torch.where(ok3, out.u_pred, hold_u)
            w_fin = torch.where(ok3, out.w, state.w)
            y_fin = torch.where(ok3, out.y, state.y)
            rs_fin = torch.where(ok[..., None], out.rho_scale,
                                 state.rho_scale)
            hold_count = torch.where(out.feasible,
                                     torch.zeros_like(state.hold_count),
                                     state.hold_count + 1)
        else:
            x_fin, u_fin = out.x_pred, out.u_pred
            w_fin, y_fin, rs_fin = out.w, out.y, out.rho_scale
            hold_count = state.hold_count

        # physical envelope, then the executed-separation filter
        x0_cand, wall_clip = lateral_wall(track, cfg, state.x0,
                                          x_fin[:, :, 1, :], state.lane)
        x0_exec, exec_beta = separation_filter(cfg, state.x0, x0_cand)
        brake_count = torch.where(exec_beta < 1.0, state.brake_count + 1,
                                  torch.zeros_like(state.brake_count))
        # control-step shift (NL_EU_N_main.py:170-172)
        new_state = OCDFleetState(
            x0=x0_exec,
            x_pred=torch.cat([x_fin[:, :, 1:], x_fin[:, :, -1:]], dim=2),
            u_pred=torch.cat([u_fin[:, :, 1:], u_fin[:, :, -1:]], dim=2),
            u_old=u_fin[:, :, 0, :], lambdas=out.lambdas, w=w_fin, y=y_fin,
            rho_scale=rs_fin, lane=state.lane, hold_count=hold_count,
            brake_count=brake_count, jam_count=jam_count)

        eye = torch.eye(n, dtype=x_fin.dtype, device=dev) * 1e9
        p = x_fin[:, :, 1:, 7:9]
        diff = p[:, :, None] - p[:, None]
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
        dist = dist + eye[:, :, None]
        pe = x0_exec[..., 7:9]
        de = torch.sqrt(torch.sum((pe[:, :, None] - pe[:, None]) ** 2, dim=-1)
                        + 1e-12) + eye
        metrics = OCDStepMetrics(
            ocd_iterations=out.it_ocd, feasible=out.feasible,
            min_dist=torch.amin(dist, dim=(1, 2, 3)),
            min_dist_exec=torch.amin(de, dim=(1, 2)),
            lambda_max=torch.amax(torch.abs(out.lambdas), dim=(1, 2, 3)),
            exec_beta=exec_beta, wall_clip=wall_clip)
        return new_state, metrics

    return _OCDCore(prepare, ocd_iteration, loop_init, running, finalize)


def _coordinate(core: _OCDCore, state: OCDFleetState, gains=None,
                timed: bool = False, on_iteration=None):
    """One control step: the coordination loop until every fleet stopped,
    with one host check per iteration. ``timed`` synchronises after each
    iteration and records its wall time (``on_iteration(it_ocd, seconds,
    max |dx|)`` is then called per iteration). Returns ``(new_state,
    metrics, iteration_times)``."""
    state = core.prepare(state)
    st = core.loop_init(state)
    times = []
    while bool(core.running(st).any()):
        t0 = time.perf_counter()
        st = core.iteration(st, state.x0, state.u_old, gains)
        if timed:
            synchronize(st.x_pred.device)
            times.append(time.perf_counter() - t0)
            if on_iteration is not None:
                delta = float((st.x_pred - st.x_old).abs().max())
                on_iteration(int(st.it_ocd.max()), times[-1], delta)
    new_state, metrics = core.finalize(st, state)
    return new_state, metrics, times


def make_nl_ocd_step(track: Track, cfg: ExperimentConfig):
    """The one-control-step function for a batch of fleets: ``state (B,
    n_ag, ...) -> (new_state, OCDStepMetrics)``."""
    core = _build_ocd_core(track, cfg)

    def step(state: OCDFleetState):
        new_state, metrics, _ = _coordinate(core, state)
        return new_state, metrics

    return step


def _rollout(core, state, steps, gains=None):
    xs, us, ms = [], [], []
    for _ in range(steps):
        state, m, _ = _coordinate(core, state, gains)
        xs.append(state.x0)
        us.append(state.u_old)
        ms.append(m)
    metrics = OCDStepMetrics(*(torch.stack(f, 1) for f in zip(*ms)))
    return state, (torch.stack(xs, 1), torch.stack(us, 1), metrics)


def make_nl_ocd_rollout(track: Track, cfg: ExperimentConfig, steps: int):
    """Fixed-step closed-loop NL-OCD rollout of a batch of fleets:
    ``state -> (final_state, (x0_hist, u_hist, OCDStepMetrics))`` with
    history axes ``(B, steps, ...)`` — the layout of the vmapped JAX
    rollout (``monte_carlo.py --pipeline nl``)."""
    core = _build_ocd_core(track, cfg)

    def rollout(state: OCDFleetState):
        return _rollout(core, state, steps)

    return rollout


def make_nl_ocd_rollout_gains(track: Track, cfg: ExperimentConfig,
                              steps: int):
    """Like :func:`make_nl_ocd_rollout` with the gains as an argument:
    ``(gains, state) -> ...``, where every gain vector may carry a leading
    fleet axis B, so each fleet of the batch runs its own gains (the NL
    experiment battery, reference ``experiment_battery.py:15-38``)."""
    core = _build_ocd_core(track, cfg)
    dev = track.s0.device
    dtype = torch.float32 if cfg.dtype == "float32" else torch.float64

    def rollout(gains, state: OCDFleetState):
        return _rollout(core, state, steps, _gains_on(gains, dev, dtype))

    return rollout


def make_nl_ocd_instrumented(track: Track, cfg: ExperimentConfig):
    """Control step that times every coordination iteration (the reference's
    verbose tier, ``verb_OCD``, and the per-iteration rows of
    ``time_OCD.dat``): ``step(state, on_iteration=None) -> (new_state,
    metrics, iteration_times)``; ``on_iteration(it_ocd, seconds, delta)``
    is called after each iteration with its wall time and the largest
    trajectory change."""
    core = _build_ocd_core(track, cfg)

    def step(state: OCDFleetState, on_iteration=None):
        return _coordinate(core, state, timed=True,
                           on_iteration=on_iteration)

    return step


def init_nl_fleet(track: Track, cfg: ExperimentConfig,
                  x0s: Optional[np.ndarray] = None,
                  lambdas0: Optional[np.ndarray] = None,
                  device="cpu") -> OCDFleetState:
    """Initial ``(n_ag, ...)`` state on ``device`` (which must hold
    ``track``); ``lambdas0`` warm-starts the duals (the reference's
    ini_lambdas pickle, misc.py:218-231)."""
    dev = resolve_device(device)
    dtype = torch.float32 if cfg.dtype == "float32" else torch.float64
    n, N = cfg.n_agents, cfg.N
    if x0s is None:
        x0s = x0_database(n)
    x0s = torch.tensor(np.asarray(x0s, np.float64), dtype=dtype, device=dev)
    _, x_pred, u_pred = initialise_agents(track, x0s, N, cfg.dt,
                                          lane=cfg.lane)
    n_nb = max(n - 1, 1)
    m = 4 + (3 * n_nb if cfg.coupling == "hp_opt" else n_nb)

    def full(shape, v, dt=dtype):
        return torch.full(shape, v, dtype=dt, device=dev)

    lambdas = (full((n, n, N), 0.0) if lambdas0 is None else torch.tensor(
        np.asarray(lambdas0, np.float64), dtype=dtype, device=dev))
    return OCDFleetState(
        x0=x_pred[:, 0, :], x_pred=x_pred, u_pred=u_pred,
        u_old=full((n, 2), 0.0), lambdas=lambdas,
        w=full((n, N, m), 0.0), y=full((n, N, m), 0.0),
        rho_scale=full((n, m), 1.0),
        lane=full((n,), cfg.lane, torch.int32),
        hold_count=full((n,), 0, torch.int32),
        brake_count=full((n,), 0, torch.int32),
        jam_count=full((n,), 0, torch.int32))


class NLExperimentResult(NamedTuple):
    states: np.ndarray          # (T, n_ag, 9) applied states per step
    inputs: np.ndarray          # (T, n_ag, 2)
    feasible: np.ndarray        # (T, n_ag)
    min_dist: np.ndarray        # (T,)
    min_dist_exec: np.ndarray   # (T,)
    ocd_iterations: np.ndarray  # (T,)
    step_times: np.ndarray      # (T,) wall clock per control step
    lambdas: np.ndarray         # final duals (cross-run warm start)
    steps: int
    finished: bool
    exec_beta: np.ndarray = np.ones((0, 0))          # (T, n_ag)
    wall_clip: np.ndarray = np.zeros((0, 0), bool)   # (T, n_ag)


def run_nl_experiment(cfg: ExperimentConfig,
                      x0s: Optional[np.ndarray] = None,
                      lambdas0: Optional[np.ndarray] = None,
                      track: Optional[Track] = None,
                      io=None,
                      checkpoint_path: Optional[str] = None,
                      checkpoint_every: int = 50,
                      device="cuda") -> NLExperimentResult:
    """Closed-loop distributed NL-OCD experiment of one fleet (reference
    ``NL_EU_N_main.main``). The host loop handles termination and IO;
    ``checkpoint_path`` enables an exact mid-run resume of the whole state,
    duals included (``runtime/checkpoint.py``). The solver knobs left unset
    follow ``resolve_single_fleet_schedule``."""
    import os
    from colaborativempc_tpu_torch.runtime.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    cfg = resolve_single_fleet_schedule(cfg)
    dev = resolve_device(device)
    dtype = torch.float32 if cfg.dtype == "float32" else torch.float64
    if track is None:
        track = make_track(cfg.map_type, device=dev, dtype=dtype)
    state = batch_fleet_state(init_nl_fleet(track, cfg, x0s, lambdas0,
                                            device=dev), 1, device=dev)
    it = 0
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        state, it = load_checkpoint(checkpoint_path, state)
    core = _build_ocd_core(track, cfg)

    hist = {k: [] for k in ("states", "inputs", "feas", "dist", "dist_e",
                            "ocd_it", "times", "beta", "wall")}
    finished = False
    while it < cfg.max_it:
        t0 = time.perf_counter()
        if cfg.verb_ocd:
            def on_it(it_ocd, secs, delta, _step=it):
                if cfg.verb >= 2:
                    print(f"  [step {_step} OCD {it_ocd}] "
                          f"{secs * 1e3:.1f}ms dx_max={delta:.4f}")
            state, metrics, iter_times = _coordinate(
                core, state, timed=True, on_iteration=on_it)
            if io is not None and hasattr(io, "ocd_iter_times"):
                io.ocd_iter_times.append(iter_times)
        else:
            state, metrics, _ = _coordinate(core, state)
        synchronize(dev)
        hist["times"].append(time.perf_counter() - t0)
        st0, m0 = _fleet0(state), _fleet0(metrics)
        hist["states"].append(st0.x0)
        hist["inputs"].append(st0.u_old)
        hist["feas"].append(m0.feasible)
        hist["dist"].append(float(m0.min_dist))
        hist["dist_e"].append(float(m0.min_dist_exec))
        hist["ocd_it"].append(int(m0.ocd_iterations))
        hist["beta"].append(m0.exec_beta)
        hist["wall"].append(m0.wall_clip)
        if io is not None:
            io.update(it, st0, m0, hist["times"][-1])
        # reference NL semantics: continue on degraded solves, abort only
        # when no agent produced a usable one (NL_EU_N_main.py:113-115)
        if not bool(np.any(hist["feas"][-1])):
            break
        if bool(check_end(track, state.x0[0, :, 6], laps=cfg.laps,
                          lane=cfg.lane).any()):
            finished = True
            break
        it += 1
        if checkpoint_path is not None and it % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, state, it)

    if checkpoint_path is not None:
        save_checkpoint(checkpoint_path, state, it)
    return NLExperimentResult(
        states=np.asarray(hist["states"]), inputs=np.asarray(hist["inputs"]),
        feasible=np.asarray(hist["feas"]), min_dist=np.asarray(hist["dist"]),
        min_dist_exec=np.asarray(hist["dist_e"]),
        ocd_iterations=np.asarray(hist["ocd_it"]),
        step_times=np.asarray(hist["times"]),
        lambdas=state.lambdas[0].cpu().numpy(),
        steps=len(hist["states"]), finished=finished,
        exec_beta=np.asarray(hist["beta"]),
        wall_clip=np.asarray(hist["wall"]))
