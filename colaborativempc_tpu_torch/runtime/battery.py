"""Experiment batteries: gain sweeps as batches of fleets (PyTorch port).

Counterpart of the LPV and NL parts of
``colaborativempc_tpu/runtime/battery.py``. The reference runs a serial
grid, one full experiment per gain combination
(``planner/scripts/experiment_battery.py:15-38``); here every combination
is one fleet of a batch, with its gains on a leading fleet axis, and all
advance together. Horizon sweeps change shapes and stay an outer loop.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from colaborativempc_tpu_torch.config.params import ExperimentConfig, Gains
from colaborativempc_tpu_torch.geometry import Track, make_track
from colaborativempc_tpu_torch.planners.lpv import lpv_solve
from colaborativempc_tpu_torch.runtime.simulate import (
    FleetState, _neighbour_index, _per_problem, batch_fleet_state,
    init_lpv_fleet,
)
from colaborativempc_tpu_torch.utils.device import resolve_device


def gain_grid(base: Gains, q_vx=None, q_ey=None, q_epsi=None,
              dr_scale=None, wq=None) -> list[Gains]:
    """The cartesian gain grid (reference sweeps Qvx, Qey, Qew, QdU, QU,
    experiment_battery.py:15-27)."""
    q_vx = q_vx if q_vx is not None else [float(base.q[0])]
    q_ey = q_ey if q_ey is not None else [float(base.q[3])]
    q_epsi = q_epsi if q_epsi is not None else [float(base.q[4])]
    dr_scale = dr_scale if dr_scale is not None else [1.0]
    wq = wq if wq is not None else [base.wq]
    out = []
    for vx, ey, ep, drs, w in itertools.product(q_vx, q_ey, q_epsi,
                                                dr_scale, wq):
        q = np.asarray(base.q, np.float64).copy()
        q[0], q[3], q[4] = vx, ey, ep
        out.append(Gains(q=q, qs=np.asarray(base.qs), r=np.asarray(base.r),
                         dr=np.asarray(base.dr) * drs, wq=w))
    return out


def _stack_gains(grid: Sequence[Gains], device, dtype) -> Gains:
    """The grid as per-fleet gains ``(n_cfg, k)``, each value rounded to
    float32 as the JAX battery does."""
    def stack(f):
        a = np.stack([np.asarray(getattr(g, f), np.float32) for g in grid])
        return torch.tensor(a).to(device=device, dtype=dtype)
    return Gains(*(stack(f) for f in Gains._fields))


class BatteryResult(NamedTuple):
    states: np.ndarray         # (T, n_cfg, n_agents, 9)
    min_dist_exec: np.ndarray  # (T, n_cfg)
    feasible: np.ndarray       # (T, n_cfg, n_agents)
    progress: np.ndarray       # (n_cfg,) final mean s per config
    n_configs: int


def run_lpv_battery(cfg: ExperimentConfig, grid: Sequence[Gains],
                    steps: int, track: Track | None = None,
                    device="cuda") -> BatteryResult:
    """Advance every gain combination in lock-step, one fleet each. The
    step is the JAX battery's plain LPV step: every agent executes its
    plan's first stage (no plan-holding, envelope or separation filter)."""
    dev = resolve_device(device)
    if track is None:
        track = make_track(cfg.map_type, device=dev)
    dtype = torch.float32 if cfg.dtype == "float32" else torch.float64
    n, n_cfg = cfg.n_agents, len(grid)
    gains = _per_problem(_stack_gains(grid, dev, dtype), n)
    ns = torch.as_tensor(_neighbour_index(n), device=dev)
    state = batch_fleet_state(init_lpv_fleet(track, cfg, device=dev), n_cfg,
                              device=dev)
    sv = cfg.solver

    def flat(t):
        return t.reshape((n_cfg * n,) + t.shape[2:])

    x0_h, dist_h, feas_h = [], [], []
    for _ in range(steps):
        neigh = (flat(state.x_pred[:, ns][..., 7:9].transpose(2, 3))
                 if n > 1 else None)
        sol = lpv_solve(
            track, gains, cfg.limits, cfg.model, cfg.N, cfg.dt,
            flat(state.x0), flat(state.x_pred), flat(state.u_pred),
            flat(state.u_old), neigh, w0=flat(state.w), y0=flat(state.y),
            rho_scale0=flat(state.rho_scale), admm_iters=sv.admm_budget(),
            rho=sv.rho, alpha_relax=sv.alpha_relax, eps=sv.eps,
            lane=cfg.lane)
        x_pred, u_pred, w, y, rs, feas = (
            t.reshape((n_cfg, n) + t.shape[1:]) for t in
            (sol.x_pred, sol.u_pred, sol.w, sol.y, sol.rho_scale,
             sol.feasible))
        state = FleetState(
            x0=x_pred[:, :, 1], x_pred=x_pred, u_pred=u_pred,
            u_old=u_pred[:, :, 0], w=w, y=y, rho_scale=rs, lane=state.lane,
            hold_count=state.hold_count, brake_count=state.brake_count,
            jam_count=state.jam_count)
        pe = x_pred[:, :, 1, 7:9]
        de = torch.sqrt(torch.sum((pe[:, :, None] - pe[:, None]) ** 2, dim=-1)
                        + 1e-12) + torch.eye(n, dtype=pe.dtype, device=dev) * 1e9
        x0_h.append(state.x0)
        dist_h.append(torch.amin(de, dim=(1, 2)))
        feas_h.append(feas)
    states = torch.stack(x0_h).cpu().numpy()
    return BatteryResult(
        states=states, min_dist_exec=torch.stack(dist_h).cpu().numpy(),
        feasible=torch.stack(feas_h).cpu().numpy(),
        progress=states[-1, :, :, 6].mean(axis=-1), n_configs=n_cfg)


class NLBatteryResult(NamedTuple):
    states: np.ndarray          # (T, n_cfg, n_agents, 9)
    min_dist: np.ndarray        # (T, n_cfg) min predicted pairwise distance
    min_dist_exec: np.ndarray   # (T, n_cfg)
    feasible: np.ndarray        # (T, n_cfg, n_agents)
    ocd_iterations: np.ndarray  # (T, n_cfg) per-step OCD depth per config
    progress: np.ndarray        # (n_cfg,) final mean s per config
    n_configs: int


def run_nl_battery(cfg: ExperimentConfig, grid: Sequence[Gains],
                   steps: int, track: Track | None = None,
                   x0s=None, device="cuda") -> NLBatteryResult:
    """NL-OCD battery: every gain combination runs its full coordination
    loop as one fleet of a batch. The per-fleet freeze of the OCD loop
    keeps each configuration's trajectory and OCD iteration counts those of
    a standalone run."""
    from colaborativempc_tpu_torch.runtime.ocd import (
        init_nl_fleet, make_nl_ocd_rollout_gains,
    )
    dev = resolve_device(device)
    if track is None:
        track = make_track(cfg.map_type, device=dev)
    dtype = torch.float32 if cfg.dtype == "float32" else torch.float64
    n_cfg = len(grid)
    rollout = make_nl_ocd_rollout_gains(track, cfg, steps)
    state = batch_fleet_state(init_nl_fleet(track, cfg, x0s, device=dev),
                              n_cfg, device=dev)
    _, (x0_h, _, m) = rollout(_stack_gains(grid, dev, dtype), state)

    def hist(t):      # (n_cfg, T, ...) -> (T, n_cfg, ...)
        return np.moveaxis(t.cpu().numpy(), 0, 1)
    states = hist(x0_h)
    return NLBatteryResult(
        states=states, min_dist=hist(m.min_dist),
        min_dist_exec=hist(m.min_dist_exec), feasible=hist(m.feasible),
        ocd_iterations=hist(m.ocd_iterations),
        progress=states[-1, :, :, 6].mean(axis=-1), n_configs=n_cfg)


# ---------------------------------------------------------------------------
# MPCC racing battery: a gain grid as one batch of closed-loop races
# ---------------------------------------------------------------------------

def mpcc_gain_grid(base, q_contour=None, q_progress=None, dr_scale=None):
    """Cartesian grid over the racing trade-off knobs (contouring accuracy
    vs progress reward vs input smoothness) — the reference tunes these by
    hand-editing cost.json and re-running the binary (main.cpp)."""
    q_contour = q_contour if q_contour is not None else [base.q_contour]
    q_progress = q_progress if q_progress is not None else [base.q_progress]
    dr_scale = dr_scale if dr_scale is not None else [1.0]
    out = []
    for qc, qp, drs in itertools.product(q_contour, q_progress, dr_scale):
        out.append(base._replace(q_contour=float(qc), q_progress=float(qp),
                                 dr_delta=base.dr_delta * drs,
                                 dr_drive=base.dr_drive * drs))
    return out


class MPCCBatteryResult(NamedTuple):
    s_hist: np.ndarray         # (T, n_cfg) progress per step
    vx_hist: np.ndarray        # (T, n_cfg)
    ey_hist: np.ndarray        # (T, n_cfg)
    feasible_frac: np.ndarray  # (n_cfg,)
    resets: np.ndarray         # (n_cfg,) cold-start count (beyond the first)
    progress: np.ndarray       # (n_cfg,) final s
    lap_time: np.ndarray       # (n_cfg,) first-lap time [s]; nan = no lap
    n_configs: int


def run_mpcc_battery(cfg, grid, steps: int, track=None, dtype=torch.float32,
                     device="cuda", mesh=None) -> MPCCBatteryResult:
    """Race every gain combination at once on ``device`` (the default
    ``cuda`` raises without a card): the grid is the race axis B of one
    batched closed-loop rollout (warm/cold start, failure reset, RK4 plant —
    ``runtime/racing.py``), each race with its own gains rounded to float32
    as in the JAX battery. ``admm_solve``'s per-problem freeze keeps every
    race's iteration counts those of its standalone run.

    ``mesh``: a ``DeviceMesh`` over every rank of the process group. The
    races are independent, so each rank races its contiguous slice of the
    grid (in the mesh's row-major order) and every rank returns the whole
    result, gathered; the grid must split evenly over the mesh."""
    from colaborativempc_tpu_torch.planners.mpcc import MPCCGains
    from colaborativempc_tpu_torch.runtime.racing import (
        _make_mpcc_step_fn, _race, init_mpcc, load_mpcc_track,
    )
    dev = resolve_device(device)
    if track is None:
        track = load_mpcc_track(cfg, dtype=dtype, device=dev)
    n_cfg = len(grid)
    races = list(grid)
    if mesh is not None:
        from colaborativempc_tpu_torch.parallel.multihost import (
            check_mesh, gather_over_mesh, mesh_position,
        )
        check_mesh(mesh)
        if n_cfg % mesh.size():
            raise ValueError(f"grid size {n_cfg} must divide the mesh "
                             f"({mesh.size()} devices)")
        k = n_cfg // mesh.size()
        races = races[mesh_position(mesh) * k:(mesh_position(mesh) + 1) * k]
    gains = MPCCGains(*(
        torch.tensor(np.asarray([getattr(g, f) for g in races], np.float32))
        .to(device=dev, dtype=dtype) for f in MPCCGains._fields))
    step_fn = _make_mpcc_step_fn(track, cfg)
    state = init_mpcc(track, cfg, races=len(races), dtype=dtype, device=dev)
    final, metrics = _race(lambda st: step_fn(gains, st), state, steps)
    if mesh is not None:
        final = type(final)(*(gather_over_mesh(t, mesh) for t in final))
        metrics = type(metrics)(*(gather_over_mesh(t, mesh) for t in metrics))

    s_hist = metrics.s.cpu().numpy().T           # (T, n_cfg)
    L = float(track.track_length[0])
    lap_time = np.full(n_cfg, np.nan)
    for c in range(n_cfg):
        hit = np.nonzero(s_hist[:, c] >= L)[0]
        if hit.size:
            lap_time[c] = (hit[0] + 1) * cfg.dt
    return MPCCBatteryResult(
        s_hist=s_hist, vx_hist=metrics.vx.cpu().numpy().T,
        ey_hist=metrics.ey.cpu().numpy().T,
        feasible_frac=metrics.feasible.cpu().numpy().mean(axis=1),
        resets=metrics.reset.cpu().numpy().sum(axis=1) - 1,
        progress=final.x[:, 6].cpu().numpy(), lap_time=lap_time,
        n_configs=n_cfg)
