# Frozen copy of the port's plain path: colaborativempc_tpu_torch/runtime/
# racing.py as the racing cell was added, imports made relative. Departures
# from the port: no spans; the gains are the configuration's (no battery
# of per-race gains); the rollout, the experiment runner, the track loader
# and the CSV writer are left out.
"""Closed-loop MPCC racing step (reference ``Matlab-tests/MPCC-master/C++/
MPC/mpc.cpp`` runMPC :219-259 and the ``main.cpp`` closed-loop sim
:30-86), batched over B races: every state tensor carries a leading axis B.
One control step re-projects the pose onto the track and unwraps s
(mpc.cpp:223-224), builds the warm guess (the shifted plan,
updateInitialGuess :135-150) and the cold guess (generateNewInitialGuess
:175-196) and selects per race, runs the SQP solve, keeps the failure
bookkeeping with guess reset (:231-252), and integrates the full nonlinear
Pacejka plant with RK4 sub-steps (integrator.cpp simTimeStep :55-68).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device
from .frenet import curvature, frenet_to_cartesian, wrap_s, wrap_to_pi
from .mpcc import M_ROWS, MPCCConfig, MPCCSolution, mpcc_solve
from .pacejka import f_continuous_pacejka
from .spline import project_on_spline
from .tracks import Track


class MPCCState(NamedTuple):
    """Racing-controller state carried across control steps (mpc.h:104-118:
    initial_guess_, valid_initial_guess_, n_non_solves_), leading axis B."""
    x: torch.Tensor             # (B, 9) plant state
    x_bar: torch.Tensor         # (B, N+1, 9) initial guess / last solution
    u_bar: torch.Tensor         # (B, N, 2)
    u_old: torch.Tensor         # (B, 2) last applied input
    w: torch.Tensor             # (B, N, 7) ADMM warm starts
    y: torch.Tensor             # (B, N, 7)
    rho_scale: torch.Tensor     # (B, 7)
    valid_guess: torch.Tensor   # (B,) bool
    n_non_solves: torch.Tensor  # (B,) int32 consecutive failed control steps


class MPCCStepMetrics(NamedTuple):
    feasible: torch.Tensor     # (B,) last-SQP-iteration QP within tolerance
    r_prim: torch.Tensor
    iterations: torch.Tensor   # ADMM iterations across the SQP iterations
    sqp_fails: torch.Tensor    # failed QP solves this step
    reset: torch.Tensor        # guess was regenerated from the track
    s: torch.Tensor            # unwrapped progress after the step
    vx: torch.Tensor
    ey: torch.Tensor


def _relocalize_unwrapped(track: Track, x: torch.Tensor) -> torch.Tensor:
    """Project the poses ``x (B, 9)`` onto the track and refresh (s, ey,
    epsi), keeping s unwrapped (cumulative across laps): the Newton
    projection starts from the previous wrapped s, and the shortest signed
    wrap-aware increment is added to the previous s (the reference's
    ``porjectOnSpline`` + ``unwrap``, mpc.cpp:223-224)."""
    s_prev = x[:, 6]
    L = track.track_length[0]
    s_w = wrap_s(track, s_prev)
    ds = project_on_spline(track, x[:, 7], x[:, 8], s_w) - s_w
    wrapped = torch.where(ds > L / 2, ds - L,
                          torch.where(ds < -L / 2, ds + L, ds))
    s_new = s_prev + torch.where(track.open_flag, ds, wrapped)
    px, py, theta_t = frenet_to_cartesian(track, s_new, 0.0)
    ey = -(x[:, 7] - px) * torch.sin(theta_t) + (x[:, 8] - py) * torch.cos(
        theta_t)
    epsi = wrap_to_pi(x[:, 5] - theta_t)
    return torch.cat([x[:, :3], ey[:, None], epsi[:, None], x[:, 5:6],
                      s_new[:, None], x[:, 7:]], dim=-1)


def _warm_guess(track: Track, cfg: MPCCConfig, x0: torch.Tensor,
                x_bar: torch.Tensor, u_bar: torch.Tensor):
    """Shift the previous solution one stage and append a one-step Euler
    tail at zero input (``updateInitialGuess``, mpc.cpp:135-150); stage 0
    pinned to the measured state."""
    last = x_bar[:, -1]
    kap = curvature(track, last[:, 6])
    tail = last + cfg.dt * f_continuous_pacejka(
        last, torch.zeros_like(last[:, :2]), kap, cfg.model)
    x_new = torch.cat([x0[:, None], x_bar[:, 2:], tail[:, None]], dim=1)
    u_new = torch.cat([u_bar[:, 1:], torch.zeros_like(u_bar[:, :1])], dim=1)
    return x_new, u_new


def _cold_guess(track: Track, cfg: MPCCConfig, x0: torch.Tensor):
    """A fresh guess rolling along the centerline at ``initial_velocity``
    from the projected pose (``generateNewInitialGuess``,
    mpc.cpp:175-196), the heading unwrapped along the horizon; stage 0 is
    the measured state."""
    dtype, dev = x0.dtype, x0.device
    v0 = torch.tensor(cfg.initial_velocity, dtype=dtype, device=dev)
    ks = torch.arange(cfg.N + 1, dtype=dtype, device=dev)
    ss = x0[:, 6:7] + ks * cfg.dt * v0                   # (B, N+1)
    px, py, th = frenet_to_cartesian(track, ss, 0.0)
    dth = wrap_to_pi(th[:, 1:] - th[:, :-1])
    th_unwrapped = th[:, :1] + torch.cat(
        [torch.zeros_like(th[:, :1]), torch.cumsum(dth, dim=1)], dim=1)
    zero = torch.zeros_like(ss)
    x_new = torch.stack([v0.expand_as(ss), zero, zero, zero, zero,
                         th_unwrapped, ss, px, py], dim=-1)
    x_new = torch.cat([x0[:, None], x_new[:, 1:]], dim=1)
    return x_new, torch.zeros(x0.shape[:1] + (cfg.N, 2), dtype=dtype,
                              device=dev)


def _plant_rk4(track: Track, cfg: MPCCConfig, x: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """Integrate the nonlinear Pacejka plant over one control period with
    ``plant_substeps`` RK4 sub-steps (``Integrator::simTimeStep``,
    integrator.cpp:55-68), the curvature re-read at every stage."""
    h = cfg.dt / cfg.plant_substeps

    def f(xx):
        return f_continuous_pacejka(xx, u, curvature(track, xx[:, 6]),
                                    cfg.model)

    for _ in range(cfg.plant_substeps):
        k1 = f(x)
        k2 = f(x + 0.5 * h * k1)
        k3 = f(x + 0.5 * h * k2)
        k4 = f(x + h * k3)
        x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return x


def make_mpcc_step(track: Track, cfg: MPCCConfig):
    """One control step of B races with the config's gains:
    ``MPCCState -> (MPCCState, MPCCStepMetrics)`` (the body of mpc.cpp
    runMPC + one main.cpp sim step)."""
    norm = cfg.normalization()
    hard_fail_thresh = max(cfg.n_sqp - 1, 1)   # mpc.cpp:244

    def step(state: MPCCState):
        x0 = _relocalize_unwrapped(track, state.x)
        valid = state.valid_guess
        v3 = valid[:, None, None]
        # both guesses are built; a select (never a blend) keeps a
        # non-finite warm guess of an invalid race out of the result
        x_w, u_w = _warm_guess(track, cfg, x0, state.x_bar, state.u_bar)
        x_c, u_c = _cold_guess(track, cfg, x0)
        x_bar = torch.where(v3, x_w, x_c)
        u_bar = torch.where(v3, u_w, u_c)
        # a cold start also resets the ADMM warm starts (new geometry)
        w0 = torch.where(v3, state.w, torch.zeros_like(state.w))
        y0 = torch.where(v3, state.y, torch.zeros_like(state.y))
        rs0 = torch.where(valid[:, None], state.rho_scale,
                          torch.ones_like(state.rho_scale))

        sol: MPCCSolution = mpcc_solve(
            track, cfg.gains, cfg.model, cfg.N, cfg.dt,
            x0, x_bar, u_bar, state.u_old,
            sqp_iters=cfg.n_sqp, sqp_mix=cfg.sqp_mixing,
            admm_iters=cfg.admm_iters, rho=cfg.rho,
            bounds=cfg.bounds, norm=norm,
            w0=w0, y0=y0, rho_scale0=rs0,
            epoch_len=cfg.resolved_epoch_len(),
            assoc=cfg.resolved_assoc())

        finite = (torch.isfinite(sol.x_pred).flatten(1).all(1)
                  & torch.isfinite(sol.u_pred).flatten(1).all(1))
        # failure bookkeeping (mpc.cpp:231-252): a step whose SQP loop
        # failed (nearly) every QP is a non-solve; n_reset consecutive
        # non-solves invalidate the guess, so the next step cold-starts
        hard_fail = (~finite) | (sol.sqp_fails >= hard_fail_thresh)
        n_non = torch.where(hard_fail, state.n_non_solves + 1,
                            torch.zeros_like(state.n_non_solves))
        valid_next = finite & (n_non < cfg.n_reset)

        f1, f3 = finite[:, None], finite[:, None, None]
        # a rejected solve applies the shifted previous plan's first input
        # (runMPC returns initial_guess_[0].uk, mpc.cpp:255-258)
        u0 = torch.where(f1, sol.u_pred[:, 0], u_bar[:, 0])
        x_next = _plant_rk4(track, cfg, x0, u0)

        new_state = MPCCState(
            x=x_next, x_bar=torch.where(f3, sol.x_pred, x_bar),
            u_bar=torch.where(f3, sol.u_pred, u_bar), u_old=u0,
            w=torch.where(f3, sol.w, w0), y=torch.where(f3, sol.y, y0),
            rho_scale=torch.where(f1, sol.rho_scale, rs0),
            valid_guess=valid_next, n_non_solves=n_non)
        metrics = MPCCStepMetrics(
            feasible=sol.feasible, r_prim=sol.r_prim,
            iterations=sol.iterations, sqp_fails=sol.sqp_fails,
            reset=~valid, s=x_next[:, 6], vx=x_next[:, 0], ey=x_next[:, 3])
        return new_state, metrics

    return step


def init_mpcc(track: Track, cfg: MPCCConfig, x0=None, races: int = 1,
              dtype=torch.float32, device="cuda") -> MPCCState:
    """Initial racing state of ``races`` races on ``device`` (which must
    hold ``track``): the pose on the track start at ``initial_velocity``
    (or ``x0``, ``(9,)`` or ``(races, 9)``), with an invalid guess so the
    first step cold-starts (mpc.cpp valid_initial_guess_ = false)."""
    dev = resolve_device(device)
    if x0 is None:
        px, py, th = frenet_to_cartesian(track, 0.0, 0.0)
        x0 = torch.zeros(9, dtype=torch.float64)
        x0[0] = cfg.initial_velocity
        x0[5], x0[7], x0[8] = float(th), float(px), float(py)
    elif not isinstance(x0, torch.Tensor):
        x0 = torch.tensor(np.asarray(x0, np.float64))
    x0 = torch.broadcast_to(x0.to(device=dev, dtype=dtype), (races, 9)).clone()
    N = cfg.N

    def zeros(*shape):
        return torch.zeros((races,) + shape, dtype=dtype, device=dev)
    return MPCCState(
        x=x0, x_bar=x0[:, None].expand(races, N + 1, 9).clone(),
        u_bar=zeros(N, 2), u_old=zeros(2), w=zeros(N, M_ROWS),
        y=zeros(N, M_ROWS),
        rho_scale=torch.ones((races, M_ROWS), dtype=dtype, device=dev),
        valid_guess=torch.zeros((races,), dtype=torch.bool, device=dev),
        n_non_solves=torch.zeros((races,), dtype=torch.int32, device=dev))
