"""Closed-loop MPCC racing runtime (PyTorch port).

Twin of ``colaborativempc_tpu/runtime/racing.py`` (reference
``Matlab-tests/MPCC-master/C++/MPC/mpc.cpp`` runMPC :219-259 and the
``main.cpp`` closed-loop sim :30-86), batched over B races: every state
tensor carries a leading axis B, where the JAX step is per race and
vmapped. One control step re-projects the pose onto the track and unwraps
s (mpc.cpp:223-224), builds the warm guess (the shifted plan,
updateInitialGuess :135-150) and the cold guess (generateNewInitialGuess
:175-196) and selects per race, runs the SQP solve, keeps the failure
bookkeeping with guess reset (:231-252), and integrates the full nonlinear
Pacejka plant with RK4 sub-steps (integrator.cpp simTimeStep :55-68). The
host loop of ``run_mpcc_experiment`` handles termination and IO. On the
card the ops before and after the solve run as two CUDA graphs
(``_make_mpcc_step_fn``). Spans (``utils/tracing.py``): ``cmpc.step``
around a step, ``cmpc.guess`` (re-projection and both guesses),
``cmpc.plant`` (failure bookkeeping and the plant); the SQP loop's are
``planners/mpcc.py``'s.
"""

from __future__ import annotations

import functools
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from colaborativempc_tpu_torch.dynamics.pacejka import f_continuous_pacejka
from colaborativempc_tpu_torch.geometry import (
    Track, curvature, frenet_to_cartesian, make_track, project_on_spline,
    track_from_json, wrap_s, wrap_to_pi,
)
from colaborativempc_tpu_torch.ops.admm import scale_stage_qp
from colaborativempc_tpu_torch.planners.mpcc import (
    M_ROWS, MPCCConfig, MPCCGains, MPCCSolution, build_mpcc_qp, mpcc_solve,
)
from colaborativempc_tpu_torch.utils.device import resolve_device, synchronize
from colaborativempc_tpu_torch.utils.graphs import graphed
from colaborativempc_tpu_torch.utils.tracing import span


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
    v0 = torch.full((), cfg.initial_velocity, dtype=dtype, device=dev)
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


def _guess_phase(track: Track, cfg: MPCCConfig, x, x_bar, u_bar, valid, w,
                 y, rho_scale):
    """A step's ops before the SQP solve: the pose re-projected and both
    guesses selected per race, ``(x0, x_bar, u_bar, w0, y0, rho_scale0)``."""
    x0 = _relocalize_unwrapped(track, x)
    v3 = valid[:, None, None]
    # both guesses are built; a select (never a blend) keeps a non-finite
    # warm guess of an invalid race out of the result
    x_w, u_w = _warm_guess(track, cfg, x0, x_bar, u_bar)
    x_c, u_c = _cold_guess(track, cfg, x0)
    # a cold start also resets the ADMM warm starts (new geometry)
    return (x0, torch.where(v3, x_w, x_c), torch.where(v3, u_w, u_c),
            torch.where(v3, w, torch.zeros_like(w)),
            torch.where(v3, y, torch.zeros_like(y)),
            torch.where(valid[:, None], rho_scale, torch.ones_like(rho_scale)))


def _advance_phase(track: Track, cfg: MPCCConfig, x0, x_bar, u_bar, w0, y0,
                   rs0, valid, n_non_solves, x_pred, u_pred, w, y, rho_scale,
                   sqp_fails):
    """A step's ops after the SQP solve: failure bookkeeping and the plant,
    the fields of the next :class:`MPCCState` and the reset flag."""
    finite = (torch.isfinite(x_pred).flatten(1).all(1)
              & torch.isfinite(u_pred).flatten(1).all(1))
    # failure bookkeeping (mpc.cpp:231-252): a step whose SQP loop failed
    # (nearly) every QP is a non-solve; n_reset consecutive non-solves
    # invalidate the guess, so the next step cold-starts
    hard_fail = (~finite) | (sqp_fails >= max(cfg.n_sqp - 1, 1))  # :244
    n_non = torch.where(hard_fail, n_non_solves + 1,
                        torch.zeros_like(n_non_solves))
    valid_next = finite & (n_non < cfg.n_reset)

    f1, f3 = finite[:, None], finite[:, None, None]
    # a rejected solve applies the shifted previous plan's first input
    # (runMPC returns initial_guess_[0].uk, mpc.cpp:255-258)
    u0 = torch.where(f1, u_pred[:, 0], u_bar[:, 0])
    x_next = _plant_rk4(track, cfg, x0, u0)
    return (x_next, torch.where(f3, x_pred, x_bar),
            torch.where(f3, u_pred, u_bar), u0,
            torch.where(f3, w, w0), torch.where(f3, y, y0),
            torch.where(f1, rho_scale, rs0), valid_next, n_non, ~valid)


def _make_mpcc_step_fn(track: Track, cfg: MPCCConfig):
    """The one-control-step body with the racing gains as an argument:
    ``(gains, state) -> (state, metrics)``; each gain a float or a ``(B,)``
    tensor, so a gain battery races its grid as the batch axis.

    The step's own ops around the SQP solve (:func:`_guess_phase`,
    :func:`_advance_phase`) are two fixed-shape stretches of some two
    thousand tiny kernels each; on CUDA tensors each is replayed from one
    CUDA graph (``utils/graphs.py``: the same kernels, the same bits)."""
    norm = cfg.normalization()
    guess = graphed(functools.partial(_guess_phase, track, cfg))
    advance = graphed(functools.partial(_advance_phase, track, cfg))

    def step(gains: MPCCGains, state: MPCCState):
        with span("cmpc.step"):
            return control_step(gains, state)

    def control_step(gains: MPCCGains, state: MPCCState):
        valid = state.valid_guess
        with span("cmpc.guess"):
            x0, x_bar, u_bar, w0, y0, rs0 = guess(
                state.x, state.x_bar, state.u_bar, valid, state.w, state.y,
                state.rho_scale)

        sol: MPCCSolution = mpcc_solve(
            track, gains, cfg.model, cfg.N, cfg.dt,
            x0, x_bar, u_bar, state.u_old,
            sqp_iters=cfg.n_sqp, sqp_mix=cfg.sqp_mixing,
            admm_iters=cfg.admm_iters, rho=cfg.rho,
            bounds=cfg.bounds, norm=norm,
            w0=w0, y0=y0, rho_scale0=rs0,
            epoch_len=cfg.resolved_epoch_len(),
            assoc=cfg.resolved_assoc())

        with span("cmpc.plant"):
            out = advance(x0, x_bar, u_bar, w0, y0, rs0, valid,
                          state.n_non_solves, sol.x_pred, sol.u_pred, sol.w,
                          sol.y, sol.rho_scale, sol.sqp_fails)
            if x0.is_cuda:
                out = tuple(t.clone() for t in out)   # the graph's buffers
        new_state = MPCCState(*out[:9])
        x_next = new_state.x
        metrics = MPCCStepMetrics(
            feasible=sol.feasible, r_prim=sol.r_prim,
            iterations=sol.iterations, sqp_fails=sol.sqp_fails,
            reset=out[9], s=x_next[:, 6], vx=x_next[:, 0], ey=x_next[:, 3])
        return new_state, metrics

    return step


def make_mpcc_step(track: Track, cfg: MPCCConfig):
    """One control step of B races with the config's gains:
    ``MPCCState -> (MPCCState, MPCCStepMetrics)`` (the body of mpc.cpp
    runMPC + one main.cpp sim step)."""
    step_fn = _make_mpcc_step_fn(track, cfg)
    return lambda state: step_fn(cfg.gains, state)


def _race(step, state, steps):
    ms = []
    for _ in range(steps):
        state, m = step(state)
        ms.append(m)
    return state, MPCCStepMetrics(*(torch.stack(f, 1) for f in zip(*ms)))


def make_mpcc_rollout(track: Track, cfg: MPCCConfig, steps: int):
    """Fixed-step closed-loop race of B races: ``state -> (final_state,
    MPCCStepMetrics)`` with metrics ``(B, steps)`` — the layout of the
    vmapped JAX rollout."""
    step = make_mpcc_step(track, cfg)
    return lambda state: _race(step, state, steps)


def init_mpcc(track: Track, cfg: MPCCConfig, x0=None, races: int = 1,
              dtype=torch.float32, device="cuda") -> MPCCState:
    """Initial racing state of ``races`` races on ``device`` (which must
    hold ``track``; the default ``cuda`` raises without a card): the pose
    on the track start at ``initial_velocity`` (or ``x0``, ``(9,)`` or
    ``(races, 9)``), with an invalid guess so the first step cold-starts
    (mpc.cpp valid_initial_guess_ = false)."""
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


def cold_start_qps(track: Track, cfg: MPCCConfig, races: int):
    """The first SQP iteration's stage QPs of ``races`` cold-started races
    spread evenly over ``track`` (on its device), normalised as
    ``mpcc_solve`` hands them to the solver when ``cfg.normalize`` is on,
    and their scaled initial states ``z0 (races, 11)``: the ADMM epoch's
    inputs at MPCC's own shapes, for checks and timings of the epoch
    alone."""
    dev = track.track_length.device
    s = torch.arange(races, dtype=torch.float32, device=dev) * (
        float(track.track_length[0]) / races)
    px, py, th = frenet_to_cartesian(track, s, 0.0)
    zero = torch.zeros_like(s)
    x0 = torch.stack([0.5 + 0.05 * torch.arange(races, device=dev), zero,
                      zero, zero, zero, th, s, px, py], dim=-1)
    x_bar, u_bar = _cold_guess(track, cfg, x0)
    qp = build_mpcc_qp(track, cfg.gains, cfg.model, cfg.N, cfg.dt, x_bar,
                       u_bar, cfg.bounds)
    z0 = torch.cat([x0, torch.zeros_like(x0[:, :2])], dim=-1)
    norm = cfg.normalization()
    if norm is not None:
        tz = norm.t_z.to(dev)
        qp = scale_stage_qp(qp, tz, norm.t_du.to(dev))
        z0 = z0 / tz
    return qp, z0.contiguous()


class MPCCResult(NamedTuple):
    states: np.ndarray       # (T, 9) plant states
    inputs: np.ndarray       # (T, 2)
    feasible: np.ndarray     # (T,)
    resets: np.ndarray       # (T,) steps that cold-started
    step_times: np.ndarray   # (T,) wall clock
    iterations: np.ndarray   # (T,) ADMM iterations
    steps: int
    finished: bool           # laps completed (when cfg.laps > 0)
    lap_time: Optional[float]  # first-lap time [s] when a lap completed


def load_mpcc_track(cfg: MPCCConfig, dtype=torch.float32,
                    device="cuda") -> Track:
    """Track for a config on ``device`` (the default ``cuda`` raises
    without a card): fitted from the reference JSON when given
    (``geometry/spline.py``), else the named analytic track."""
    if cfg.track_json is not None:
        return track_from_json(cfg.track_json, dtype=dtype, device=device)
    return make_track(cfg.map_type, device=device, dtype=dtype)


def run_mpcc_experiment(cfg: MPCCConfig, track: Optional[Track] = None,
                        x0=None, dtype=torch.float32,
                        device="cuda") -> MPCCResult:
    """Closed-loop race (reference ``main.cpp:30-86``) on ``device`` (the
    default ``cuda`` raises without a card): ``n_sim`` control steps,
    ending early after ``cfg.laps`` laps when set or on a non-finite
    state; solve-time statistics printed at ``verb >= 1``; the reference
    CSV schema written when ``cfg.save_data``."""
    dev = resolve_device(device)
    if track is None:
        track = load_mpcc_track(cfg, dtype=dtype, device=dev)
    state = init_mpcc(track, cfg, x0, dtype=dtype, device=dev)
    step = make_mpcc_step(track, cfg)
    L = float(track.track_length[0])

    states, inputs, feas, resets, times, iters = [], [], [], [], [], []
    finished = False
    lap_time = None
    for it in range(cfg.n_sim):
        t0 = time.perf_counter()
        state, metrics = step(state)
        synchronize(dev)
        times.append(time.perf_counter() - t0)
        states.append(state.x[0].cpu().numpy())
        inputs.append(state.u_old[0].cpu().numpy())
        feas.append(bool(metrics.feasible[0]))
        resets.append(bool(metrics.reset[0]))
        iters.append(int(metrics.iterations[0]))
        if not np.all(np.isfinite(states[-1])):
            break
        s_now = float(states[-1][6])
        if lap_time is None and s_now >= L:
            lap_time = (it + 1) * cfg.dt
        if cfg.verb >= 1 and (it % 50 == 0 or it == cfg.n_sim - 1):
            print(f"[mpcc {it}] s={s_now:.2f} vx={states[-1][0]:.2f} "
                  f"ey={states[-1][3]:.3f} "
                  f"iters={iters[-1]} {times[-1] * 1e3:.1f}ms")
        if cfg.laps > 0 and s_now >= cfg.laps * L:
            finished = True
            break

    result = MPCCResult(
        states=np.asarray(states), inputs=np.asarray(inputs),
        feasible=np.asarray(feas), resets=np.asarray(resets),
        step_times=np.asarray(times), iterations=np.asarray(iters),
        steps=len(states), finished=finished, lap_time=lap_time)
    if cfg.save_data:
        save_mpcc_result(cfg, result)
    if cfg.verb >= 1 and len(times) > 3:
        warm = np.asarray(times[3:])
        print(f"mean solve {warm.mean() * 1e3:.1f} ms  "
              f"max {warm.max() * 1e3:.1f} ms")   # main.cpp:75-84 report
    return result


def save_mpcc_result(cfg: MPCCConfig, res: MPCCResult) -> None:
    """Persist the single-agent reference CSV schema (states.dat, u.dat,
    time.dat under <path>/csv/0/, base_class.py:64-99 layout)."""
    d = os.path.join(cfg.path, "csv", "0")
    os.makedirs(d, exist_ok=True)
    np.savetxt(os.path.join(d, "states.dat"), res.states, fmt="%0.5f")
    np.savetxt(os.path.join(d, "u.dat"), res.inputs, fmt="%0.5f")
    np.savetxt(os.path.join(d, "time.dat"), res.step_times, fmt="%0.5f")
