"""Typed configuration for the collaborative-MPC framework (PyTorch port).

Field-for-field twin of ``colaborativempc_tpu/config/params.py`` so one
configuration drives both packages. Everything here is plain Python and
numpy: gains stay device-free and are moved onto the solve's device and
dtype where the QP is assembled (``planners/lpv.py``). The XLA/Pallas knobs
``use_pallas``, ``pallas_interpret`` and ``unroll`` are left out: the ADMM
epoch runs the hand-written CUDA kernel whenever its tensors are on a CUDA
device (``ops/cuda_lqr.py``).

One typed config system replacing the reference's scattered Python-dict
settings modules (``planner/scripts/config_files/config_LPV.py``,
``config_NL.py``), hard-coded planner defaults (``LPV_Planner.py:34-72``,
``base_nl.py:22-61``) and the "SCALED CAR" model database
(``config/base_class.py:19-41``). Everything the solver reads is a
NamedTuple of scalars/arrays; shapes (N, n_agents, ...) are fixed per run.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np


class ModelParams(NamedTuple):
    """Bicycle-model physical parameters (reference base_class.py:20-28)."""
    lf: float = 0.125   # CoG -> front axle [m]
    lr: float = 0.125   # CoG -> rear axle [m]
    m: float = 1.98     # mass [kg]
    I: float = 0.09     # yaw inertia [kg m^2]
    Cf: float = 70.0    # front cornering stiffness [N/rad]
    Cr: float = 70.0    # rear cornering stiffness [N/rad]
    mu: float = 0.05    # rolling/viscous friction coefficient


class SysLimits(NamedTuple):
    """Actuator / velocity / safety limits (reference base_class.py:30-41)."""
    vx_ref: float = 3.0    # tracked longitudinal speed [m/s]
    min_dist: float = 0.25  # inter-vehicle safety distance [m]
    max_vel: float = 5.5
    min_vel: float = 0.0
    max_rs: float = 0.3    # max right steering [rad]
    max_ls: float = 0.3    # max left steering [rad]
    max_ac: float = 5.0    # max acceleration [m/s^2]
    max_dc: float = 10.0   # max deceleration [m/s^2]
    sm: float = 0.9        # lane half-width shrink factor


class Gains(NamedTuple):
    """MPC weights. Diagonals only, as in the reference configs.

    q: (9,) state weights; qs: (3,) slack weights (model, control, obstacle);
    r: (2,) input weights; dr: (2,) input-rate weights; wq: separation-reward
    weight (reference config_LPV.py:6-11, config_NL.py:5-10).
    """
    q: np.ndarray
    qs: np.ndarray
    r: np.ndarray
    dr: np.ndarray
    wq: float = 5.0


def lpv_gains() -> Gains:
    """Reference LPV experiment gains (config_files/config_LPV.py:5-11)."""
    return Gains(
        q=np.array([10.0, 0.0, 0.0, 25.0, 10.0, 0.0, 0.0, 0.0, 0.0]),
        qs=np.array([1e7, 1e7, 1e7]),
        r=np.array([0.0, 0.0]),
        dr=np.array([50.0, 50.0]),
        wq=5.0,
    )


def nl_gains() -> Gains:
    """Reference NL experiment gains (config_files/config_NL.py:5-10)."""
    return Gains(
        q=np.array([25.0, 0.0, 0.0, 200.0, 10.0, 0.0, 0.0, 0.0, 0.0]),
        qs=np.array([1e7, 1e7, 1e7]),
        r=np.array([15.0, 15.0]),
        dr=np.array([600.0, 200.0]),
        wq=5.0,
    )


class OCDConfig(NamedTuple):
    """Dual-coordination knobs (reference config_NL.py:29-33, NL/config.py:5-8).

    ``adaptive_alpha`` enables a sign-balancing per-(pair, stage) dual step
    (RPROP-style: grow the step while the constraint residual keeps one
    sign, shrink on oscillation). The reference uses the fixed ``alpha``
    (get_alpha, NL/config.py:5-8) — keep False for behavioural parity;
    True cuts coordination iteration counts when gains are soft or the
    horizon is long (see BENCH.md).
    """
    alpha: float = 0.25     # dual ascent step
    it_conv: int = 2        # consecutive converged iterations required
    max_it_ocd: int = 50    # iteration cap (divergence guard)
    min_it_ocd: int = 2     # forced minimum iterations
    atol: float = 0.01      # trajectory-change convergence tolerance
    adaptive_alpha: bool = False
    alpha_grow: float = 1.3     # step multiplier on persistent residual sign
    alpha_shrink: float = 0.5   # step multiplier on residual sign flip
    alpha_span: float = 8.0     # clamp: alpha/span <= step <= alpha*span
    # Dual projection floor. The coupling g = dth - dist is an inequality
    # residual, so the textbook dual ascent projects lambda onto [0, inf).
    # The reference omits the projection (lambdas += alpha*cost,
    # NL_EU_N_main.py:138-139; eval_constraintEU is unclipped,
    # NL/config.py:19-23), which lets lambda drift unboundedly NEGATIVE over
    # long runs while agents are separated; a large negative price is an
    # ATTRACTION between master and neighbour and was observed to jam and
    # then numerically diverge the mh-gains course at ~280 steps. 0.0 is the
    # correct projected update; set to -inf for raw reference semantics.
    lambda_lo: float = 0.0
    # Coordination sweep order. "jacobi": all agents solve simultaneously
    # against the previous iteration's plans (one vmapped batch — the
    # reference's standalone loop, NL_EU_N_main.py:110-120). "gauss_seidel":
    # agents solve in id order within an iteration, each against the
    # FRESHEST available neighbour plans — the deterministic counterpart of
    # the reference ROS mode's solve-as-soon-as-neighbours-updated
    # asynchrony (OCD_ROS_main.py:178-241); typically converges in fewer
    # OCD iterations at the cost of serialising agents within an iteration.
    sweep: str = "jacobi"


class SolverConfig(NamedTuple):
    """On-device QP/SQP engine knobs (no reference equivalent: replaces
    OSQP/IPOPT option dicts, LPV_Planner.py:233, NL_Planner_Eu.py:172-175).

    ``admm_iters=None`` resolves contextually (``admm_budget``): 300 on the
    batched/throughput paths, 1000 on the single-fleet N>=48 latency
    schedule (``runtime/simulate.py resolve_single_fleet_schedule``). An
    explicit integer is a pin that every path honours — including an
    explicit 300 on an N>=48 run (None-sentinel so pins are distinguishable
    from defaults)."""
    admm_iters: Optional[int] = None  # ADMM budget (early exit on residuals)
    rho: float = 10.0           # ADMM penalty (plain box rows)
    eps: float = 1e-4           # ADMM residual tolerance (OSQP eps_abs~1e-3)
    alpha_relax: float = 1.6    # ADMM over-relaxation
    # Riccati/epoch scheduling: refactorisation epoch length (None = the
    # N-dependent default in ops/admm.py admm_solve) and the
    # parallel-in-horizon associative-scan path, which this port does not
    # have yet (assoc=True raises NotImplementedError; None/False run the
    # sequential sweeps).
    epoch_len: Optional[int] = None
    assoc: Optional[bool] = None
    sqp_iters: int = 3          # SQP outer iterations (1 = RTI mode)
    line_search: float = 0.7    # SQP solution blending (C++ MPCC sqp_mixing)
    u_trust_delta: float = 0.06  # SQP trust region on steering
    u_trust_acc: float = 0.6     # SQP trust region on acceleration

    def admm_budget(self, default: int = 300) -> int:
        """The concrete ADMM iteration cap: the explicit pin when set, else
        the caller's contextual default."""
        return default if self.admm_iters is None else self.admm_iters


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Host-side experiment description (plain Python, fixed per run).

    Mirrors the reference settings dicts (config_files/config_*.py) plus
    solver configuration.
    """
    n_agents: int = 3
    N: int = 20                  # prediction horizon
    coupling: str = "eu"         # NL coupling: "eu" | "hp" | "hp_opt"
    dt: float = 0.02
    max_it: int = 1000           # outer control-step cap
    map_type: str = "Highway"
    lane: int = 0                # track lane (multi-lane tracks: Oval2, ...)
    # Per-step dynamic lane selection (reference set_lane/checkLane,
    # track_initialization.py:302,418-436): each agent re-localises its pose
    # against every lane each control step and the planner's curvature/
    # half-width/constraint tables follow the winning lane. Off: the static
    # `lane` above is used fleet-wide.
    dynamic_lane: bool = False
    # Solver-failure containment in the closed loop: a solve whose residual
    # exceeds the feasibility tolerance is not executed — the agent follows
    # its previous plan one more stage and retries (runtime/simulate.py;
    # the per-step analogue of the reference MPCC's solver-failure guess
    # reset, mpc.cpp:231-252, and the NL planners' IPOPT last-iterate
    # fallback, NL_Planner_Eu.py:200-217). Off = reference LPV semantics
    # (execute whatever came back, LPV_Planner.py:241-249).
    hold_on_infeasible: bool = True
    # Recovery escalation ladder on top of plan-holding (the fleet-path
    # analogue of the reference MPCC driver's n_no_solves -> guess-reset
    # ladder, mpc.cpp:231-252, runtime/racing.py n_reset): plan-holding
    # contains divergence but an agent whose every retry fails would hold
    # forever (the s=17.7 jam, BENCH.md round-3 study). After
    # ``hold_reset_k`` consecutive holds the agent's ADMM warm state
    # (w, y, rho_scale) is reset before the next solve (stale duals from
    # the pre-jam geometry stop poisoning it); after ``hold_cold_k``
    # consecutive holds the agent is cold re-initialised from the track
    # (fresh constant-acceleration warm-start trajectory from its current
    # state, utils/warmstart.py — the per-agent generateNewInitialGuess).
    # None disables a rung. Only active when hold_on_infeasible is set.
    hold_reset_k: Optional[int] = 3
    hold_cold_k: Optional[int] = 6
    # Degraded-execution escape (the ladder's last rung): after
    # ``hold_exec_k`` CONSECUTIVE infeasible solves (tracked by
    # ``jam_count``, which the ladder never resets — hold_count cycles
    # 0..hold_cold_k because the cold rung zeroes it, so no deeper
    # hold-based threshold can ever fire), the unconverged plan is
    # EXECUTED anyway. This is the reference's own degraded-solve
    # semantics (OSQP max_iter_reached is accepted and executed,
    # LPV_Planner.py:241-249) — but made safe by the round-5 hard
    # bounds: the separation floor and the lateral wall clamp whatever
    # the degraded plan tries to do, which is exactly what they exist
    # for. Without this rung a jammed agent whose QP never re-enters
    # tolerance holds forever (round-5 canonical-course study: 285
    # consecutive holds at the iteration cap, BENCH.md). Mode is
    # sticky by construction: jam_count keeps climbing while solves
    # stay infeasible, so execution continues until one converges.
    # None disables (round-4 strict-hold semantics).
    hold_exec_k: Optional[int] = 12
    # Stale-broadcast separation boost (LPV fleet paths): each agent
    # multiplies its distance-based separation reward weight by
    # (1 + hold_sep_boost) toward any neighbour whose hold_count is
    # nonzero (a holding agent's broadcast plan is stale). Directionally
    # verified at the solve level (test_hold_sep_boost_pushes_away...),
    # exact no-op while no agent holds. Default OFF: the round-4
    # perturbed-start study's sub-0.1 m near-passes proved to occur in
    # the initial congestion scramble BEFORE any holding (identical
    # minima with/without the boost; a zero-hold start also dips to
    # 0.176 m), so the boost does not address the one observed
    # separation failure mode and slightly increases hold counts in deep
    # congestion (BENCH.md round-4 campaign).
    hold_sep_boost: float = 0.0
    # Executed-separation safety filter (hard floor). The QP's soft plane
    # rows are the only separation defence both here and in the reference
    # (LPV_Planner.py:263-276 slacked planes; the reference's own golden
    # recordings violate dth down to 0.161 m, PARITY.md) — and they
    # saturate under pathological packing (round-4 stressed starts dipped
    # to 0.042 m executed separation, BENCH.md). The filter projects the
    # APPLIED x0-shift: each agent advances a fraction beta in [0, 1]
    # along its plan's first stage (braking along the plan,
    # runtime/simulate.py separation_filter) chosen so no pair's executed
    # distance falls below ``exec_sep_frac * min_dist`` — unless the pair
    # already stood below the floor, in which case it never gets closer
    # than standing still (monotone non-worsening; a fleet that starts
    # above the floor can never be driven below it). Exact no-op
    # (bit-identical states) on any step where no pair would cross the
    # floor. None disables. Applied on every closed-loop fleet path
    # (LPV + NL-OCD, single-device + sharded).
    exec_sep_frac: Optional[float] = 0.7
    # Track-limits wall on the executed stage: the applied x0-shift may
    # not take |ey| beyond ``exec_ey_wall * halfwidth`` — or beyond its
    # CURRENT |ey| if already outside (monotone non-worsening, like the
    # separation filter; the clamped XY is recomputed from the Frenet
    # pose, which is the source of truth). Round-5 measured motive
    # (BENCH.md): in the Highway k=0.35 curve the Frenet chart is only
    # valid for |ey| < 1/k ~ 2.9 m, and a holding agent executing a
    # degraded plan tail burst from ey ~0.9 to -7.4 m THROUGH the chart
    # singularity, after which every recovery plan kept the garbage
    # offset and the agent drove beside the track for the rest of the
    # course. 2.0 x halfwidth is generous (well outside the soft lane
    # rows, well inside chart validity). Exact no-op while every agent
    # executes inside the wall. None disables.
    exec_ey_wall: Optional[float] = 2.0
    # Hold-recovery feasibility pass ("congestion-window convergence",
    # ROADMAP): plan-holding + the escalation ladder reset solver STATE
    # but never made the retry's QP easier, so a deeply jammed agent
    # could hold for hundreds of steps while parked on track (348/550
    # held steps, BENCH.md round-4 LPV perturbed study). With this knob,
    # an agent's tracked speed steps down with its consecutive
    # hold-or-brake count c = max(hold_count, brake_count): vx_ref is
    # FULL below the hold_reset_k rung and hold_vx_frac of it at the
    # rung and beyond — transient holds retry at full speed, only a
    # persistent jam slows down. Decaying deeper than one notch
    # measured WORSE on the stressed starts (crawling prolongs
    # congestion exposure; BENCH.md round 5).
    # A lower tracked speed relaxes the competition
    # between progress and the separation/lane rows, letting the retry
    # converge and the hold streak break (measured, BENCH.md round 5).
    # brake_count makes sustained separation-filter braking drive the
    # same ramp: braked solves are FEASIBLE, so hold_count never sees
    # them, and without the ramp a braked cluster replans the same
    # closing step forever (the round-5 parking fixed point).
    # Pre-escalation counts are used, so a freshly cold-re-initialised
    # agent still retries at the reduced target. None disables (retry
    # at full vx_ref, the round-4 behaviour).
    hold_vx_frac: Optional[float] = 0.6
    model: ModelParams = ModelParams()
    limits: SysLimits = SysLimits()
    gains: Optional[Gains] = None
    ocd: OCDConfig = OCDConfig()
    solver: SolverConfig = SolverConfig()
    save_data: bool = False
    plot: int = 0
    verb: int = 0
    # per-OCD-iteration observability (reference settings verb_OCD): the
    # coordination loop runs host-driven with one device dispatch per
    # iteration, yielding true per-iteration wall times (time_OCD.dat rows)
    # and verbose convergence prints — slower, diagnostics only
    verb_ocd: bool = False
    path: str = "data/experiment"
    laps: int = 1
    dtype: str = "float32"


# Canonical initial states for up to 4 agents
# (reference plan_lib/config/__init__.py:3-8). Layout:
# [vx, vy, wz, ey, epsi, theta, s, x, y]
X0_DATABASE: Tuple[Tuple[float, ...], ...] = (
    (1.3, -0.16, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0),
    (1.3, -0.16, 0.0, -0.25, 0.0, 0.0, 0.0, 0.0, 1.0),
    (1.3, -0.16, 0.0, 0.45, 0.0, 0.0, 0.0, 0.0, 1.45),
    (1.3, -0.16, 0.0, 0.25, 0.0, 0.0, 0.25, 0.0, 1.5),
)


def x0_database(n_agents: int) -> np.ndarray:
    """Initial states for n agents. The first 4 are the reference's
    canonical rows; beyond that, agents are staggered along the track
    (platoon formation: alternating lateral offsets, 0.5 m longitudinal
    spacing) so arbitrarily large fleets start collision-free."""
    base = np.asarray(X0_DATABASE, dtype=np.float64)
    if n_agents <= len(base):
        return base[:n_agents]
    rows = [base[i % len(base)].copy() for i in range(n_agents)]
    eys = [0.0, -0.25, 0.45, 0.25]
    for i in range(len(base), n_agents):
        rows[i][3] = eys[i % 4]
        rows[i][6] = 0.5 * (i // 4 + 1) + base[i % 4][6]
    return np.asarray(rows)
