"""MPCC-style racing planner: progress maximisation + Pacejka physics
(PyTorch port).

Twin of ``colaborativempc_tpu/planners/mpcc.py`` (the reference's native
contouring controller, ``Matlab-tests/MPCC-master/C++``), batched over B
races: every tensor carries a leading axis B, where the JAX functions are
per race and vmapped. In the Frenet formulation the contouring error is ey
and progress is s, so the cost is a linear reward on s plus quadratic
penalties; the friction-ellipse and slip-angle constraints are linearised
per SQP iteration and enter as soft rows; the SQP loop with solution
mixing mirrors ``mpc.cpp:219-259``. Each QP goes through ``ops/admm.py
admm_solve`` — on the card, the CUDA epoch kernel.

Gains may differ per race (a gain battery): each ``MPCCGains`` field is a
float or a ``(B,)`` tensor.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from colaborativempc_tpu_torch.dynamics.bicycle import NX
from colaborativempc_tpu_torch.dynamics.pacejka import (
    PacejkaParams, linearize_pacejka, tire_row_jacobians,
)
from colaborativempc_tpu_torch.geometry import Track, curvature, halfwidth
from colaborativempc_tpu_torch.ops import (
    LQRCost, StageQP, admm_solve, cuda_sqp, scale_stage_qp,
)
from colaborativempc_tpu_torch.planners.lpv import NC, NZ, _augment_dynamics
from colaborativempc_tpu_torch.utils.tracing import span

INF = float("inf")
M_ROWS = 7   # corridor, two input boxes, friction ellipse, two slip, vx_min


class MPCCGains(NamedTuple):
    """Racing cost weights (MPCC-master Params/cost.json analogues)."""
    q_progress: float = 1.0    # linear reward on s advance
    q_contour: float = 50.0    # ey^2
    q_heading: float = 5.0     # epsi^2
    q_vy: float = 0.1
    q_wz: float = 0.1
    r_delta: float = 0.1       # u^2
    r_drive: float = 0.1
    dr_delta: float = 5.0      # du^2
    dr_drive: float = 5.0
    w_soft: float = 1e4        # soft-constraint weight (track/tire rows)


class MPCCBounds(NamedTuple):
    """Input box + SQP trust region (MPCC-master Params/bounds.json deltal/
    deltau/Dl/Du rows; s_trust_region from model.json via mpc.cpp:85-87)."""
    delta_max: float = 0.35    # |steer| bound [rad] (bounds.json deltau)
    drive_min: float = -0.1    # reverse-drive floor (bounds.json Dl)
    drive_max: float = 1.0     # duty ceiling (bounds.json Du)
    trust_delta: float = 0.08  # per-SQP-iteration trust region on steer
    trust_drive: float = 0.3   # ... on duty
    vx_min: float = 0.05       # keep-moving floor (bounds.json vxl)


class MPCCNormalization(NamedTuple):
    """Per-variable scales of the solver's change of variables
    (``Params/params.h:31-58`` NormalizationParam T_x/T_u, applied per SQP
    iteration at ``mpc.cpp:91-132``) on the state [vx, vy, wz, ey, epsi,
    theta, s, X, Y], the input [delta, D] and the stage control du (input
    increments per step: the reference's rate scales times dt). Float32
    tensors, as in the JAX package, on the CPU; ``mpcc_solve`` moves them."""
    t_x: torch.Tensor   # (9,)
    t_u: torch.Tensor   # (2,)
    t_du: torch.Tensor  # (2,)

    @classmethod
    def default(cls, dt: float = 0.02) -> "MPCCNormalization":
        """Reference normalization.json values mapped onto this layout:
        vx:3, vy:1, r(wz):5, s:20, X/Y:2, phi(theta):1; ey/epsi get
        corridor-scale defaults; delta:0.35, D:1; dDelta/dD:15 (rates) x dt."""
        f32 = torch.float32
        return cls(
            t_x=torch.tensor([3.0, 1.0, 5.0, 0.25, 0.5, 1.0, 20.0, 2.0, 2.0],
                             dtype=f32),
            t_u=torch.tensor([0.35, 1.0], dtype=f32),
            t_du=torch.tensor([15.0 * dt, 15.0 * dt], dtype=f32))

    @classmethod
    def from_reference(cls, path: str, dt: float) -> "MPCCNormalization":
        """Load a reference ``normalization.json`` (keys X, Y, phi, vx, vy,
        r, s, D, delta, dD, dDelta; ``params.cpp`` NormalizationParam)."""
        with open(path) as f:
            d = json.load(f)
        t_x = cls.default(dt).t_x.double().numpy().copy()
        for idx, key in ((0, "vx"), (1, "vy"), (2, "r"), (5, "phi"),
                         (6, "s"), (7, "X"), (8, "Y")):
            if key in d:
                t_x[idx] = float(d[key])
        t_u = np.asarray([d.get("delta", 0.35), d.get("D", 1.0)])
        t_du = np.asarray([d.get("dDelta", 15.0), d.get("dD", 15.0)]) * dt
        f32 = torch.float32
        return cls(t_x=torch.tensor(t_x, dtype=f32),
                   t_u=torch.tensor(t_u, dtype=f32),
                   t_du=torch.tensor(t_du, dtype=f32))

    @property
    def t_z(self) -> torch.Tensor:
        """Augmented-state scale for z = [x; u_prev]."""
        return torch.cat([self.t_x, self.t_u])


class MPCCSolution(NamedTuple):
    x_pred: torch.Tensor      # (B, N+1, 9)
    u_pred: torch.Tensor      # (B, N, 2)
    feasible: torch.Tensor    # (B,) last SQP iteration's QP within tolerance
    r_prim: torch.Tensor      # (B,)
    iterations: torch.Tensor  # (B,) ADMM iterations over the SQP iterations
    sqp_fails: torch.Tensor   # (B,) SQP iterations whose QP solve failed
    w: torch.Tensor           # (B, N, 7) ADMM splitting state (constraint
    y: torch.Tensor           #  space: invariant under normalisation)
    rho_scale: torch.Tensor   # (B, 7)


def _col(v, dtype, device) -> torch.Tensor:
    """A gain as a ``(B or 1, 1)`` column (float or per-race tensor)."""
    return torch.as_tensor(v, dtype=dtype, device=device).reshape(-1, 1)


def build_mpcc_qp(track: Track, gains: MPCCGains, p: PacejkaParams,
                  N: int, dt, x_bar: torch.Tensor, u_bar: torch.Tensor,
                  bounds: MPCCBounds = MPCCBounds()) -> StageQP:
    """The racing stage QPs of B races around ``x_bar (B, N+1, 9)``,
    ``u_bar (B, N, 2)``, as :func:`build_mpcc_qp_plain` forms them.

    On CPU tensors: :func:`build_mpcc_qp_plain`. On CUDA tensors: one
    launch of ``ops/cuda_sqp.py mpcc_qp_batched`` (the inputs made
    contiguous first), which raises on a tensor it cannot take; there is
    no fallback to the plain version, and neither the linearisation nor
    ``torch.func`` runs."""
    if x_bar.device.type == "cpu":
        return build_mpcc_qp_plain(track, gains, p, N, dt, x_bar, u_bar,
                                   bounds)
    return cuda_sqp.mpcc_qp_batched(track, gains, p, N, dt,
                                    x_bar.contiguous(), u_bar.contiguous(),
                                    bounds)


def build_mpcc_qp_plain(track: Track, gains: MPCCGains, p: PacejkaParams,
                        N: int, dt, x_bar: torch.Tensor, u_bar: torch.Tensor,
                        bounds: MPCCBounds = MPCCBounds()) -> StageQP:
    """Plain version of :func:`build_mpcc_qp` on any device: assemble the
    racing stage QPs of B races around ``x_bar (B, N+1, 9)``, ``u_bar (B,
    N, 2)``: 7 rows per stage — the track corridor on
    ey_{k+1} (soft), the steer and duty boxes tightened by the SQP trust
    region, the friction ellipse and the two slip-angle rows linearised at
    (x_bar_k, u_bar_k) (soft), and vx_{k+1} >= vx_min (soft); soft weights
    ``gains.w_soft``."""
    dtype, dev = x_bar.dtype, x_bar.device
    B = x_bar.shape[0]
    g = {k: _col(v, dtype, dev) for k, v in gains._asdict().items()}
    kappas = curvature(track, x_bar[:, :N, 6])
    Ad, Bd, rd = linearize_pacejka(x_bar[:, :N], u_bar, kappas, p, dt)
    dyn = _augment_dynamics(Ad, Bd)
    d = dyn.d.clone()
    d[..., :NX] = rd
    dyn = dyn._replace(d=d)

    # ---- cost ------------------------------------------------------------
    zero = torch.zeros_like(g["q_vy"])
    qdiag = torch.cat([zero, 2.0 * g["q_vy"], 2.0 * g["q_wz"],
                       2.0 * g["q_contour"], 2.0 * g["q_heading"],
                       zero, zero, zero, zero,
                       2.0 * g["r_delta"], 2.0 * g["r_drive"]], dim=-1)
    Q = x_bar.new_zeros((B, N + 1, NZ, NZ))
    Q[:, 1:] = torch.diag_embed(qdiag)[:, None]
    q = x_bar.new_zeros((B, N + 1, NZ))
    q[:, 1:, 6] = -2.0 * g["q_progress"]               # maximise progress
    R = torch.diag_embed(torch.cat([2.0 * g["dr_delta"], 2.0 * g["dr_drive"]],
                                   dim=-1))[:, None].expand(B, N, NC, NC)
    cost = LQRCost(Q=Q, q=q, R=R.contiguous(), r=x_bar.new_zeros((B, N, NC)),
                   S=x_bar.new_zeros((B, N, NZ, NC)))

    # ---- constraints -----------------------------------------------------
    m = M_ROWS
    D = x_bar.new_zeros((B, N, m, NZ))
    E = x_bar.new_zeros((B, N, m, NC))
    lo = torch.full((B, N, m), -INF, dtype=dtype, device=dev)
    hi = torch.full((B, N, m), INF, dtype=dtype, device=dev)
    soft_lo = torch.full((B, N, m), INF, dtype=dtype, device=dev)
    soft_hi = torch.full((B, N, m), INF, dtype=dtype, device=dev)
    w_soft = g["w_soft"]
    F_, G_, d_ = dyn.F, dyn.G, dyn.d  # rows through the dynamics see
    #                                  x_{k+1} - d_k

    # track corridor on ey_{k+1}, soft both sides (constraints.cpp:30)
    ey_ub = halfwidth(track, x_bar[:, :N, 6], sm=0.95).to(dtype)
    D[:, :, 0] = F_[:, :, 3]
    E[:, :, 0] = G_[:, :, 3]
    lo[:, :, 0] = -ey_ub - d_[:, :, 3]
    hi[:, :, 0] = ey_ub - d_[:, :, 3]
    soft_lo[:, :, 0] = w_soft
    soft_hi[:, :, 0] = w_soft

    # input boxes with the SQP trust region
    D[:, :, 1, NX + 0] = 1.0
    E[:, :, 1, 0] = 1.0
    lo[:, :, 1] = torch.clamp_min(u_bar[..., 0] - bounds.trust_delta,
                                  -bounds.delta_max)
    hi[:, :, 1] = torch.clamp_max(u_bar[..., 0] + bounds.trust_delta,
                                  bounds.delta_max)
    D[:, :, 2, NX + 1] = 1.0
    E[:, :, 2, 1] = 1.0
    lo[:, :, 2] = torch.clamp_min(u_bar[..., 1] - bounds.trust_drive,
                                  bounds.drive_min)
    hi[:, :, 2] = torch.clamp_max(u_bar[..., 1] + bounds.trust_drive,
                                  bounds.drive_max)

    # tire rows, linearised at (x_bar_k, u_bar_k):
    # g.x + gu.u <= g.x_bar + gu.u_bar - value
    vals, gx, gu = tire_row_jacobians(x_bar[:, :N], u_bar, p)
    bound = (-vals + (gx @ x_bar[:, :N, :, None])[..., 0]
             + (gu @ u_bar[..., None])[..., 0])
    D[:, :, 3:6, :NX] = gx
    D[:, :, 3:6, NX:] = gu
    E[:, :, 3:6] = gu
    hi[:, :, 3:6] = bound
    soft_hi[:, :, 3:6] = w_soft[..., None]

    # vx >= vx_min (keep the car moving forward), soft
    D[:, :, 6] = F_[:, :, 0]
    E[:, :, 6] = G_[:, :, 0]
    lo[:, :, 6] = bounds.vx_min - d_[:, :, 0]
    soft_lo[:, :, 6] = w_soft

    return StageQP(dyn=dyn, cost=cost, D=D, E=E, lo=lo, hi=hi,
                   soft_lo=soft_lo, soft_hi=soft_hi)


def mpcc_solve(track: Track, gains: MPCCGains, p: PacejkaParams,
               N: int, dt, x0: torch.Tensor, x_bar: torch.Tensor,
               u_bar: torch.Tensor, u_old: torch.Tensor,
               sqp_iters: int = 3, sqp_mix: float = 0.7,
               admm_iters: int = 200, rho: float = 10.0,
               bounds: MPCCBounds = MPCCBounds(),
               norm: Optional[MPCCNormalization] = None,
               w0: Optional[torch.Tensor] = None,
               y0: Optional[torch.Tensor] = None,
               rho_scale0=1.0,
               epoch_len: Optional[int] = None,
               assoc: bool = False) -> MPCCSolution:
    """SQP racing solves of B races (the reference's runMPC loop,
    mpc.cpp:219-259): ``x0 (B, 9)``, ``x_bar (B, N+1, 9)``,
    ``u_bar (B, N, 2)``, ``u_old (B, 2)``.

    ``norm`` solves each QP in scaled variables (``mpc.cpp:91-132``) and
    de-normalises the solution. A race's QP outcome is rejected when it is
    non-finite — its splitting state is kept and its mixing weight is 0;
    the blend is arithmetic as in JAX, so a non-finite QP solution still
    reaches the blended guess (``0 * nan``). ``sqp_fails`` counts the
    rejected solves and the accepted-but-infeasible ones, as the reference
    counts every solver status but 0 (``mpc.cpp:239-244``).
    """
    with span("cmpc.mpcc.solve"):
        dtype, dev = x_bar.dtype, x_bar.device
        B = x_bar.shape[0]
        m = M_ROWS
        z0 = torch.cat([x0, u_old], dim=-1).to(dtype)
        if norm is not None:
            tz = norm.t_z.to(device=dev, dtype=dtype)
            tc = norm.t_du.to(device=dev, dtype=dtype)
            z0_s = z0 / tz
        w = x_bar.new_zeros((B, N, m)) if w0 is None else w0
        y = x_bar.new_zeros((B, N, m)) if y0 is None else y0
        rs = torch.broadcast_to(
            torch.as_tensor(rho_scale0, dtype=dtype, device=dev), (B, m))
        x_lin, u_lin = x_bar, u_bar
        iterations = torch.zeros((B,), dtype=torch.int64, device=dev)
        fails = torch.zeros((B,), dtype=torch.int32, device=dev)
        for _ in range(sqp_iters):
            with span("cmpc.mpcc.sqp_iter"):
                with span("cmpc.mpcc.build"):
                    qp = build_mpcc_qp(track, gains, p, N, dt, x_lin, u_lin,
                                       bounds)
                kw = dict(w0=w, y0=y, rho_scale0=rs, iters=admm_iters,
                          rho=rho, epoch_len=epoch_len, assoc=assoc)
                if norm is not None:
                    sol = admm_solve(scale_stage_qp(qp, tz, tc), z0_s, **kw)
                    z_sol = sol.z * tz
                else:
                    sol = admm_solve(qp, z0, **kw)
                    z_sol = sol.z
                x_new = z_sol[..., :NX]
                u_new = z_sol[:, 1:, NX:]
                ok = (torch.isfinite(x_new).flatten(1).all(1)
                      & torch.isfinite(u_new).flatten(1).all(1))
                mix = torch.where(
                    ok, torch.full_like(ok, sqp_mix, dtype=dtype),
                    torch.zeros_like(ok, dtype=dtype))[:, None, None]
                x_lin = mix * x_new + (1.0 - mix) * x_lin
                u_lin = mix * u_new + (1.0 - mix) * u_lin
                w = torch.where(ok[:, None, None], sol.w, w)
                y = torch.where(ok[:, None, None], sol.y, y)
                rs = torch.where(ok[:, None], sol.rho_scale, rs)
                fails = fails + ((~ok) | (~sol.feasible)).to(fails.dtype)
                iterations = iterations + sol.iterations
        return MPCCSolution(x_pred=x_lin, u_pred=u_lin, feasible=sol.feasible,
                            r_prim=sol.r_prim, iterations=iterations,
                            sqp_fails=fails, w=w, y=y, rho_scale=rs)


# ---------------------------------------------------------------------------
# Config surface (the reference's JSON-driven Params/ layout, main.cpp:33-41)
# ---------------------------------------------------------------------------

def pacejka_from_reference(path: str) -> PacejkaParams:
    """Load a reference ``model.json`` into :class:`PacejkaParams`
    (``Params/params.cpp`` Param(file); key renames: Iz -> I,
    E_long -> p_long, E_eps -> p_ell, maxAlpha -> max_alpha)."""
    with open(path) as f:
        d = json.load(f)
    base = PacejkaParams()._asdict()
    renames = {"Iz": "I", "E_long": "p_long", "E_eps": "p_ell",
               "maxAlpha": "max_alpha"}
    for k, v in d.items():
        k = renames.get(k, k)
        if k in base:
            base[k] = float(v)
    return PacejkaParams(**base)


def mpcc_gains_from_reference(path: str, dt: float) -> MPCCGains:
    """Map a reference ``cost.json`` onto :class:`MPCCGains` (a structural
    mapping: qC -> q_contour, qMu -> q_heading, qVs -> q_progress, the
    per-second input-rate weights rdDelta/rdD divided by dt^2, the soft
    weight from the stiffest sc_quad_* row times 100)."""
    with open(path) as f:
        d = json.load(f)
    g = MPCCGains()
    return MPCCGains(
        q_progress=float(d.get("qVs", g.q_progress)),
        q_contour=float(d.get("qC", g.q_contour)),
        q_heading=float(d.get("qMu", g.q_heading)),
        q_vy=float(d.get("qBeta", g.q_vy)),
        q_wz=float(d.get("qR", g.q_wz)),
        r_delta=float(d.get("rDelta", g.r_delta)),
        r_drive=float(d.get("rD", g.r_drive)),
        dr_delta=float(d.get("rdDelta", g.dr_delta * dt * dt)) / (dt * dt),
        dr_drive=float(d.get("rdD", g.dr_drive * dt * dt)) / (dt * dt),
        w_soft=max(float(d.get("sc_quad_track", 100.0)),
                   float(d.get("sc_quad_tire", 1.0)),
                   float(d.get("sc_quad_alpha", 10.0))) * 1e2)


def mpcc_bounds_from_reference(path: str, trust_delta: float = 0.08,
                               trust_drive: float = 0.3) -> MPCCBounds:
    """Load a reference ``bounds.json`` (deltau/Dl/Du/vxl rows) into
    :class:`MPCCBounds`; the SQP trust regions keep their defaults."""
    with open(path) as f:
        d = json.load(f)
    b = MPCCBounds()
    return MPCCBounds(
        delta_max=float(d.get("deltau", b.delta_max)),
        drive_min=float(d.get("Dl", b.drive_min)),
        drive_max=float(d.get("Du", b.drive_max)),
        trust_delta=trust_delta, trust_drive=trust_drive,
        vx_min=float(d.get("vxl", b.vx_min)))


@dataclasses.dataclass(frozen=True)
class MPCCConfig:
    """Racing-experiment description (the reference's ``Params/config.json``
    master file, ``main.cpp:33-41``), field for field the JAX package's."""
    N: int = 20                  # horizon (reference config.h N=60)
    dt: float = 0.05             # control period Ts
    n_sim: int = 400             # closed-loop steps (config.json n_sim)
    n_sqp: int = 3               # SQP iterations per step (n_sqp)
    n_reset: int = 5             # consecutive failed steps before guess reset
    sqp_mixing: float = 0.7      # solution blending (sqp_mixing)
    map_type: str = "oval_mt"    # named track (ignored when track_json set)
    track_json: Optional[str] = None   # reference-format track JSON to fit
    laps: int = 0                # terminate after laps (0 = run n_sim steps)
    initial_velocity: float = 0.5      # cold-start guess speed (v0)
    plant_substeps: int = 4      # RK4 sub-steps per control period
    normalize: bool = True       # solve in normalised variables (T_x/T_u)
    # reference normalization.json with the T_x/T_u scales; None =
    # MPCCNormalization.default(dt)
    normalization_path: Optional[str] = None
    admm_iters: int = 200
    rho: float = 10.0
    # Riccati scheduling (ops/admm.py admm_solve; None = the N-dependent
    # defaults). assoc=None resolves to True at N >= 48 with epoch_len 15,
    # the single-fleet latency schedule of the collaborative planners. On
    # the card every epoch is the kernel whatever assoc says; epoch_len
    # applies on both devices.
    epoch_len: Optional[int] = None
    assoc: Optional[bool] = None

    def resolved_assoc(self) -> bool:
        return self.N >= 48 if self.assoc is None else self.assoc

    def resolved_epoch_len(self) -> Optional[int]:
        if self.epoch_len is not None:
            return self.epoch_len
        return 15 if self.resolved_assoc() and self.N >= 48 else None
    gains: MPCCGains = MPCCGains()
    bounds: MPCCBounds = MPCCBounds()
    model: PacejkaParams = PacejkaParams()
    save_data: bool = False
    path: str = "data/mpcc"
    verb: int = 0

    def normalization(self) -> Optional[MPCCNormalization]:
        if not self.normalize:
            return None
        if self.normalization_path is not None:
            return MPCCNormalization.from_reference(self.normalization_path,
                                                    self.dt)
        return MPCCNormalization.default(self.dt)


def _resolve(base_dir: str, rel: str) -> str:
    """Resolve a reference config's sub-path (given relative to the C++
    working dir, e.g. "Params/model.json") against the master file's dir."""
    for cand in (os.path.join(base_dir, rel),
                 os.path.join(base_dir, os.path.basename(rel)),
                 os.path.join(os.path.dirname(base_dir.rstrip(os.sep)), rel),
                 rel):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"cannot resolve {rel!r} against {base_dir!r}")


def mpcc_config_from_json(path: str, **overrides) -> MPCCConfig:
    """Build an :class:`MPCCConfig` from JSON, in either layout: the
    reference master file (n_sqp/n_reset/sqp_mixing/n_sim/Ts/v0 and
    model/cost/bounds/track/normalization paths, ``main.cpp:33-41``), whose
    sub-files go through the ``*_from_reference`` mappers, or a flat dict
    of MPCCConfig fields with nested gains/bounds/model dicts (written by
    :func:`mpcc_config_to_json`)."""
    with open(path) as f:
        raw = json.load(f)
    base_dir = os.path.dirname(os.path.abspath(path))
    if "model_path" in raw:                    # reference master layout
        dt = float(raw.get("Ts", 0.02))
        kw = dict(
            dt=dt,
            n_sqp=int(raw.get("n_sqp", 2)),
            n_reset=int(raw.get("n_reset", 5)),
            sqp_mixing=float(raw.get("sqp_mixing", 0.8)),
            n_sim=int(raw.get("n_sim", 400)),
            initial_velocity=float(raw.get("v0", 0.5)),
            model=pacejka_from_reference(
                _resolve(base_dir, raw["model_path"])),
            track_json=_resolve(base_dir, raw["track_path"]),
        )
        if "cost_path" in raw:
            kw["gains"] = mpcc_gains_from_reference(
                _resolve(base_dir, raw["cost_path"]), dt)
        if "bounds_path" in raw:
            kw["bounds"] = mpcc_bounds_from_reference(
                _resolve(base_dir, raw["bounds_path"]))
        if "normalization_path" in raw:
            kw["normalization_path"] = _resolve(
                base_dir, raw["normalization_path"])
        kw.update(overrides)
        return MPCCConfig(**kw)
    kw = {}
    nested = {"gains": MPCCGains, "bounds": MPCCBounds,
              "model": PacejkaParams}
    for f_ in dataclasses.fields(MPCCConfig):
        if f_.name in raw:
            v = raw[f_.name]
            kw[f_.name] = nested[f_.name](**v) if f_.name in nested else v
    kw.update(overrides)
    return MPCCConfig(**kw)


def mpcc_config_to_json(cfg: MPCCConfig, path: str) -> None:
    """Serialise an :class:`MPCCConfig` to the flat native JSON layout."""
    d = dataclasses.asdict(cfg)
    for k in ("gains", "bounds", "model"):
        d[k] = {kk: float(vv) for kk, vv in getattr(cfg, k)._asdict().items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(d, f, indent=2)
