"""LPV collaborative MPC planner (PyTorch port).

Twin of ``colaborativempc_tpu/planners/lpv.py`` (reference ``PlannerLPV``,
``distributedPlanner/LPV_Planner.py``), batched over P problems (P = B
scenarios x n_agents in the fleet step). The stage QP keeps the JAX
structure: an 11-dim augmented state z = [x (9); u_prev (2)], a 2-dim stage
control c = du, and ``m = 4 + n_nb`` rows per stage (velocity, lateral band,
two input boxes, one separating plane per neighbour), the slacked rows soft
with weights capped at ``SOFT_WEIGHT_CAP``.

Limits are a ``SysLimits`` whose fields are Python floats or per-problem
tensors of shape (P,) — the fleet step passes float32 tensors, as the JAX
fleet step does (``runtime/simulate.py _per_agent_limits``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from colaborativempc_tpu_torch.config.params import Gains, ModelParams, SysLimits
from colaborativempc_tpu_torch.dynamics.bicycle import NX, NU, lpv_discrete_horizon
from colaborativempc_tpu_torch.geometry import (
    Track, curvature, halfwidth, compute_hyperplanes, separation_weights,
)
from colaborativempc_tpu_torch.ops import (
    LQRCost, LQRDynamics, StageQP, admm_solve, ADMMSolution,
)
from colaborativempc_tpu_torch.utils.tracing import span

NZ = NX + NU          # augmented state dim
NC = NU               # stage control = du
INF = float("inf")

#: Cap on effective soft-constraint weights (JAX planners/lpv.py): the
#: reference's Qs = 1e7 costs hundreds of float32 dual iterations for no
#: behavioural gain; 1e4 keeps violations below solver tolerance.
SOFT_WEIGHT_CAP = 1e4


class LPVSolution(NamedTuple):
    x_pred: torch.Tensor    # (P, N+1, 9)
    u_pred: torch.Tensor    # (P, N, 2)
    du_pred: torch.Tensor   # (P, N, 2)
    s_pred: torch.Tensor    # (P, N, 3) realised violations (vel, ey, planes)
    planes: torch.Tensor    # (P, N, n_nb, 3)
    feasible: torch.Tensor  # (P,) bool
    w: torch.Tensor         # ADMM splitting state (warm start for next step)
    y: torch.Tensor
    rho_scale: torch.Tensor  # adaptive-rho state (warm start for next step)
    iterations: torch.Tensor
    r_prim: torch.Tensor


def _lim(v, dtype, device) -> torch.Tensor:
    """A limit as a ``(P or 1, 1)`` tensor. A tensor keeps its own precision
    (promoted with ``dtype``), so a float32 limit enters a float64 QP with
    its float32 value, as in JAX; a Python float takes ``dtype``."""
    if isinstance(v, torch.Tensor):
        t = v.to(device=device, dtype=torch.promote_types(v.dtype, dtype))
    else:
        t = torch.full((), v, dtype=dtype, device=device)
    return t.reshape(-1, 1)


def _gain(g, k: int, dtype, device) -> torch.Tensor:
    """A gain vector of length ``k`` as a ``(1, k)`` row, or per-problem
    gains ``(P, k)`` as they are (a gain battery varies them per problem)."""
    if not isinstance(g, torch.Tensor):
        g = torch.tensor(np.asarray(g, np.float64))
    return g.to(device=device, dtype=dtype).reshape(-1, k)


def _wq(wq, dtype, device):
    """The separation-reward weight: a Python float, or per-problem
    weights as a ``(P, 1)`` column."""
    if isinstance(wq, (torch.Tensor, np.ndarray)) and np.ndim(wq) > 0:
        return torch.as_tensor(wq).to(device=device, dtype=dtype).reshape(-1, 1)
    return float(wq)


def _augment_dynamics(Ad: torch.Tensor, Bd: torch.Tensor) -> LQRDynamics:
    """Lift (A, B) to the [x; u_prev] system with control du."""
    batch = Ad.shape[:-2]
    eye = torch.eye(NU, dtype=Ad.dtype, device=Ad.device)
    F = Ad.new_zeros(batch + (NZ, NZ))
    F[..., :NX, :NX] = Ad
    F[..., :NX, NX:] = Bd
    F[..., NX:, NX:] = eye
    G = Ad.new_zeros(batch + (NZ, NC))
    G[..., :NX, :] = Bd
    G[..., NX:, :] = eye
    d = Ad.new_zeros(batch + (NZ,))
    return LQRDynamics(F=F, G=G, d=d)


def build_lpv_qp(track: Track, gains: Gains, limits: SysLimits,
                 model: ModelParams, N: int, dt,
                 x_lin: torch.Tensor, u_lin: torch.Tensor,
                 planes: torch.Tensor, weights: torch.Tensor,
                 lane=0) -> StageQP:
    """Assemble P stage QPs around linearisation trajectories
    ``x_lin (P, N+1, 9)``, ``u_lin (P, N, 2)``.

    planes: ``(P, N, n_nb, 3)`` separating planes; weights: ``(P, N, n_nb)``
    separation reward weights (zeros for a single agent). ``lane``: int or
    a ``(P,)`` tensor. ``gains``: each vector shared by all problems or
    with a leading per-problem axis P (a gain battery); ``wq`` a float or
    ``(P,)``.
    """
    dtype, dev = x_lin.dtype, x_lin.device
    P = x_lin.shape[0]
    lim = {k: _lim(getattr(limits, k), dtype, dev) for k in limits._fields}
    gq = _gain(gains.q, NX, dtype, dev)
    gr = _gain(gains.r, NU, dtype, dev)
    gdr = _gain(gains.dr, NC, dtype, dev)
    gqs = torch.clamp_max(_gain(gains.qs, 3, dtype, dev), SOFT_WEIGHT_CAP)

    kappas = curvature(track, x_lin[:, :N, 6], lane)
    Ad, Bd = lpv_discrete_horizon(x_lin[:, :N], u_lin, kappas, dt, model)
    dyn = _augment_dynamics(Ad, Bd)

    # ---- cost: Q on x, R on u_prev for states 1..N (incl. terminal) -------
    Qz_diag = torch.cat([2.0 * gq, 2.0 * gr], dim=-1)
    Q = x_lin.new_zeros((P, N + 1, NZ, NZ))
    Q[:, 1:] = torch.diag_embed(Qz_diag)[:, None]
    R = torch.diag_embed(2.0 * gdr)[:, None].expand(P, N, NC, NC).contiguous()
    S = x_lin.new_zeros((P, N, NZ, NC))

    # linear terms: vx tracking + separation reward on (X, Y); reward index
    # k (state stage k+1) uses weights row k, planes row k
    q = x_lin.new_zeros((P, N + 1, NZ))
    q[:, 1:, 0] = -2.0 * gq[:, 0:1] * lim["vx_ref"]
    wq = _wq(gains.wq, dtype, dev)
    rew_x = 2.0 * wq * torch.sum(weights * planes[..., 0], dim=-1)
    rew_y = 2.0 * wq * torch.sum(weights * planes[..., 1], dim=-1)
    q[:, 1:, 7] += rew_x.to(dtype)
    q[:, 1:, 8] += rew_y.to(dtype)
    r = x_lin.new_zeros((P, N, NC))
    cost = LQRCost(Q=Q, q=q, R=R, r=r, S=S)

    # ---- constraints ------------------------------------------------------
    n_nb = planes.shape[-2]
    m = 4 + n_nb
    D = x_lin.new_zeros((P, N, m, NZ))
    E = x_lin.new_zeros((P, N, m, NC))
    lo = torch.full((P, N, m), -INF, dtype=dtype, device=dev)
    hi = torch.full((P, N, m), INF, dtype=dtype, device=dev)
    soft_lo = torch.full((P, N, m), INF, dtype=dtype, device=dev)
    soft_hi = torch.full((P, N, m), INF, dtype=dtype, device=dev)
    F_, G_ = dyn.F, dyn.G   # row j of x_{k+1} is stage-local: (F_kj, G_kj)

    # velocity: hard min_vel <= vx_{k+1} <= max_vel (soft upper, Qs[0])
    D[:, :, 0] = F_[:, :, 0]
    E[:, :, 0] = G_[:, :, 0]
    lo[:, :, 0] = lim["min_vel"]
    hi[:, :, 0] = lim["max_vel"]
    soft_hi[:, :, 0] = gqs[:, 0:1]

    # lateral error band, soft on both sides (LPV_Planner.py:299-303)
    ey_ub = halfwidth(track, x_lin[:, :N, 6], lane, sm=lim["sm"]).to(dtype)
    D[:, :, 1] = F_[:, :, 3]
    E[:, :, 1] = G_[:, :, 3]
    lo[:, :, 1] = -ey_ub
    hi[:, :, 1] = ey_ub
    soft_lo[:, :, 1] = gqs[:, 1:2]
    soft_hi[:, :, 1] = gqs[:, 1:2]

    # inputs: u_k = u_prev + du, hard box (LPV_Planner.py:331-339)
    D[:, :, 2, NX + 0] = 1.0
    E[:, :, 2, 0] = 1.0
    lo[:, :, 2] = -lim["max_ls"]
    hi[:, :, 2] = lim["max_rs"]
    D[:, :, 3, NX + 1] = 1.0
    E[:, :, 3, 1] = 1.0
    lo[:, :, 3] = -lim["max_dc"]
    hi[:, :, 3] = lim["max_ac"]

    # collision avoidance: a . p_{k+1} <= -D/2 - b, soft (Qs[2])
    # (LPV_Planner.py:263-272)
    ax, ay, b = planes[..., 0], planes[..., 1], planes[..., 2]
    D[:, :, 4:] = (ax[..., None] * F_[:, :, None, 7]
                   + ay[..., None] * F_[:, :, None, 8]).to(dtype)
    E[:, :, 4:] = (ax[..., None] * G_[:, :, None, 7]
                   + ay[..., None] * G_[:, :, None, 8]).to(dtype)
    hi[:, :, 4:] = (-lim["min_dist"][..., None] / 2.0 - b).to(dtype)
    soft_hi[:, :, 4:] = gqs[:, 2, None, None]

    return StageQP(dyn=dyn, cost=cost, D=D, E=E, lo=lo, hi=hi,
                   soft_lo=soft_lo, soft_hi=soft_hi)


def _violations(qp: StageQP, z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Realised soft-constraint violations ``(P, N, 3)``, reported like the
    reference's slack predictions sPred (vel, ey, planes)."""
    v = ((qp.D @ z[:, :-1, :, None])[..., 0]
         + (qp.E @ c[..., None])[..., 0])
    over = torch.clamp_min(v - qp.hi, 0.0) + torch.clamp_min(qp.lo - v, 0.0)
    s_planes = torch.amax(over[..., 4:], dim=-1)
    return torch.stack([over[..., 0], over[..., 1], s_planes], dim=-1)


def lpv_solve(track: Track, gains: Gains, limits: SysLimits,
              model: ModelParams, N: int, dt,
              x0: torch.Tensor, x_lin: torch.Tensor, u_lin: torch.Tensor,
              u_old: torch.Tensor, neighbours_xy: Optional[torch.Tensor],
              ego_xy: Optional[torch.Tensor] = None,
              w0=None, y0=None, rho_scale0=1.0,
              admm_iters: int = 100, rho: float = 10.0,
              alpha_relax: float = 1.6,
              eps: float = 1e-4, lane=0,
              epoch_len=None, assoc: bool = False,
              neigh_boost=None) -> LPVSolution:
    """P LPV-MPC solves (the reference ``PlannerLPV.solve``, :115-182).

    Args:
      x0: (P, 9) current states. x_lin (P, N+1, 9) / u_lin (P, N, 2):
        previous predictions used for linearisation and plane generation.
        u_old: (P, 2) previously applied inputs. neighbours_xy:
        (P, N+1, n_nb, 2) neighbour plans or None.
      ego_xy: (P, N+1, 2) ego plan positions for plane generation
        (defaults to x_lin's X, Y columns).
      neigh_boost: optional (P, n_nb) per-neighbour separation-reward
        multiplier-minus-one; only repulsive (positive) weights scale.
    """
    with span("cmpc.lpv.solve"):
        dtype, dev = x_lin.dtype, x_lin.device
        P = x_lin.shape[0]
        if neighbours_xy is None:
            planes = x_lin.new_zeros((P, N, 1, 3))
            weights = x_lin.new_zeros((P, N, 1))
        else:
            if ego_xy is None:
                ego_xy = x_lin[..., 7:9]
            planes = compute_hyperplanes(ego_xy[:, :N], neighbours_xy[:, :N])
            min_dist = _lim(limits.min_dist, dtype, dev)[..., None]
            weights, _ = separation_weights(ego_xy[:, 1:],
                                            neighbours_xy[:, 1:], min_dist)
            if neigh_boost is not None:
                weights = torch.where(
                    weights > 0,
                    weights * (1.0 + neigh_boost)[:, None, :].to(dtype),
                    weights)

        with span("cmpc.lpv.build"):
            qp = build_lpv_qp(track, gains, limits, model, N, dt, x_lin,
                              u_lin, planes, weights, lane=lane)
            if neighbours_xy is None:
                # disable the placeholder plane row
                hi = qp.hi.clone()
                hi[..., 4:] = INF
                qp = qp._replace(hi=hi)

        z0 = torch.cat([x0, u_old], dim=-1).to(dtype)
        sol: ADMMSolution = admm_solve(qp, z0, w0=w0, y0=y0,
                                       rho_scale0=rho_scale0,
                                       iters=admm_iters, rho=rho,
                                       alpha=alpha_relax, eps=eps,
                                       epoch_len=epoch_len, assoc=assoc)
        return LPVSolution(
            x_pred=sol.z[..., :NX], u_pred=sol.z[:, 1:, NX:],
            du_pred=sol.c, s_pred=_violations(qp, sol.z, sol.c),
            planes=planes, feasible=sol.feasible,
            w=sol.w, y=sol.y, rho_scale=sol.rho_scale,
            iterations=sol.iterations, r_prim=sol.r_prim)
