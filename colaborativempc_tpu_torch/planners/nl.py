"""Nonlinear collaborative MPC planner: SQP over the stage-QP engine
(PyTorch port).

Twin of ``colaborativempc_tpu/planners/nl.py`` (reference ``PlannerEu`` /
``PlannerHp``, ``nonLinDistribPlanner/NL_Planner_Eu.py``,
``NL_Planner_Hp.py``), batched over P problems (P = B fleets x n_agents in
the Jacobi OCD sweep, B fleets per agent in the Gauss-Seidel sweep). Each
SQP iteration linearises the Euler-discretised bicycle model around the
incumbent trajectory, assembles the stage QP and solves it with
``ops/admm.py admm_solve`` — on CUDA tensors every ADMM epoch is the
hand-written kernel of ``csrc/lqr_kernels.cu``.

The QP keeps the JAX layout: the 11-dim augmented state of the LPV planner,
stage controls ``nc = 2`` (``2 + 2 n_nb`` for ``hp_opt``, whose master
refines its separating planes as extra controls), and rows velocity, lateral
band, two input boxes, then the coupling rows (``hp_opt`` adds two hard
trust-box rows per neighbour: ``m = 4 + 3 n_nb``). Role asymmetry (master:
price in the cost; slave: linearised distance row) is a per-problem
``master_mask`` over the neighbour axis.

On CUDA tensors each build is one launch of the hand-written kernel of
``csrc/sqp_qp.cu`` (``ops/cuda_sqp.py nl_qp_batched``); on CPU tensors it
is :func:`build_nl_qp_plain`, whose Jacobians of the linearisation are
analytic (the JAX package takes ``jax.jacfwd`` of the same model; both
agree to rounding).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from colaborativempc_tpu_torch.config.params import Gains, ModelParams, SysLimits
from colaborativempc_tpu_torch.dynamics.bicycle import (
    NX, NU, LOW_VEL_THRESH, f_continuous,
)
from colaborativempc_tpu_torch.geometry import Track, curvature, halfwidth
from colaborativempc_tpu_torch.ops import (
    ADMMSolution, LQRCost, StageQP, admm_solve, cuda_sqp,
)
from colaborativempc_tpu_torch.planners.lpv import (
    NZ, NC, SOFT_WEIGHT_CAP, _augment_dynamics, _gain, _lim, _violations,
)
from colaborativempc_tpu_torch.utils.tracing import span

INF = float("inf")
_EPS = 1e-6


class NLSolution(NamedTuple):
    x_pred: torch.Tensor     # (P, N+1, 9)
    u_pred: torch.Tensor     # (P, N, 2)
    du_pred: torch.Tensor    # (P, N, 2)
    s_pred: torch.Tensor     # (P, N, 3) realised violations (vel, ey, distance)
    feasible: torch.Tensor   # (P,) bool
    w: torch.Tensor          # (P, N, m)
    y: torch.Tensor
    rho_scale: torch.Tensor  # (P, m)
    iterations: torch.Tensor  # (P,) ADMM iterations summed over SQP iterations
    r_prim: torch.Tensor     # (P,)
    planes: torch.Tensor     # (P, n_nb, N, 2) refined (theta, b) — hp_opt only


# trust region on the per-SQP-iteration plane perturbation (hp_opt): keeps
# the linearisation a(theta_bar + dtheta) ~ a + a' dtheta valid
PLANE_TRUST_THETA = 0.3   # [rad]
PLANE_TRUST_B = 0.2       # [m]
PLANE_REG = 0.1           # quadratic regularisation on (dtheta, db)


def _jacobians(x: torch.Tensor, u: torch.Tensor, kappa, p: ModelParams):
    """Analytic ``df/dx (..., 9, 9)`` and ``df/du (..., 9, 2)`` of
    ``dynamics/bicycle.py f_continuous``, with its low-velocity switch: below
    ``vx = 0.2`` the tyre terms of rows 0-2 are zero, and so are their
    derivatives."""
    vx, vy, wz, ey, epsi, theta = (x[..., i] for i in range(6))
    delta = u[..., 0]
    low = vx < LOW_VEL_THRESH
    inv = 1.0 / torch.where(low, torch.ones_like(vx), vx)
    inv2 = inv * inv
    sd, cd = torch.sin(delta), torch.cos(delta)
    se, ce = torch.sin(epsi), torch.cos(epsi)
    st, ct = torch.sin(theta), torch.cos(theta)
    den = 1.0 - ey * kappa
    z, one = torch.zeros_like(vx), torch.ones_like(vx)

    def gate(v):
        return torch.where(low, z, v)

    a = p.Cf / p.m
    g1 = (p.Cr + p.Cf * cd) / p.m             # -A22 vx
    h1 = (p.lf * p.Cf * cd - p.lr * p.Cr) / p.m   # -(A23 + vx) vx
    g2 = (p.lf * p.Cf * cd - p.lr * p.Cr) / p.I   # -A32 vx
    h2 = (p.lf ** 2 * p.Cf * cd + p.lr ** 2 * p.Cr) / p.I   # -A33 vx
    bk = p.lf * p.Cf / p.I                    # B31 / cos(delta)
    # f4 = kappa (se vy - ce vx) / den + wz,  f6 = (ce vx - se vy) / den
    e4 = kappa * (se * vy - ce * vx)
    e6 = ce * vx - se * vy
    rows = [
        [-p.mu + gate(-a * sd * (vy + p.lf * wz) * inv2),
         gate(a * sd * inv + wz), gate(a * sd * p.lf * inv + vy),
         z, z, z, z, z, z],
        [gate((g1 * vy + h1 * wz) * inv2 - wz), gate(-g1 * inv),
         gate(-h1 * inv - vx), z, z, z, z, z, z],
        [gate((g2 * vy + h2 * wz) * inv2), gate(-g2 * inv), gate(-h2 * inv),
         z, z, z, z, z, z],
        [se, ce, z, z, ce * vx - se * vy, z, z, z, z],
        [-ce * kappa / den, se * kappa / den, one, e4 * kappa / den ** 2,
         kappa * (se * vx + ce * vy) / den, z, z, z, z],
        [z, z, one, z, z, z, z, z, z],
        [ce / den, -se / den, z, e6 * kappa / den ** 2,
         -(se * vx + ce * vy) / den, z, z, z, z],
        [ct, -st, z, z, z, -st * vx - ct * vy, z, z, z],
        [st, ct, z, z, z, ct * vx - st * vy, z, z, z],
    ]
    Jx = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    du = [
        gate(a * cd * (vy + p.lf * wz) * inv) + gate(-a * (cd * delta + sd)),
        gate((p.Cf * sd / p.m) * (vy + p.lf * wz) * inv)
        + a * (cd - sd * delta),
        gate(bk * sd * (vy + p.lf * wz) * inv) + bk * (cd - sd * delta),
    ]
    Ju = torch.zeros(x.shape + (NU,), dtype=x.dtype, device=x.device)
    Ju[..., 0, 0], Ju[..., 1, 0], Ju[..., 2, 0] = du
    Ju[..., 0, 1] = 1.0
    return Jx, Ju


def _linearize_horizon(x_bar: torch.Tensor, u_bar: torch.Tensor,
                       kappas: torch.Tensor, dt, model: ModelParams):
    """Linearisation of the Euler-discretised nonlinear dynamics around
    ``(x_bar (..., N, 9), u_bar (..., N, 2))``: ``x_{k+1} ~= Ad x + Bd u +
    rd`` with ``Ad (..., N, 9, 9)``, ``Bd (..., N, 9, 2)``, ``rd (..., N,
    9)``."""
    Jx, Ju = _jacobians(x_bar, u_bar, kappas, model)
    eye = torch.eye(NX, dtype=x_bar.dtype, device=x_bar.device)
    Ad = eye + dt * Jx
    Bd = dt * Ju
    fd = x_bar + dt * f_continuous(x_bar, u_bar, kappas, model)
    rd = fd - (Ad @ x_bar[..., None])[..., 0] - (Bd @ u_bar[..., None])[..., 0]
    return Ad, Bd, rd


def build_nl_qp(track: Track, gains: Gains, limits: SysLimits,
                model: ModelParams, N: int, dt,
                x_bar: torch.Tensor, u_bar: torch.Tensor,
                lambdas: torch.Tensor, neigh_xy: torch.Tensor,
                master_mask: torch.Tensor,
                u_trust: Optional[tuple] = (0.06, 0.6),
                coupling: str = "eu", lane=0,
                planes0: Optional[torch.Tensor] = None) -> StageQP:
    """Assemble P SQP inner QPs around ``(x_bar (P, N+1, 9), u_bar (P, N,
    2))``; arguments as :func:`build_nl_qp_plain`.

    On CPU tensors: :func:`build_nl_qp_plain`. On CUDA tensors: one launch
    of ``ops/cuda_sqp.py nl_qp_batched`` (the inputs made contiguous
    first), which raises on a tensor it cannot take (dtype, shape, device);
    there is no fallback to the plain version."""
    if x_bar.device.type == "cpu":
        return build_nl_qp_plain(track, gains, limits, model, N, dt, x_bar,
                                 u_bar, lambdas, neigh_xy, master_mask,
                                 u_trust=u_trust, coupling=coupling,
                                 lane=lane, planes0=planes0)
    return cuda_sqp.nl_qp_batched(
        track, gains, limits, model, N, dt, x_bar.contiguous(),
        u_bar.contiguous(), lambdas.contiguous(), neigh_xy.contiguous(),
        master_mask.contiguous(), u_trust=u_trust, coupling=coupling,
        lane=lane, planes0=None if planes0 is None else planes0.contiguous())


def build_nl_qp_plain(track: Track, gains: Gains, limits: SysLimits,
                      model: ModelParams, N: int, dt,
                      x_bar: torch.Tensor, u_bar: torch.Tensor,
                      lambdas: torch.Tensor, neigh_xy: torch.Tensor,
                      master_mask: torch.Tensor,
                      u_trust: Optional[tuple] = (0.06, 0.6),
                      coupling: str = "eu", lane=0,
                      planes0: Optional[torch.Tensor] = None) -> StageQP:
    """Plain version of :func:`build_nl_qp` on any device: P SQP inner QPs
    around ``(x_bar (P, N+1, 9), u_bar (P, N, 2))`` in batched torch.

    Args:
      gains: each vector shared by all problems or per problem ``(P, k)``.
      limits: floats or per-problem ``(P,)`` tensors.
      lambdas: ``(P, n_nb, N)`` coupling prices per neighbour and stage.
      neigh_xy: ``(P, N+1, n_nb, 2)`` neighbour plans (stage-aligned).
      master_mask: ``(P, n_nb)`` 1.0 where the ego is the master of the pair
        (price in its cost), 0.0 where it is the slave (linearised distance
        row).
      coupling: ``"eu"`` (Euclidean distance), ``"hp"`` (symmetric
        separating-plane rows, the price at half the Euclidean gradient) or
        ``"hp_opt"`` (planes as decision variables of the master).
      planes0: hp_opt only — ``(P, n_nb, N, 2)`` incumbent ``(theta, b)``
        per neighbour and stage, in the canonical pair orientation (normal
        ``(cos, sin)`` from master to slave).
    See the JAX ``build_nl_qp`` for the formulation of each row.
    """
    dtype, dev = x_bar.dtype, x_bar.device
    P = x_bar.shape[0]
    n_nb = neigh_xy.shape[-2]
    hp_opt = coupling == "hp_opt"
    nc = NC + (2 * n_nb if hp_opt else 0)
    lim = {k: _lim(getattr(limits, k), dtype, dev) for k in limits._fields}
    gq = _gain(gains.q, NX, dtype, dev)
    gr = _gain(gains.r, NU, dtype, dev)
    gdr = _gain(gains.dr, NC, dtype, dev)
    gqs = torch.clamp_max(_gain(gains.qs, 3, dtype, dev), SOFT_WEIGHT_CAP)

    kappas = curvature(track, x_bar[:, :N, 6], lane)
    Ad, Bd, rd = _linearize_horizon(x_bar[:, :N], u_bar, kappas, dt, model)
    dyn = _augment_dynamics(Ad, Bd)
    dyn.d[..., :NX] = rd
    if hp_opt:
        # plane controls do not enter the dynamics: zero G columns
        G_ext = x_bar.new_zeros((P, N, NZ, nc))
        G_ext[..., :NC] = dyn.G
        dyn = dyn._replace(G=G_ext)

    # ---- cost (NL_Planner_Eu.py:23-30) ------------------------------------
    Q = x_bar.new_zeros((P, N + 1, NZ, NZ))
    Q[:, 1:] = torch.diag_embed(torch.cat([2.0 * gq, 2.0 * gr], dim=-1))[:, None]
    R_diag = torch.cat([2.0 * gdr, torch.full(
        (gdr.shape[0], nc - NC), 2.0 * PLANE_REG, dtype=dtype, device=dev)],
        dim=-1)
    R = torch.diag_embed(R_diag)[:, None].expand(P, N, nc, nc).contiguous()
    S = x_bar.new_zeros((P, N, NZ, nc))
    q = x_bar.new_zeros((P, N + 1, NZ))
    q[:, 1:, 0] = -2.0 * gq[:, 0:1] * lim["vx_ref"]

    # master coupling price: d/dp [-lambda ||p - p_n||] = -lambda g_hat
    # ("hp": half of that; "hp_opt": the price acts on the plane controls)
    p_bar = x_bar[:, 1:, 7:9]                                 # (P, N, 2)
    diff = p_bar[:, :, None, :] - neigh_xy[:, 1:]             # (P, N, nb, 2)
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + _EPS)  # (P, N, nb)
    g_hat = diff / dist[..., None]
    price_scale = 0.5 if coupling == "hp" else 1.0
    lam = (price_scale * lambdas.transpose(1, 2)
           * master_mask[:, None, :])                         # (P, N, nb)
    r = x_bar.new_zeros((P, N, nc))
    if hp_opt:
        th_bar = planes0[..., 0].transpose(1, 2)              # (P, N, nb)
        b_bar = planes0[..., 1].transpose(1, 2)
        a_x, a_y = torch.cos(th_bar), torch.sin(th_bar)
        ap_x, ap_y = -torch.sin(th_bar), torch.cos(th_bar)   # a'(theta)
        # lambda prices the slave's side of the master's plane
        # (NL_Planner_Hp.py:58-60): linear cost -lam (a'.p_n) on dtheta and
        # -lam on db
        ap_pn = ap_x * neigh_xy[:, 1:, :, 0] + ap_y * neigh_xy[:, 1:, :, 1]
        r[:, :, NC:NC + n_nb] = (-lam * ap_pn).to(dtype)
        r[:, :, NC + n_nb:] = (-lam).to(dtype)
    else:
        q[:, 1:, 7] += -torch.sum(lam * g_hat[..., 0], dim=-1).to(dtype)
        q[:, 1:, 8] += -torch.sum(lam * g_hat[..., 1], dim=-1).to(dtype)
    cost = LQRCost(Q=Q, q=q, R=R, r=r, S=S)

    # ---- constraints ------------------------------------------------------
    m = 4 + (3 * n_nb if hp_opt else n_nb)
    D = x_bar.new_zeros((P, N, m, NZ))
    E = x_bar.new_zeros((P, N, m, nc))
    lo = torch.full((P, N, m), -INF, dtype=dtype, device=dev)
    hi = torch.full((P, N, m), INF, dtype=dtype, device=dev)
    soft_lo = torch.full((P, N, m), INF, dtype=dtype, device=dev)
    soft_hi = torch.full((P, N, m), INF, dtype=dtype, device=dev)
    # rows composed through the dynamics see x_{k+1} - d_k, so every bound
    # below is shifted by the row's d-part
    F_, G_, d_ = dyn.F, dyn.G, dyn.d

    # velocity band, soft both sides (NL_Planner_Eu.py:60)
    D[:, :, 0], E[:, :, 0] = F_[:, :, 0], G_[:, :, 0]
    lo[:, :, 0] = lim["min_vel"] - d_[:, :, 0]
    hi[:, :, 0] = lim["max_vel"] - d_[:, :, 0]
    soft_lo[:, :, 0] = gqs[:, 0:1]
    soft_hi[:, :, 0] = gqs[:, 0:1]

    # lateral error band, soft both sides (NL_Planner_Eu.py:62)
    ey_ub = halfwidth(track, x_bar[:, :N, 6], lane, sm=lim["sm"]).to(dtype)
    D[:, :, 1], E[:, :, 1] = F_[:, :, 3], G_[:, :, 3]
    lo[:, :, 1] = -ey_ub - d_[:, :, 3]
    hi[:, :, 1] = ey_ub - d_[:, :, 3]
    soft_lo[:, :, 1] = gqs[:, 0:1]
    soft_hi[:, :, 1] = gqs[:, 0:1]

    # input box, hard (NL_Planner_Eu.py:65-66), intersected with the SQP
    # trust region around the linearisation inputs
    if u_trust is not None:
        lo_d = torch.maximum(-lim["max_ls"], u_bar[..., 0] - u_trust[0])
        hi_d = torch.minimum(lim["max_rs"], u_bar[..., 0] + u_trust[0])
        lo_a = torch.maximum(-lim["max_dc"], u_bar[..., 1] - u_trust[1])
        hi_a = torch.minimum(lim["max_ac"], u_bar[..., 1] + u_trust[1])
    else:
        lo_d, hi_d = -lim["max_ls"], lim["max_rs"]
        lo_a, hi_a = -lim["max_dc"], lim["max_ac"]
    D[:, :, 2, NX + 0] = 1.0
    E[:, :, 2, 0] = 1.0
    lo[:, :, 2], hi[:, :, 2] = lo_d, hi_d
    D[:, :, 3, NX + 1] = 1.0
    E[:, :, 3, 1] = 1.0
    lo[:, :, 3], hi[:, :, 3] = lo_a, hi_a

    # coupling rows: the position of x_{k+1} along g (distance gradient, or
    # the plane normal for hp_opt)
    gx, gy = (a_x, a_y) if hp_opt else (g_hat[..., 0], g_hat[..., 1])
    D[:, :, 4:4 + n_nb] = (gx[..., None] * F_[:, :, None, 7]
                           + gy[..., None] * F_[:, :, None, 8]).to(dtype)
    E[:, :, 4:4 + n_nb] = (gx[..., None] * G_[:, :, None, 7]
                           + gy[..., None] * G_[:, :, None, 8]).to(dtype)
    dds = gx * d_[:, :, 7, None] + gy * d_[:, :, 8, None]     # (P, N, nb)
    mrow = master_mask[:, None, :] > 0                        # (P, 1, nb)
    if hp_opt:
        # ego's own side of the plane, linearised in (p, dtheta, db):
        #   a.p + (a'.p_bar) dtheta + db  <= -dth/2 - b_bar  (master)
        #   a.p                           >= +dth/2 - b_bar  (slave: its
        #   plane is the master's shipped parameter, NL_Planner_Hp.py:97)
        ap_p = ap_x * p_bar[..., 0:1] + ap_y * p_bar[..., 1:2]
        for j in range(n_nb):
            E[:, :, 4 + j, NC + j] = torch.where(
                mrow[..., j], ap_p[..., j], torch.zeros_like(ap_p[..., j]))
            E[:, :, 4 + j, NC + n_nb + j] = mrow[..., j].to(dtype)
            # hard trust boxes on the plane perturbations; a slave's box is
            # pinned to zero
            E[:, :, 4 + n_nb + j, NC + j] = 1.0
            E[:, :, 4 + 2 * n_nb + j, NC + n_nb + j] = 1.0
        dth2 = lim["min_dist"][..., None] / 2.0
        inf = torch.full_like(b_bar, INF)
        hi[:, :, 4:4 + n_nb] = torch.where(mrow, -dth2 - b_bar - dds, inf)
        lo[:, :, 4:4 + n_nb] = torch.where(mrow, -inf, dth2 - b_bar - dds)
        qs2 = torch.broadcast_to(gqs[:, 2, None, None], inf.shape)
        soft_hi[:, :, 4:4 + n_nb] = torch.where(mrow, qs2, inf)
        soft_lo[:, :, 4:4 + n_nb] = torch.where(mrow, inf, qs2)
        zero = torch.zeros((), dtype=dtype, device=dev)
        tr_th = torch.where(mrow, PLANE_TRUST_THETA, zero)       # (P, 1, nb)
        tr_b = torch.where(mrow, PLANE_TRUST_B, zero)
        lo[:, :, 4 + n_nb:4 + 2 * n_nb] = -tr_th
        hi[:, :, 4 + n_nb:4 + 2 * n_nb] = tr_th
        lo[:, :, 4 + 2 * n_nb:] = -tr_b
        hi[:, :, 4 + 2 * n_nb:] = tr_b
        return StageQP(dyn=dyn, cost=cost, D=D, E=E, lo=lo, hi=hi,
                       soft_lo=soft_lo, soft_hi=soft_hi)
    if coupling == "hp":
        # symmetric plane rows: each side keeps dth/2 from the bisector
        # through the midpoint, g_hat.p >= dth/2 + g_hat.mid (both roles)
        mid = 0.5 * (p_bar[:, :, None, :] + neigh_xy[:, 1:])
        bound = (lim["min_dist"][..., None] / 2.0
                 + torch.sum(g_hat * mid, dim=-1) - dds)
        lo[:, :, 4:] = bound.to(dtype)
    else:
        # slave-only linearised distance rows, soft (NL_Planner_Eu.py:71);
        # disabled (lo = -inf) on master pairs
        bound = (lim["min_dist"][..., None] - dist
                 + torch.sum(g_hat * p_bar[:, :, None, :], dim=-1) - dds)
        slave = (1.0 - master_mask)[:, None, :] > 0
        lo[:, :, 4:] = torch.where(slave, bound.to(dtype),
                                   torch.full_like(bound, -INF, dtype=dtype))
    soft_lo[:, :, 4:] = gqs[:, 2, None, None]
    return StageQP(dyn=dyn, cost=cost, D=D, E=E, lo=lo, hi=hi,
                   soft_lo=soft_lo, soft_hi=soft_hi)


def nl_solve(track: Track, gains: Gains, limits: SysLimits,
             model: ModelParams, N: int, dt,
             x0: torch.Tensor, x_bar: torch.Tensor, u_bar: torch.Tensor,
             u_old: torch.Tensor,
             lambdas: torch.Tensor, neigh_xy: torch.Tensor,
             master_mask: torch.Tensor,
             w0=None, y0=None, rho_scale0=1.0,
             sqp_iters: int = 2, sqp_mix: float = 0.7,
             u_trust=(0.06, 0.6), coupling: str = "eu", lane=0,
             admm_iters: int = 100, rho: float = 10.0,
             alpha_relax: float = 1.6, eps: float = 1e-4,
             planes0: Optional[torch.Tensor] = None,
             epoch_len=None, assoc: bool = False) -> NLSolution:
    """P nonlinear OCD sub-problem solves (reference ``PlannerEu.solve``).

    SQP: linearise -> stage QP -> ADMM, ``sqp_iters`` times, blending each
    solution into the incumbent with ``sqp_mix`` (the C++ MPCC
    sqpSolutionUpdate, mpc.cpp:198-217); ``sqp_iters=1`` is RTI mode. For
    ``hp_opt`` the master's planes are refined with the trajectory and
    returned in ``NLSolution.planes``. Shapes as in :func:`build_nl_qp`;
    ``x0 (P, 9)``, ``u_old (P, 2)``, ``w0``/``y0`` ``(P, N, m)``,
    ``rho_scale0`` scalar, ``(m,)`` or ``(P, m)``.
    """
    with span("cmpc.nl.solve"):
        dtype, dev = x_bar.dtype, x_bar.device
        P = x_bar.shape[0]
        n_nb = neigh_xy.shape[-2]
        hp_opt = coupling == "hp_opt"
        m = 4 + (3 * n_nb if hp_opt else n_nb)
        z0 = torch.cat([x0, u_old], dim=-1).to(dtype)
        pl = (x_bar.new_zeros((P, n_nb, N, 2)) if planes0 is None
              else planes0.to(dtype))
        w = x_bar.new_zeros((P, N, m)) if w0 is None else w0
        y = torch.zeros_like(w) if y0 is None else y0
        rs = torch.broadcast_to(
            torch.as_tensor(rho_scale0, dtype=dtype, device=dev), (P, m))
        x_lin, u_lin = x_bar, u_bar
        iterations = torch.zeros((P,), dtype=torch.int64, device=dev)
        for _ in range(sqp_iters):
            with span("cmpc.nl.sqp_iter"):
                with span("cmpc.nl.build"):
                    qp = build_nl_qp(track, gains, limits, model, N, dt,
                                     x_lin, u_lin, lambdas, neigh_xy,
                                     master_mask, u_trust=u_trust,
                                     coupling=coupling, lane=lane,
                                     planes0=pl)
                sol: ADMMSolution = admm_solve(
                    qp, z0, w0=w, y0=y, rho_scale0=rs, iters=admm_iters,
                    rho=rho, alpha=alpha_relax, eps=eps, epoch_len=epoch_len,
                    assoc=assoc)
                x_lin = sqp_mix * sol.z[..., :NX] + (1.0 - sqp_mix) * x_lin
                u_lin = (sqp_mix * sol.z[:, 1:, NX:]
                         + (1.0 - sqp_mix) * u_lin)
                if hp_opt:
                    # plane perturbations are the extra control columns
                    dpl = torch.stack(
                        [sol.c[:, :, NC:NC + n_nb].transpose(1, 2),
                         sol.c[:, :, NC + n_nb:].transpose(1, 2)],
                        dim=-1)                                # (P, nb, N, 2)
                    pl = pl + sqp_mix * dpl * master_mask[:, :, None, None]
                # violations against this iteration's own QP (consistent
                # linearisation, as in JAX)
                viol = _violations(qp, sol.z, sol.c)
                w, y, rs = sol.w, sol.y, sol.rho_scale
                iterations = iterations + sol.iterations
        return NLSolution(
            x_pred=x_lin, u_pred=u_lin, du_pred=sol.c[..., :NC],
            s_pred=viol, feasible=sol.feasible, w=w, y=y, rho_scale=rs,
            iterations=iterations, r_prim=sol.r_prim, planes=pl)
