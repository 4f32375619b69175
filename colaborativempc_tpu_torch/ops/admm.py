"""Inequality-constrained stage QP via ADMM with Riccati inner solves
(PyTorch port).

Twin of ``colaborativempc_tpu/ops/admm.py`` (the on-device replacement for
OSQP, reference ``LPV_Planner.py:192-249``), batched over P problems: every
tensor carries a leading axis P, where the JAX functions are per problem
and vmapped.

Problem:

    min   sum_k stage_cost(z_k, c_k)        (LQRCost quadratics)
    s.t.  z_{k+1} = F_k z_k + G_k c_k + d_k,   z_0 fixed
          lo_k <= D_k z_k + E_k c_k <= hi_k    (per-stage, stage-local)

Soft bounds carry a quadratic violation weight that only enters the
closed-form prox of the w-step, never the Riccati matrices. Each
refactorisation epoch runs ``ops/cuda_lqr.py admm_epoch_batched``: the CUDA
kernel for CUDA tensors, its plain twin for CPU tensors. Between epochs the
per-row-class rho is rescaled OSQP-style, in torch.

Per-problem freeze: under the JAX double vmap each problem's
``while_loop`` stops on its own convergence while its batch-mates iterate.
Here an ``active`` mask of shape (P,) applies each epoch's results only to
problems still running, so every problem gets the result (and iteration
count) of its standalone solve. The host reads the mask once per epoch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from colaborativempc_tpu_torch.ops.cuda_lqr import admm_epoch_batched
from colaborativempc_tpu_torch.ops.lqr import (
    LQRCost, LQRDynamics, lqr_factorize,
)


class StageQP(NamedTuple):
    """A batch of stage-structured QPs: LQR data + per-stage inequality rows.

    ``soft_lo``/``soft_hi``: optional per-row quadratic penalty weights;
    +inf (or None) means a hard bound.
    """
    dyn: LQRDynamics
    cost: LQRCost
    D: torch.Tensor    # (P, N, m, nz)
    E: torch.Tensor    # (P, N, m, nc)
    lo: torch.Tensor   # (P, N, m)
    hi: torch.Tensor   # (P, N, m)
    soft_lo: Optional[torch.Tensor] = None   # (P, N, m) weights or None
    soft_hi: Optional[torch.Tensor] = None


class ADMMSolution(NamedTuple):
    z: torch.Tensor          # (P, N+1, nz)
    c: torch.Tensor          # (P, N, nc)
    w: torch.Tensor          # (P, N, m)
    y: torch.Tensor          # (P, N, m)
    rho_scale: torch.Tensor  # (P, m) per-row-class rho multipliers
    iterations: torch.Tensor  # (P,) int
    r_prim: torch.Tensor     # (P,)
    r_dual: torch.Tensor     # (P,)
    feasible: torch.Tensor   # (P,) primal residual below tolerance at exit


def _active_rows(qp: StageQP) -> torch.Tensor:
    """Mask of rows with at least one finite bound; fully unbounded rows are
    excluded from the splitting so they add no proximal damping."""
    return (torch.isfinite(qp.lo) | torch.isfinite(qp.hi)).to(qp.D.dtype)


def build_admm_cost(qp: StageQP, rho) -> LQRCost:
    """Quadratic cost augmented with the rho-penalty terms; ``rho`` is a
    scalar or a per-row ``(P, N, m)`` tensor."""
    mask = _active_rows(qp)
    rv = rho * mask
    D = qp.D * mask[..., None]
    E = qp.E * mask[..., None]
    Dw = D * rv[..., None]
    DtD = Dw.transpose(-1, -2) @ D
    EtE = (E * rv[..., None]).transpose(-1, -2) @ E
    DtE = Dw.transpose(-1, -2) @ E
    N = qp.lo.shape[1]
    Q = torch.cat([qp.cost.Q[:, :N] + DtD, qp.cost.Q[:, N:]], dim=1)
    return LQRCost(Q=Q, q=qp.cost.q, R=qp.cost.R + EtE, r=qp.cost.r,
                   S=qp.cost.S + DtE)


class ADMMEpochData(NamedTuple):
    """Everything one ADMM epoch needs besides the (w, y) state — the
    factorisation and constraint data fixed across the epoch's iterations,
    with a leading batch axis P. Produced by :func:`admm_epoch_inputs`,
    consumed by ``ops/cuda_lqr.py admm_epoch_batched`` (kernel and twin).
    """
    F: torch.Tensor        # (P, N, nz, nz) dynamics
    G: torch.Tensor        # (P, N, nz, nc)
    d: torch.Tensor        # (P, N, nz)
    K: torch.Tensor        # (P, N, nc, nz) Riccati gains (rho-augmented)
    Quu_inv: torch.Tensor  # (P, N, nc, nc) explicit inverses (nc is tiny)
    Qxu: torch.Tensor      # (P, N, nz, nc)
    m: torch.Tensor        # (P, N, nz) P_{k+1} d_k drift
    q: torch.Tensor        # (P, N+1, nz) linear state cost
    r: torch.Tensor        # (P, N, nc)
    D: torch.Tensor        # (P, N, mr, nz) masked constraint rows
    E: torch.Tensor        # (P, N, mr, nc)
    lo: torch.Tensor       # (P, N, mr)
    hi: torch.Tensor       # (P, N, mr)
    rv: torch.Tensor       # (P, N, mr) effective per-row rho (0 if inactive)
    fac_lo: torch.Tensor   # (P, N, mr) soft-row prox shrink factors
    fac_hi: torch.Tensor   # (P, N, mr)


def _soft(qp: StageQP, weights) -> torch.Tensor:
    if weights is None:
        return torch.full_like(qp.lo, torch.inf)
    return weights.to(qp.lo.dtype)


def admm_epoch_inputs(qp: StageQP, rho: float = 10.0,
                      rho_scale=1.0, reg: float = 1e-8) -> ADMMEpochData:
    """Factorise and precompute one epoch's fixed data for the per-row rho
    multipliers ``rho_scale`` (scalar, ``(m,)`` or ``(P, m)``). Every field
    is contiguous, as the kernel takes it."""
    dtype, dev = qp.lo.dtype, qp.lo.device
    P, _, mr = qp.lo.shape
    mask = _active_rows(qp)
    rho_scale = torch.as_tensor(rho_scale, dtype=dtype, device=dev)
    rho_scale = torch.broadcast_to(rho_scale, (P, mr))
    rv = rho * mask * rho_scale[:, None, :]
    slo, shi = _soft(qp, qp.soft_lo), _soft(qp, qp.soft_hi)
    aug_cost = build_admm_cost(qp, rv)
    fac = lqr_factorize(qp.dyn, aug_cost, reg)
    nc = qp.dyn.G.shape[-1]
    eye = torch.eye(nc, dtype=dtype, device=dev).expand(fac.Quu_chol.shape)
    Quu_inv = torch.cholesky_solve(eye, fac.Quu_chol)
    rv_safe = torch.where(rv > 0, rv, torch.ones_like(rv))
    zero = torch.zeros_like(rv)
    fac_lo = torch.where(torch.isinf(slo), zero, rv_safe / (rv_safe + 2.0 * slo))
    fac_hi = torch.where(torch.isinf(shi), zero, rv_safe / (rv_safe + 2.0 * shi))
    data = ADMMEpochData(
        F=qp.dyn.F, G=qp.dyn.G, d=qp.dyn.d,
        K=fac.K, Quu_inv=Quu_inv, Qxu=fac.Qxu, m=fac.m,
        q=aug_cost.q, r=aug_cost.r,
        D=qp.D * mask[..., None], E=qp.E * mask[..., None],
        lo=qp.lo, hi=qp.hi, rv=rv, fac_lo=fac_lo, fac_hi=fac_hi)
    return ADMMEpochData(*(t.contiguous() for t in data))


def default_epoch_len(N: int) -> int:
    """N-dependent refactorisation epoch length (JAX ``admm_solve``)."""
    return 10 if N < 16 else (20 if N < 48 else 30)


def admm_solve(qp: StageQP, z0: torch.Tensor,
               w0: Optional[torch.Tensor] = None,
               y0: Optional[torch.Tensor] = None,
               iters: int = 100, rho: float = 10.0, alpha: float = 1.6,
               eps: float = 1e-4, reg: float = 1e-8,
               epoch_len: Optional[int] = None,
               rho_scale0=1.0,
               max_rho_scale: float = 1e6,
               feas_tol: float = 1e-2,
               assoc: bool = False) -> ADMMSolution:
    """Solve P stage QPs with warm-startable ``(w0, y0, rho_scale0)``.

    ``z0 (P, nz)``; ``w0``/``y0`` ``(P, N, m)``; ``rho_scale0`` scalar,
    ``(m,)`` or ``(P, m)``. ``iters`` rounds DOWN to whole epochs
    (``iters // epoch_len``, at least one). A problem stops once every row
    class has primal and dual residual below ``eps`` or its budget is
    spent; its batch-mates go on.
    """
    if assoc:
        raise NotImplementedError(
            "the associative-scan ADMM path is not ported yet")
    P, N, m = qp.lo.shape
    dtype, dev = z0.dtype, z0.device
    nz, nc = qp.dyn.F.shape[-1], qp.dyn.G.shape[-1]
    if epoch_len is None:
        epoch_len = default_epoch_len(N)
    n_epochs = max(1, iters // epoch_len)

    if w0 is None:
        w0 = torch.clamp(torch.zeros((P, N, m), dtype=dtype, device=dev),
                         qp.lo, qp.hi)
    if y0 is None:
        y0 = torch.zeros((P, N, m), dtype=dtype, device=dev)

    z = torch.zeros((P, N + 1, nz), dtype=dtype, device=dev)
    c = torch.zeros((P, N, nc), dtype=dtype, device=dev)
    w, y = w0, y0
    rho_scale = torch.broadcast_to(
        torch.as_tensor(rho_scale0, dtype=dtype, device=dev), (P, m)).clone()
    it = torch.zeros((P,), dtype=torch.int64, device=dev)
    r_prim = torch.full((P, m), torch.inf, dtype=dtype, device=dev)
    r_dual = torch.full((P, m), torch.inf, dtype=dtype, device=dev)
    z0c = z0.contiguous()

    for _ in range(n_epochs):
        not_conv = ((torch.amax(r_prim, dim=1) > eps)
                    | (torch.amax(r_dual, dim=1) > eps))
        active = (it < n_epochs * epoch_len) & not_conv
        if not bool(active.any()):      # the one host sync per epoch
            break
        data = admm_epoch_inputs(qp, rho, rho_scale, reg)
        z_e, c_e, w_e, y_e, rp_e, rd_e = admm_epoch_batched(
            data, z0c, w.contiguous(), y.contiguous(),
            epoch_len=epoch_len, alpha=alpha)
        # OSQP-style per-class rescale, bounded; the scaled dual follows.
        # Classes already inside tolerance keep their rho.
        ratio = torch.sqrt(rp_e / torch.clamp_min(rd_e, 1e-12))
        ratio = torch.clamp(ratio, 0.2, 10.0)
        new_scale = torch.clamp(rho_scale * ratio, 1e-3, max_rho_scale)
        quiet = (rp_e < eps) & (rd_e < eps)
        new_scale = torch.where(quiet, rho_scale, new_scale)
        y_e = y_e * (rho_scale / new_scale)[:, None, :]

        a1 = active[:, None]
        a2 = active[:, None, None]
        z = torch.where(a2, z_e, z)
        c = torch.where(a2, c_e, c)
        w = torch.where(a2, w_e, w)
        y = torch.where(a2, y_e, y)
        rho_scale = torch.where(a1, new_scale, rho_scale)
        r_prim = torch.where(a1, rp_e, r_prim)
        r_dual = torch.where(a1, rd_e, r_dual)
        it = it + epoch_len * active.to(it.dtype)

    r_p = torch.amax(r_prim, dim=1)
    return ADMMSolution(z=z, c=c, w=w, y=y, rho_scale=rho_scale,
                        iterations=it, r_prim=r_p,
                        r_dual=torch.amax(r_dual, dim=1),
                        # tolerant acceptance mirroring the reference, which
                        # treats OSQP 'solved_inaccurate' and even
                        # 'max_iter_reached' as usable (LPV_Planner.py:241-249)
                        feasible=r_p < feas_tol)
