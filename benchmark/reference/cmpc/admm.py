# Frozen copy of the port's plain path: colaborativempc_tpu_torch/ops/admm.py
# as of the benchmark's first version, imports made relative.
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
refactorisation epoch first derives its fixed data
(:func:`admm_epoch_inputs_plain`: the rho-augmented cost, its Riccati
factorisation and the prox factors), then runs ``epoch_len`` iterations
with the sequential affine solve (:func:`admm_epoch_batched_plain`): in
the copy every epoch is plain torch, on any device and dtype, whatever
``assoc`` says. Between epochs the per-row-class rho is rescaled
OSQP-style, in torch.

Per-problem freeze: under the JAX double vmap each problem's
``while_loop`` stops on its own convergence while its batch-mates iterate.
Here an ``active`` mask of shape (P,) applies each epoch's results only to
problems still running, so every problem gets the result (and iteration
count) of its standalone solve. The host reads the mask once per epoch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .lqr import LQRCost, LQRDynamics, lqr_factorize


# The kernel's plain twin, from colaborativempc_tpu_torch/ops/cuda_lqr.py.
def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def lqr_affine_solve_batched_plain(F, G, d, K, Quu_inv, Qxu, m, q, r, z0):
    """Plain twin of :func:`lqr_affine_solve_batched`."""
    N = F.shape[1]
    p = q[:, N]
    kff = [None] * N
    for k in range(N - 1, -1, -1):
        t = p + m[:, k]
        Qu = r[:, k] + _mv(G[:, k].transpose(-1, -2), t)
        kff[k] = -_mv(Quu_inv[:, k], Qu)
        p = q[:, k] + _mv(F[:, k].transpose(-1, -2), t) + _mv(Qxu[:, k], kff[k])
    z, zs, cs = z0, [z0], []
    for k in range(N):
        c = _mv(K[:, k], z) + kff[k]
        z = _mv(F[:, k], z) + _mv(G[:, k], c) + d[:, k]
        zs.append(z)
        cs.append(c)
    return torch.stack(zs, 1), torch.stack(cs, 1)


def admm_epoch_batched_plain(data, z0, w0, y0, *, epoch_len: int = 25,
                             alpha: float = 1.6, affine=None):
    """Plain twin of :func:`admm_epoch_batched`: ``epoch_len`` ADMM
    iterations with the fixed factorisation in ``data`` (an
    ``ops/admm.py ADMMEpochData`` with leading batch axis P).

    ``affine(q, r) -> (z, c)`` is each iteration's inner affine solve from
    ``z0``; by default the kernel's sequential pass over ``data``'s factors
    (the port's associative epoch passes another)."""
    N = data.F.shape[1]
    if affine is None:
        def affine(q, r):
            return lqr_affine_solve_batched_plain(
                data.F, data.G, data.d, data.K, data.Quu_inv, data.Qxu,
                data.m, q, r, z0)
    mask = (data.rv > 0).to(data.rv.dtype)
    w, y = w0, y0
    for _ in range(epoch_len):
        t = data.rv * (y - w)                               # (P, N, mr)
        q_pen = torch.sum(data.D * t[..., None], dim=-2)    # (P, N, nz)
        r_pen = torch.sum(data.E * t[..., None], dim=-2)    # (P, N, nc)
        q = torch.cat([data.q[:, :N] + q_pen, data.q[:, N:]], dim=1)
        z, c = affine(q, data.r + r_pen)
        v = _mv(data.D, z[:, :N]) + _mv(data.E, c)
        vhat = alpha * v + (1.0 - alpha) * w
        wbar = vhat + y
        w_new = torch.where(wbar > data.hi,
                            data.hi + data.fac_hi * (wbar - data.hi), wbar)
        w_new = torch.where(wbar < data.lo,
                            data.lo + data.fac_lo * (wbar - data.lo), w_new)
        y = y + vhat - w_new
        rp = torch.amax(torch.abs(mask * (v - w_new)), dim=1)
        rd = torch.amax(torch.abs(mask * (w_new - w)), dim=1)
        w = w_new
    return z, c, w, y, rp, rd


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
    with a leading batch axis P. Produced by :func:`admm_epoch_inputs`: on
    the card by the CUDA kernel ``ops/cuda_lqr.py epoch_data_batched``
    (``csrc/epoch_data.cu``), on the CPU by its plain version
    :func:`admm_epoch_inputs_plain`. Consumed by ``ops/cuda_lqr.py
    admm_epoch_batched`` (kernel and twin).
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


def _epoch_data(qp: StageQP, rho, rho_scale, reg):
    """What every epoch derives before its iterations: the effective
    per-row rho ``rv``, the factorisation of the rho-augmented cost and the
    soft-row prox shrink factors, packed as :class:`ADMMEpochData`; the
    factors are returned as well for the Cholesky-based affine solves."""
    dtype, dev = qp.lo.dtype, qp.lo.device
    P, _, mr = qp.lo.shape
    rho_scale = torch.as_tensor(rho_scale, dtype=dtype, device=dev)
    rho_scale = torch.broadcast_to(rho_scale, (P, mr))
    mask = _active_rows(qp)
    rv = rho * mask * rho_scale[:, None, :]
    slo, shi = _soft(qp, qp.soft_lo), _soft(qp, qp.soft_hi)
    aug_cost = build_admm_cost(qp, rv)
    fac = lqr_factorize(qp.dyn, aug_cost, reg)
    rv_safe = torch.where(rv > 0, rv, torch.ones_like(rv))
    zero = torch.zeros_like(rv)
    fac_lo = torch.where(torch.isinf(slo), zero, rv_safe / (rv_safe + 2.0 * slo))
    fac_hi = torch.where(torch.isinf(shi), zero, rv_safe / (rv_safe + 2.0 * shi))
    nc = qp.dyn.G.shape[-1]
    eye = torch.eye(nc, dtype=dtype, device=dev).expand(fac.Quu_chol.shape)
    data = ADMMEpochData(
        F=qp.dyn.F, G=qp.dyn.G, d=qp.dyn.d,
        K=fac.K, Quu_inv=torch.cholesky_solve(eye, fac.Quu_chol),
        Qxu=fac.Qxu, m=fac.m, q=aug_cost.q, r=aug_cost.r,
        D=qp.D * mask[..., None], E=qp.E * mask[..., None],
        lo=qp.lo, hi=qp.hi, rv=rv, fac_lo=fac_lo, fac_hi=fac_hi)
    return data, fac


def admm_epoch_inputs_plain(qp: StageQP, rho: float = 10.0,
                            rho_scale=1.0, reg: float = 1e-8
                            ) -> ADMMEpochData:
    """Plain version of :func:`admm_epoch_inputs` on any device: batched
    torch around ``ops/lqr.py lqr_factorize``. Every field is contiguous,
    as the epoch kernel takes it."""
    data, _ = _epoch_data(qp, rho, rho_scale, reg)
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

    Every epoch is the plain data and the plain sequential epoch;
    ``assoc`` is taken and ignored.
    """
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
        data = admm_epoch_inputs_plain(qp, rho, rho_scale, reg)
        z_e, c_e, w_e, y_e, rp_e, rd_e = admm_epoch_batched_plain(
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
