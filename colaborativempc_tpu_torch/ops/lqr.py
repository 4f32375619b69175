"""Stage-structured equality-constrained QP (LQR) solves via Riccati sweeps
(PyTorch port, sequential path).

Twin of ``colaborativempc_tpu/ops/lqr.py``: the backward Riccati pass over
the quadratic terms (``lqr_factorize``) runs once per ADMM epoch, and the
cheap affine backward/forward sweeps (``lqr_affine_solve``) reuse it with
new linear terms. Every array carries a leading batch axis P (the JAX
functions are per problem and vmapped); ``lax.scan`` over stages is a
Python loop of batched ``(P, nz, nz)`` products.

The factorisation is plain batched torch, as it was plain XLA in JAX. The
2x2 ``Quu`` factor uses ``torch.linalg.cholesky_ex`` (no host sync to check
for errors, unlike ``torch.linalg.cholesky``) and ``torch.cholesky_solve``.

Problem (z = state, c = control):

    min  sum_k 1/2 z_k'Q_k z_k + q_k'z_k + 1/2 c_k'R_k c_k + r_k'c_k
              + z_k'S_k c_k                      (k = 0..N-1, + terminal N)
    s.t. z_{k+1} = F_k z_k + G_k c_k + d_k,  z_0 given.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LQRCost(NamedTuple):
    """Stagewise quadratic cost. Q/q have N+1 entries (terminal included)."""
    Q: torch.Tensor   # (P, N+1, nz, nz)
    q: torch.Tensor   # (P, N+1, nz)
    R: torch.Tensor   # (P, N, nc, nc)
    r: torch.Tensor   # (P, N, nc)
    S: torch.Tensor   # (P, N, nz, nc) cross term


class LQRDynamics(NamedTuple):
    F: torch.Tensor   # (P, N, nz, nz)
    G: torch.Tensor   # (P, N, nz, nc)
    d: torch.Tensor   # (P, N, nz)


class LQRFactors(NamedTuple):
    """Output of the quadratic backward pass, reused across affine solves."""
    K: torch.Tensor         # (P, N, nc, nz) feedback gains
    Quu_chol: torch.Tensor  # (P, N, nc, nc) Cholesky factors of Quu
    Qxu: torch.Tensor       # (P, N, nz, nc)
    m: torch.Tensor         # (P, N, nz)  P_{k+1} d_k
    P0: torch.Tensor        # (P, nz, nz) value Hessian at k=0 (diagnostics)
    Acl: torch.Tensor       # (P, N, nz, nz) closed loop F + G K


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _mv(A, x):
    """Batched matrix-vector product ``A (..., i, j) @ x (..., j)``."""
    return (A @ x[..., None])[..., 0]


def lqr_factorize(dyn: LQRDynamics, cost: LQRCost,
                  reg: float = 1e-8) -> LQRFactors:
    """Backward Riccati pass over the quadratic terms only."""
    N = dyn.F.shape[1]
    nc = dyn.G.shape[-1]
    eye = torch.eye(nc, dtype=dyn.F.dtype, device=dyn.F.device)
    P = cost.Q[:, N]
    Ks, Ls, Qxus, ms = [None] * N, [None] * N, [None] * N, [None] * N
    for k in range(N - 1, -1, -1):
        F, G = dyn.F[:, k], dyn.G[:, k]
        FT = F.transpose(-1, -2)
        PF = P @ F
        PG = P @ G
        Qxx = cost.Q[:, k] + FT @ PF
        Quu = cost.R[:, k] + G.transpose(-1, -2) @ PG
        Qxu = cost.S[:, k] + FT @ PG
        Quu = _sym(Quu) + reg * eye
        L, _ = torch.linalg.cholesky_ex(Quu)
        K = -torch.cholesky_solve(Qxu.transpose(-1, -2), L)
        ms[k] = _mv(P, dyn.d[:, k])
        P = _sym(Qxx + Qxu @ K)
        Ks[k], Ls[k], Qxus[k] = K, L, Qxu
    K = torch.stack(Ks, 1)
    Acl = dyn.F + dyn.G @ K
    return LQRFactors(K=K, Quu_chol=torch.stack(Ls, 1),
                      Qxu=torch.stack(Qxus, 1), m=torch.stack(ms, 1),
                      P0=P, Acl=Acl)


def lqr_affine_solve(dyn: LQRDynamics, fac: LQRFactors,
                     q: torch.Tensor, r: torch.Tensor, z0: torch.Tensor):
    """Optimal trajectory for (possibly new) linear terms ``q (P, N+1, nz)``,
    ``r (P, N, nc)`` from ``z0 (P, nz)``. Returns ``z (P, N+1, nz)``,
    ``c (P, N, nc)``."""
    N = dyn.F.shape[1]
    p = q[:, N]
    kff = [None] * N
    for k in range(N - 1, -1, -1):
        t = p + fac.m[:, k]
        Qu = r[:, k] + _mv(dyn.G[:, k].transpose(-1, -2), t)
        kff[k] = -torch.cholesky_solve(Qu[..., None], fac.Quu_chol[:, k])[..., 0]
        p = (q[:, k] + _mv(dyn.F[:, k].transpose(-1, -2), t)
             + _mv(fac.Qxu[:, k], kff[k]))
    zs, cs = [z0], []
    z = z0
    for k in range(N):
        c = _mv(fac.K[:, k], z) + kff[k]
        z = _mv(dyn.F[:, k], z) + _mv(dyn.G[:, k], c) + dyn.d[:, k]
        zs.append(z)
        cs.append(c)
    return torch.stack(zs, 1), torch.stack(cs, 1)


def lqr_solve(dyn: LQRDynamics, cost: LQRCost, z0: torch.Tensor,
              reg: float = 1e-8, assoc: bool = False):
    """One-shot equality-constrained solve (factorise + affine + rollout)."""
    if assoc:
        raise NotImplementedError(
            "the associative-scan affine solve is not ported yet")
    fac = lqr_factorize(dyn, cost, reg)
    return lqr_affine_solve(dyn, fac, cost.q, cost.r, z0)
