# Frozen copy of the port's plain path: colaborativempc_tpu_torch/ops/lqr.py
# as of the benchmark's first version, imports made relative.
"""Stage-structured equality-constrained QP (LQR) solves via Riccati sweeps
(PyTorch port).

Twin of ``colaborativempc_tpu/ops/lqr.py``: the backward Riccati pass over
the quadratic terms (``lqr_factorize``) runs once per ADMM epoch, and the
cheap affine backward/forward sweeps (``lqr_affine_solve``, or the
associative ``lqr_affine_solve_assoc``) reuse it with new linear terms.
Every array carries a leading batch axis P (the JAX functions are per
problem and vmapped); ``lax.scan`` over stages is a Python loop of batched
``(P, nz, nz)`` products.

``lqr_factorize`` is plain batched torch, as it was plain XLA in JAX. On
the card the ADMM epoch does not call it: its factorisation is the CUDA
kernel ``ops/cuda_lqr.py epoch_data_batched`` (``csrc/epoch_data.cu``),
and ``lqr_factorize`` is that kernel's plain version's (``ops/admm.py
admm_epoch_inputs_plain``), run on CPU tensors and by the associative
epoch. The nc x nc ``Quu`` factor uses ``torch.linalg.cholesky_ex`` (no
host sync to check for errors, unlike ``torch.linalg.cholesky``) and
``torch.cholesky_solve``; a ``Quu`` that is not positive definite gives a
NaN factor, as JAX's ``cholesky`` does.

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
    # JAX's cholesky of a matrix that is not positive definite: NaN below
    # the diagonal, 0 above (cholesky_ex leaves a partial factor instead)
    failed = torch.full_like(eye, torch.nan).tril()
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
        L, info = torch.linalg.cholesky_ex(Quu)
        L = torch.where((info != 0)[:, None, None], failed, L)
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


def _affine_scan(M: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
                 reverse: bool = False, block: int | None = 8) -> torch.Tensor:
    """All states of the affine recurrences ``x_{k+1} = M_k x_k + b_k``
    (``M (P, N, n, n)``, ``b (P, N, n)``, ``x0 (P, n)``), returned as
    ``(P, N+1, n)`` with x0 first; ``reverse=True`` runs ``x_k = M_k x_{k+1}
    + b_k`` from ``x_N = x0``, returned with x_N last.

    The blocked hybrid of the JAX ``_affine_scan``: prefix composites of
    the maps are formed only within blocks of ``block`` stages (log-step
    Hillis-Steele products, so no composed product spans more than
    ``block`` maps — the float32 conditioning rule of the JAX docstring),
    and the state is carried sequentially across blocks, one batched
    matvec per block. N is padded with identity maps to a whole number of
    blocks. ``block=None`` composes over the whole horizon.
    """
    if reverse:
        M, b = M.flip(1), b.flip(1)
    P, N, n = M.shape[0], M.shape[1], M.shape[-1]
    if block is None or block >= N:
        block = N
    nb = -(-N // block)
    pad = nb * block - N
    if pad:
        eye = torch.eye(n, dtype=M.dtype, device=M.device)
        M = torch.cat([M, eye.expand(P, pad, n, n)], dim=1)
        b = torch.cat([b, b.new_zeros((P, pad, n))], dim=1)
    C = M.reshape(P, nb, block, n, n)
    d = b.reshape(P, nb, block, n)
    off = 1
    while off < block:
        # composite from the block start: e_j <- e_j o e_{j-off}
        Cj, dj = C[:, :, off:], d[:, :, off:]
        C = torch.cat([C[:, :, :off], Cj @ C[:, :, :-off]], dim=2)
        d = torch.cat([d[:, :, :off], _mv(Cj, d[:, :, :-off]) + dj], dim=2)
        off *= 2
    x, xs = x0, [x0[:, None]]
    for j in range(nb):
        xb = _mv(C[:, j], x[:, None]) + d[:, j]          # (P, block, n)
        xs.append(xb)
        x = xb[:, -1]
    out = torch.cat(xs, dim=1)[:, :N + 1]
    return out.flip(1) if reverse else out


def lqr_affine_solve_assoc(dyn: LQRDynamics, fac: LQRFactors,
                           q: torch.Tensor, r: torch.Tensor, z0: torch.Tensor,
                           block: int | None = 8):
    """Parallel-in-horizon affine solve (JAX ``lqr_affine_solve_assoc``):
    the costate recursion ``p_k = Acl_k' p_{k+1} + c_k`` and the closed-loop
    rollout ``z_{k+1} = Acl_k z_k + G_k kff_k + d_k`` are affine recurrences
    in the factorised system, each one :func:`_affine_scan`. Same output as
    :func:`lqr_affine_solve` up to rounding; ``block`` bounds the composed
    span (8 keeps float32 sound at N=125 under large ADMM penalties)."""
    AclT = fac.Acl.transpose(-1, -2)
    Kr = -torch.cholesky_solve(r[..., None], fac.Quu_chol)[..., 0]  # Quu^-1 r
    c = q[:, :-1] + _mv(AclT, fac.m) + _mv(fac.Qxu, Kr)
    p = _affine_scan(AclT, c, q[:, -1], reverse=True, block=block)
    t = p[:, 1:] + fac.m
    Qu = r + _mv(dyn.G.transpose(-1, -2), t)
    kff = -torch.cholesky_solve(Qu[..., None], fac.Quu_chol)[..., 0]
    z = _affine_scan(fac.Acl, _mv(dyn.G, kff) + dyn.d, z0, block=block)
    return z, _mv(fac.K, z[:, :-1]) + kff


def lqr_solve(dyn: LQRDynamics, cost: LQRCost, z0: torch.Tensor,
              reg: float = 1e-8, assoc: bool = False):
    """One-shot equality-constrained solve (factorise + affine + rollout)."""
    fac = lqr_factorize(dyn, cost, reg)
    solve = lqr_affine_solve_assoc if assoc else lqr_affine_solve
    return solve(dyn, fac, cost.q, cost.r, z0)
