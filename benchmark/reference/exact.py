"""Answers of the plain reference worked out a second way, in float64
NumPy from the problems' statements alone, that the tests hold the frozen
copy (``benchmark/reference/cmpc``) to:

- :func:`stage_qp_optimum`: the optimum of one stage QP as
  ``cmpc/admm.py`` states it (stage costs, dynamics, per-stage rows with
  hard bounds or soft ones whose violation ``v`` costs ``weight * v**2``),
  by eliminating the states and running a dense primal-dual
  interior-point method with Mehrotra's corrector, nothing of ADMM, Riccati
  or the copy's code;
- :func:`bicycle_rhs`: the dynamic bicycle with linear tyres written from
  its forces, against the copy's LPV embedding.
"""

from __future__ import annotations

import numpy as np


def _np(t) -> np.ndarray:
    return t.detach().cpu().double().numpy() if hasattr(t, "detach") \
        else np.asarray(t, np.float64)


def dense_stage_qp(qp, p: int, z0):
    """Problem ``p`` of a batched ``StageQP`` with its states eliminated:
    ``(H, g, M, v0, lo, hi, soft_lo, soft_hi, Zc, ze)`` where the controls
    ``c`` (stacked, ``N * nc``) give the states ``z = Zc c + ze`` (``(N +
    1) * nz``), the cost ``1/2 c'Hc + g'c`` (plus a constant) and the rows
    ``v = M c + v0``."""
    F, G, d = (_np(t[p]) for t in qp.dyn)
    Q, q, R, r, S = (_np(t[p]) for t in qp.cost)
    D, E, lo, hi = (_np(t[p]) for t in (qp.D, qp.E, qp.lo, qp.hi))
    inf = np.full_like(lo, np.inf)
    slo = inf if qp.soft_lo is None else _np(qp.soft_lo[p])
    shi = inf if qp.soft_hi is None else _np(qp.soft_hi[p])
    N, nz, nc = G.shape
    n = N * nc
    Zc = np.zeros((N + 1, nz, n))
    ze = np.zeros((N + 1, nz))
    ze[0] = _np(z0)
    sel = np.zeros((N, nc, n))
    for k in range(N):
        sel[k, :, k * nc:(k + 1) * nc] = np.eye(nc)
        Zc[k + 1] = F[k] @ Zc[k] + G[k] @ sel[k]
        ze[k + 1] = F[k] @ ze[k] + d[k]
    H = np.zeros((n, n))
    g = np.zeros(n)
    for k in range(N + 1):
        H += Zc[k].T @ Q[k] @ Zc[k]
        g += Zc[k].T @ (Q[k] @ ze[k] + q[k])
    for k in range(N):
        H += sel[k].T @ R[k] @ sel[k]
        cross = Zc[k].T @ S[k] @ sel[k]
        H += cross + cross.T
        g += sel[k].T @ (r[k] + S[k].T @ ze[k])
    M = np.concatenate([D[k] @ Zc[k] + E[k] @ sel[k] for k in range(N)])
    v0 = np.concatenate([D[k] @ ze[k] for k in range(N)])
    return (0.5 * (H + H.T), g, M, v0, lo.reshape(-1), hi.reshape(-1),
            slo.reshape(-1), shi.reshape(-1), Zc, ze)


def _inequalities(n, M, v0, lo, hi, slo, shi):
    """``A x <= b`` over ``x = [c; t]`` and the slack weights: a hard
    bound is a row of ``v``; a soft one a row of ``v - t`` with ``t >=
    0``, ``t`` costing ``weight * t**2``."""
    rows, rhs, weights = [], [], []

    def add(a_c, j_t, b):
        rows.append((a_c, j_t))
        rhs.append(b)

    for j in range(M.shape[0]):
        for sign, bound, w in ((1.0, hi[j], shi[j]), (-1.0, lo[j], slo[j])):
            if not np.isfinite(bound):
                continue
            if np.isfinite(w):
                weights.append(w)
                add(sign * M[j], len(weights) - 1, sign * (bound - v0[j]))
            else:
                add(sign * M[j], None, sign * (bound - v0[j]))
    nt = len(weights)
    A = np.zeros((len(rows) + nt, n + nt))
    b = np.zeros(len(rows) + nt)
    for i, ((a_c, j_t), bi) in enumerate(zip(rows, rhs)):
        A[i, :n] = a_c
        if j_t is not None:
            A[i, n + j_t] = -1.0
        b[i] = bi
    for i in range(nt):                      # t >= 0
        A[len(rows) + i, n + i] = -1.0
    return A, b, np.asarray(weights, np.float64)


def _ipm(P, p, A, b, tol=1e-11, max_it=200):
    """``min 1/2 x'Px + p'x`` subject to ``A x <= b`` (``P`` positive
    definite): primal-dual interior point, Mehrotra predictor-corrector."""
    n, m = P.shape[0], A.shape[0]
    x, s, lam = np.zeros(n), np.ones(m), np.ones(m)
    scale = 1.0 + max(np.abs(p).max(initial=0.0), np.abs(b).max(initial=0.0))

    def solve(rd, rp, rc):
        W = lam / s
        K = P + A.T @ (W[:, None] * A)
        dx = np.linalg.solve(K, -rd - A.T @ (W * rp - rc / s))
        dlam = W * (A @ dx + rp) - rc / s
        ds = -(rc + s * dlam) / lam
        return dx, ds, dlam

    def longest(v, dv):
        neg = dv < 0
        return min(1.0, float(np.min(-v[neg] / dv[neg]))) if neg.any() \
            else 1.0

    for _ in range(max_it):
        rd = P @ x + p + A.T @ lam
        rp = A @ x + s - b
        mu = float(s @ lam) / m
        if max(np.abs(rd).max(), np.abs(rp).max(), mu) < tol * scale:
            return x
        dx, ds, dl = solve(rd, rp, s * lam)
        a = min(longest(s, ds), longest(lam, dl))
        mu_aff = float((s + a * ds) @ (lam + a * dl)) / m
        sigma = (mu_aff / mu) ** 3
        dx, ds, dl = solve(rd, rp, s * lam + ds * dl - sigma * mu)
        a = min(1.0, 0.99 * min(longest(s, ds), longest(lam, dl)))
        x, s, lam = x + a * dx, s + a * ds, lam + a * dl
    raise RuntimeError("interior point did not converge")


def stage_qp_optimum(qp, p: int, z0):
    """The optimum ``(z (N + 1, nz), c (N, nc))`` of problem ``p`` of a
    batched ``StageQP`` from ``z0 (nz,)``, float64."""
    H, g, M, v0, lo, hi, slo, shi, Zc, ze = dense_stage_qp(qp, p, z0)
    n = H.shape[0]
    A, b, w = _inequalities(n, M, v0, lo, hi, slo, shi)
    P = np.zeros((n + w.size, n + w.size))
    P[:n, :n] = H
    P[n:, n:] = np.diag(2.0 * w)
    x = _ipm(P, np.concatenate([g, np.zeros(w.size)]), A, b)
    c = x[:n]
    z = Zc @ c + ze
    N, nc = Zc.shape[0] - 1, n // (Zc.shape[0] - 1)
    return z, c.reshape(N, nc)


def bicycle_rhs(x, u, kappa, m, I, lf, lr, Cf, Cr, mu, low_vel=0.2):
    """``dx/dt`` of the 9-state bicycle ``[vx, vy, wz, ey, epsi, theta, s,
    X, Y]`` under ``u = [delta, a]`` on a path of curvature ``kappa``:
    linear tyres (front force ``Cf`` times its slip angle, rear ``Cr``),
    rolling drag ``mu vx``, the body's rotating frame, the Frenet and the
    Cartesian kinematics. Below ``low_vel`` m/s the slip angles (which
    divide by ``vx``) are not defined: the front tyre then pushes
    ``Cf delta`` along the wheel's normal, the rear none, and the frame's
    rotation terms are dropped (the reference's low-speed switch)."""
    vx, vy, wz, ey, epsi, theta = (x[..., i] for i in range(6))
    delta, a = u[..., 0], u[..., 1]
    fast = vx >= low_vel
    vxs = np.where(fast, vx, 1.0)
    Ff = Cf * (delta - np.where(fast, (vy + lf * wz) / vxs, 0.0))
    Fr = np.where(fast, -Cr * (vy - lr * wz) / vxs, 0.0)
    rot = np.where(fast, 1.0, 0.0)
    dvx = a - mu * vx - rot * Ff * np.sin(delta) / m + rot * wz * vy
    dvy = (Ff * np.cos(delta) + Fr) / m - rot * wz * vx
    dwz = (lf * Ff * np.cos(delta) - lr * Fr) / I
    along = (vx * np.cos(epsi) - vy * np.sin(epsi)) / (1.0 - ey * kappa)
    return np.stack([
        dvx, dvy, dwz,
        vx * np.sin(epsi) + vy * np.cos(epsi),
        wz - kappa * along,
        wz,
        along,
        vx * np.cos(theta) - vy * np.sin(theta),
        vx * np.sin(theta) + vy * np.cos(theta)], axis=-1)
