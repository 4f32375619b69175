# Frozen copy of the port's plain path: colaborativempc_tpu_torch/dynamics/bicycle.py
# as of the benchmark's first version, imports made relative.
"""9-state mixed Frenet/Cartesian bicycle model (PyTorch port).

Twin of ``colaborativempc_tpu/dynamics/bicycle.py``. State layout
``x = [vx, vy, wz, ey, epsi, theta, s, X, Y]``, inputs ``u = [delta, a]``.
Every function takes any number of leading batch axes (the JAX versions are
per stage and vmapped).
"""

from __future__ import annotations

import torch

from .config import ModelParams

NX = 9   # states
NU = 2   # inputs
LOW_VEL_THRESH = 0.2  # reference LPV_Planner.py:505


def lpv_coeffs(x: torch.Tensor, u: torch.Tensor, kappa, p: ModelParams):
    """Velocity/steering-scheduled entries of the LPV A, B matrices; the
    low-velocity switch (vx < 0.2) zeroes the 1/vx tire terms (reference
    LPV_Planner.py:505-531)."""
    vx, vy, ey, epsi, theta = (x[..., 0], x[..., 1], x[..., 3], x[..., 4],
                               x[..., 5])
    delta = u[..., 0]

    low = vx < LOW_VEL_THRESH
    vx_safe = torch.where(low, torch.ones_like(vx), vx)

    sd, cd = torch.sin(delta), torch.cos(delta)
    se, ce = torch.sin(epsi), torch.cos(epsi)
    st, ct = torch.sin(theta), torch.cos(theta)
    den = 1.0 - ey * kappa

    def gate(v):
        return torch.where(low, torch.zeros_like(v), v)

    return dict(
        A12=gate(sd * p.Cf / (p.m * vx_safe)),
        A13=gate(sd * p.Cf * p.lf / (p.m * vx_safe) + vy),
        A22=gate(-(p.Cr + p.Cf * cd) / (p.m * vx_safe)),
        A23=gate(-(p.lf * p.Cf * cd - p.lr * p.Cr) / (p.m * vx_safe) - vx),
        A32=gate(-(p.lf * p.Cf * cd - p.lr * p.Cr) / (p.I * vx_safe)),
        A33=gate(-(p.lf ** 2 * p.Cf * cd + p.lr ** 2 * p.Cr) / (p.I * vx_safe)),
        B11=gate(-sd * p.Cf / p.m),
        A41=se, A42=ce,
        A51=-ce * kappa / den, A52=se * kappa / den,
        A61=ce / den, A62=-se / den,
        A81=ct, A82=-st,
        A91=st, A92=ct,
        B21=cd * p.Cf / p.m,
        B31=p.lf * p.Cf * cd / p.I,
    )


# (row, col) of every scheduled entry; the constant entries are set below
_A_ENTRIES = {
    "A12": (0, 1), "A13": (0, 2), "A22": (1, 1), "A23": (1, 2),
    "A32": (2, 1), "A33": (2, 2), "A41": (3, 0), "A42": (3, 1),
    "A51": (4, 0), "A52": (4, 1), "A61": (6, 0), "A62": (6, 1),
    "A81": (7, 0), "A82": (7, 1), "A91": (8, 0), "A92": (8, 1),
}
_B_ENTRIES = {"B11": (0, 0), "B21": (1, 0), "B31": (2, 0)}


def lpv_matrices(x: torch.Tensor, u: torch.Tensor, kappa, p: ModelParams):
    """Continuous-time LPV ``(A (..., 9, 9), B (..., 9, 2))`` at operating
    point (x, u, kappa); ``f(x, u) = A x + B u`` exactly (reference
    LPV_Planner.py:552-571)."""
    c = lpv_coeffs(x, u, kappa, p)
    batch = x.shape[:-1]
    A = x.new_zeros(batch + (NX, NX))
    B = x.new_zeros(batch + (NX, NU))
    A[..., 0, 0] = -p.mu
    A[..., 4, 2] = 1.0
    A[..., 5, 2] = 1.0
    B[..., 0, 1] = 1.0
    for k, (i, j) in _A_ENTRIES.items():
        A[..., i, j] = c[k]
    for k, (i, j) in _B_ENTRIES.items():
        B[..., i, j] = c[k]
    return A, B


def f_continuous(x: torch.Tensor, u: torch.Tensor, kappa, p: ModelParams):
    """Nonlinear continuous dynamics x' = f(x, u, kappa), via the exact LPV
    embedding."""
    A, B = lpv_matrices(x, u, kappa, p)
    return (A @ x[..., None])[..., 0] + (B @ u[..., None])[..., 0]


def discretize_euler(A: torch.Tensor, B: torch.Tensor, dt):
    """Forward-Euler discretisation (reference LPV_Planner.py:583-585)."""
    eye = torch.eye(NX, dtype=A.dtype, device=A.device)
    return eye + dt * A, dt * B


def lpv_discrete_horizon(states: torch.Tensor, inputs: torch.Tensor,
                         kappas: torch.Tensor, dt, p: ModelParams):
    """Discrete LPV matrices along a horizon: states ``(..., N, 9)``, inputs
    ``(..., N, 2)``, kappas ``(..., N)`` -> Ad ``(..., N, 9, 9)``, Bd
    ``(..., N, 9, 2)`` (reference ``_EstimateABC``, LPV_Planner.py:477-591)."""
    A, B = lpv_matrices(states, inputs, kappas, p)
    return discretize_euler(A, B, dt)


def step_euler(x, u, kappa, dt, p: ModelParams):
    return x + dt * f_continuous(x, u, kappa, p)


def step_rk4(x, u, kappa, dt, p: ModelParams):
    """Classic RK4 with curvature held over the step (plant simulation;
    native reference analogue integrator.cpp:29-43)."""
    k1 = f_continuous(x, u, kappa, p)
    k2 = f_continuous(x + 0.5 * dt * k1, u, kappa, p)
    k3 = f_continuous(x + 0.5 * dt * k2, u, kappa, p)
    k4 = f_continuous(x + dt * k3, u, kappa, p)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
