# Frozen copy of the port's plain path: colaborativempc_tpu_torch/dynamics/pacejka.py
# as the racing cell was added, unchanged.
"""Dynamic bicycle model with Pacejka magic-formula tires (PyTorch port).

Twin of ``colaborativempc_tpu/dynamics/pacejka.py`` (reference
``Matlab-tests/MPCC-master/C++/Model/model.cpp:42-71``, constraints
``Constraints/constraints.cpp:57,117``) on the 9-state Frenet/Cartesian
layout [vx, vy, wz, ey, epsi, theta, s, X, Y] with input [delta, D]. Every
function works elementwise over leading batch axes: ``x (..., 9)``,
``u (..., 2)``, ``kappa (...)``. The Jacobians of ``linearize_pacejka`` and
``tire_row_jacobians`` come from ``torch.func.jacfwd`` under
``torch.func.vmap`` (forward-mode autodiff, as ``jax.jacfwd`` in JAX).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PacejkaParams(NamedTuple):
    """Magic-formula + drivetrain parameters (MPCC-master model.cpp naming,
    defaults scaled to the 1:43 car the reference targets)."""
    m: float = 0.041
    I: float = 27.8e-6
    lf: float = 0.029
    lr: float = 0.033
    # front/rear magic formula
    Bf: float = 2.579
    Cf: float = 1.2
    Df: float = 0.192
    Br: float = 3.3852
    Cr: float = 1.2691
    Dr: float = 0.1737
    # drivetrain / friction
    Cm1: float = 0.287
    Cm2: float = 0.0545
    Cr0: float = 0.0518
    Cr2: float = 0.00035
    # friction-ellipse shape (constraints.cpp)
    p_long: float = 0.9
    p_ell: float = 0.95
    max_alpha: float = 0.6  # front slip-angle bound [rad]


def slip_angles(x: torch.Tensor, u: torch.Tensor, p: PacejkaParams):
    """Front/rear slip angles (model.cpp getSlipAngleFront/Rear); vx is
    floored at 0.3 (the vxNonZero guard, types.h:62-83)."""
    vx = torch.maximum(x[..., 0], torch.full_like(x[..., 0], 0.3))
    af = -torch.atan2(x[..., 1] + p.lf * x[..., 2], vx) + u[..., 0]
    ar = -torch.atan2(x[..., 1] - p.lr * x[..., 2], vx)
    return af, ar


def tire_forces(x: torch.Tensor, u: torch.Tensor, p: PacejkaParams):
    """(F_fy, F_ry, F_rx): magic-formula lateral forces + drivetrain."""
    af, ar = slip_angles(x, u, p)
    F_fy = p.Df * torch.sin(p.Cf * torch.atan(p.Bf * af))
    F_ry = p.Dr * torch.sin(p.Cr * torch.atan(p.Br * ar))
    vx = x[..., 0]
    F_rx = p.Cm1 * u[..., 1] - p.Cm2 * u[..., 1] * vx - p.Cr0 - p.Cr2 * vx * vx
    return F_fy, F_ry, F_rx


def f_continuous_pacejka(x: torch.Tensor, u: torch.Tensor, kappa,
                         p: PacejkaParams) -> torch.Tensor:
    """Nonlinear dynamics x' = f(x, u) (body dynamics from model.cpp getF;
    Frenet kinematics shared with the linear-tire model)."""
    vx, vy, wz = x[..., 0], x[..., 1], x[..., 2]
    ey, epsi, theta = x[..., 3], x[..., 4], x[..., 5]
    delta = u[..., 0]
    F_fy, F_ry, F_rx = tire_forces(x, u, p)

    dvx = (F_rx - F_fy * torch.sin(delta) + p.m * vy * wz) / p.m
    dvy = (F_ry + F_fy * torch.cos(delta) - p.m * vx * wz) / p.m
    dwz = (F_fy * p.lf * torch.cos(delta) - F_ry * p.lr) / p.I

    se, ce = torch.sin(epsi), torch.cos(epsi)
    st, ct = torch.sin(theta), torch.cos(theta)
    den = 1.0 - ey * kappa
    dey = se * vx + ce * vy
    depsi = (-ce * kappa / den) * vx + (se * kappa / den) * vy + wz
    dtheta = wz
    ds = (ce / den) * vx + (-se / den) * vy
    dX = ct * vx - st * vy
    dY = st * vx + ct * vy
    return torch.stack([dvx, dvy, dwz, dey, depsi, dtheta, ds, dX, dY], dim=-1)


def friction_ellipse_residual(x: torch.Tensor, u: torch.Tensor,
                              p: PacejkaParams) -> torch.Tensor:
    """Rear-tire friction ellipse value; feasible when <= 0
    (constraints.cpp:57: (p_long F_rx)^2 + F_ry^2 <= (p_ell Dr)^2)."""
    _, F_ry, F_rx = tire_forces(x, u, p)
    return (p.p_long * F_rx) ** 2 + F_ry ** 2 - (p.p_ell * p.Dr) ** 2


def slip_angle_residuals(x: torch.Tensor, u: torch.Tensor,
                         p: PacejkaParams) -> torch.Tensor:
    """Front slip-angle box residuals ``(..., 2)``; feasible when both <= 0
    (constraints.cpp:117: |alpha_f| <= max_alpha)."""
    af, _ = slip_angles(x, u, p)
    return torch.stack([af - p.max_alpha, -p.max_alpha - af], dim=-1)


def _batched_jacobians(f, x, u, *extra):
    """Jacobians of ``f(x, u, *extra)`` with respect to x and u at every
    point of the leading batch axes: ``(..., out, 9)`` and ``(..., out, 2)``
    (a scalar output gives ``(..., 9)`` and ``(..., 2)``)."""
    from torch.func import jacfwd, vmap
    batch = x.shape[:-1]
    flat = [x.reshape(-1, x.shape[-1]), u.reshape(-1, u.shape[-1])]
    flat += [torch.broadcast_to(e, batch).reshape(-1) for e in extra]
    jx, ju = vmap(jacfwd(f, argnums=(0, 1)))(*flat)
    # forward-mode tangents of a 0-dim tensor times a Python float come back
    # in float64; the Jacobians take the inputs' dtype
    return (jx.reshape(batch + jx.shape[1:]).to(x.dtype),
            ju.reshape(batch + ju.shape[1:]).to(x.dtype))


def linearize_pacejka(x: torch.Tensor, u: torch.Tensor, kappa,
                      p: PacejkaParams, dt):
    """Discrete ``(Ad (..., 9, 9), Bd (..., 9, 2), rd (..., 9))`` of the
    Euler-discretised Pacejka dynamics at ``(x, u)``, so that
    ``fd(x', u') ~ Ad x' + Bd u' + rd`` (the reference hand-derives these
    Jacobians, model.cpp:73-160+)."""
    kappa = torch.as_tensor(kappa, dtype=x.dtype, device=x.device)

    def fd(xx, uu, kk):
        return xx + dt * f_continuous_pacejka(xx, uu, kk, p)

    Ad, Bd = _batched_jacobians(fd, x, u, kappa)
    rd = (fd(x, u, kappa) - (Ad @ x[..., None])[..., 0]
          - (Bd @ u[..., None])[..., 0])
    return Ad, Bd, rd


def tire_row_jacobians(x: torch.Tensor, u: torch.Tensor, p: PacejkaParams):
    """The three tire-constraint residuals (friction ellipse, two slip-angle
    rows) ``(..., 3)`` and their Jacobians ``(..., 3, 9)``, ``(..., 3, 2)``
    at ``(x, u)`` — the linearised rows of the MPCC stage QP."""
    def rows(xx, uu):
        return torch.cat([friction_ellipse_residual(xx, uu, p)[..., None],
                          slip_angle_residuals(xx, uu, p)], dim=-1)

    gx, gu = _batched_jacobians(rows, x, u)
    return rows(x, u), gx, gu
