"""Fleet initialisation and warm-start trajectory generation (PyTorch port).

Twin of ``colaborativempc_tpu/utils/warmstart.py`` (reference
``utilities/misc.py:155-210``): a constant-acceleration straight-ahead
rollout in Frenet coordinates that seeds the first MPC solve.
"""

from __future__ import annotations

import torch

from colaborativempc_tpu_torch.geometry import Track, frenet_to_cartesian


def warmstart_trajectory(track: Track, x0: torch.Tensor, N: int, dt,
                         accel: float = 1.0, accel_rate: float = 0.0,
                         lane=0):
    """``(..., N+1, 9)`` states and ``(..., N, 2)`` inputs from ``x0 (..., 9)``.

    Holds vy, wz, ey, epsi, integrates vx with a constant acceleration ramp
    and s with the running vx, then fills (X, Y, theta) from the track —
    including the reference's quirk of evaluating stage k+1's pose at the
    previous stage's s (misc.py:206). ``lane``: int, or a tensor of shape
    ``x0.shape[:-1]``.
    """
    dtype, dev = x0.dtype, x0.device
    batch = x0.shape[:-1]
    vx0 = x0[..., 0:1]
    ks = torch.arange(N, dtype=dtype, device=dev)
    acc = accel + accel_rate * ks
    vx = torch.cat([vx0, vx0 + dt * torch.cumsum(acc, 0)], dim=-1)
    # respects x0[6] (the reference zeroes S[0], misc.py:175) so staggered
    # platoon starts stay separated
    s = x0[..., 6:7] + torch.cat(
        [torch.zeros(batch + (1,), dtype=dtype, device=dev),
         dt * torch.cumsum(vx[..., :-1], -1)], dim=-1)
    ey = x0[..., 3:4].expand(batch + (N + 1,))
    s_pose = torch.cat([s[..., :1], s[..., :-1]], dim=-1)
    X, Y, Theta = frenet_to_cartesian(track, s_pose, ey, lane)

    def const(j):
        return x0[..., j:j + 1].expand(batch + (N + 1,))

    states = torch.stack([vx, const(1), const(2), ey, const(4), Theta, s,
                          X, Y], dim=-1)
    inputs = torch.zeros(batch + (N, 2), dtype=dtype, device=dev)
    return states, inputs


def initialise_agents(track: Track, x0s: torch.Tensor, N: int, dt,
                      accel_rate: float = 0.0, lane=0):
    """Warm-start every agent (reference misc.py:155-165).

    ``x0s (n_agents, 9)`` -> ``agents_xy (N+1, n_agents, 2)`` (the exchange
    tensor), ``x_pred (n_agents, N+1, 9)``, ``u_pred (n_agents, N, 2)``.
    """
    x_pred, u_pred = warmstart_trajectory(track, x0s, N, dt,
                                          accel_rate=accel_rate, lane=lane)
    agents_xy = x_pred[:, :, 7:9].transpose(0, 1)
    return agents_xy, x_pred, u_pred
