"""Open-loop model rollouts for validation and replay (PyTorch port).

Twin of ``colaborativempc_tpu/utils/rollout.py``. The reference validates
its LPV discretisation by replaying recorded input sequences through
``LPV_Model.sim`` (``distributedPlanner/LPV_val.py:77-94``, driven by
``scripts/eval_LPV_model.py``). The LPV embedding is exact
(A(x) x + B(x) u == f(x, u)), so that rollout is explicit-Euler integration
of the nonlinear model. Here it is a loop over the T inputs with a
curvature lookup per step; ``x0 (..., 9)`` and ``us (..., T, 2)`` may carry
the same leading batch axes, and every tensor lies on the track's device.
"""

from __future__ import annotations

import torch

from colaborativempc_tpu_torch.config.params import ModelParams
from colaborativempc_tpu_torch.dynamics.bicycle import step_euler, step_rk4
from colaborativempc_tpu_torch.geometry.frenet import curvature
from colaborativempc_tpu_torch.geometry.tracks import Track


def _rollout(track: Track, x0, us, step):
    xs = [x0]
    for k in range(us.shape[-2]):
        xs.append(step(xs[-1], us[..., k, :]))
    return torch.stack(xs, dim=-2)


def rollout_euler(track: Track, x0: torch.Tensor, us: torch.Tensor, dt,
                  model: ModelParams = ModelParams()) -> torch.Tensor:
    """Euler rollout with a per-step curvature lookup (LPV_Model.sim
    parity): ``x0 (..., 9)``, ``us (..., T, 2)`` -> ``(..., T+1, 9)``."""
    return _rollout(track, x0, us, lambda x, u: step_euler(
        x, u, curvature(track, x[..., 6]), dt, model))


def rollout_rk4(track: Track, x0: torch.Tensor, us: torch.Tensor, dt,
                model: ModelParams = ModelParams(),
                substeps: int = 1) -> torch.Tensor:
    """RK4 plant rollout, ``substeps`` RK4 steps of ``dt / substeps`` per
    input, the curvature looked up before each (native reference analogue
    MPCC-master/C++/Model/integrator.cpp:55-68 simTimeStep)."""
    def step(x, u):
        for _ in range(substeps):
            x = step_rk4(x, u, curvature(track, x[..., 6]), dt / substeps,
                         model)
        return x
    return _rollout(track, x0, us, step)
