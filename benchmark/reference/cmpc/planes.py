# Frozen copy of the port's plain path: colaborativempc_tpu_torch/geometry/planes.py
# as of the benchmark's first version, imports made relative.
"""Geometric separating hyperplanes between agent pairs (PyTorch port).

Twin of ``colaborativempc_tpu/geometry/planes.py`` (reference
``planes/compute_plane.py:41-68``), with any number of leading batch axes:
``(..., H, 2)`` ego positions against ``(..., H, n_neigh, 2)`` neighbours.
Only the ``keep_sign=True`` path exists — the one the LPV planner uses.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def compute_hyperplanes(ego_xy: torch.Tensor,
                        neigh_xy: torch.Tensor) -> torch.Tensor:
    """Perpendicular-bisector planes ``(a_x, a_y, b)`` per horizon step and
    neighbour, shape ``(..., H, n_neigh, 3)``: ``a . p + b < 0`` on the ego
    side (the JAX function with ``keep_sign=True``)."""
    d = neigh_xy - ego_xy[..., None, :]
    norm = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    a = d / torch.clamp_min(norm, _EPS)
    mid = 0.5 * (neigh_xy + ego_xy[..., None, :])
    b = -torch.sum(a * mid, dim=-1, keepdim=True)
    return torch.cat([a, b], dim=-1)


def plane_signed_distance(planes: torch.Tensor,
                          xy: torch.Tensor) -> torch.Tensor:
    """Evaluate ``a . p + b`` for points against planes (broadcasting)."""
    return (planes[..., 0] * xy[..., 0] + planes[..., 1] * xy[..., 1]
            + planes[..., 2])


def separation_weights(ego_xy: torch.Tensor, neigh_xy: torch.Tensor,
                       min_dist):
    """Distance-based weights of the linear separation reward (reference
    ``utilities/misc.py:10-18``): ``(2*D - dist)/n_neigh``. Returns
    ``(weights, dist)``, each ``(..., H, n_neigh)``."""
    d = neigh_xy - ego_xy[..., None, :]
    dist = torch.sqrt(torch.sum(d * d, dim=-1) + _EPS)
    n = neigh_xy.shape[-2]
    weights = (2.0 * min_dist - dist) / n
    return weights, dist
