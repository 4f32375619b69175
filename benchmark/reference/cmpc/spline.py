# Frozen copy of the port's plain path: project_on_spline of
# colaborativempc_tpu_torch/geometry/spline.py as the racing cell was added,
# imports made relative. The fit of recorded centerlines is left out: the
# racing cell runs an analytic track.
"""The batched Newton projection of Cartesian points onto a ``Track``
(reference ``Matlab-tests/MPCC-master/C++/Spline/arc_length_spline.cpp``
porjectOnSpline), on the device, with no host synchronisation."""

from __future__ import annotations

import torch

from .frenet import frenet_to_cartesian, segment_index, wrap_s
from .tracks import Track


def project_on_spline(track: Track, x, y, s_guess, lane: int = 0,
                      max_dist: float = 2.0, iters: int = 20,
                      tol: float = 1e-5) -> torch.Tensor:
    """Project Cartesian points onto the track, elementwise over ``x``,
    ``y``, ``s_guess`` (tensors of one shape): argmin_s |p(s) - (x, y)|.

    The reference's ``porjectOnSpline`` (``arc_length_spline.cpp:267-309``):
    a guess further than ``max_dist`` from the path is re-seeded from the
    nearest stored segment start (padded +inf starts excluded); then
    ``iters`` fixed Newton steps on the squared distance, each element
    frozen once a step moves it by at most ``tol``; an element that never
    converged falls back to its guess.
    """
    dtype, dev = track.x0.dtype, track.x0.device
    px = torch.as_tensor(x, dtype=dtype, device=dev)
    py = torch.as_tensor(y, dtype=dtype, device=dev)
    s_guess = torch.as_tensor(s_guess, dtype=dtype, device=dev)

    gx, gy, _ = frenet_to_cartesian(track, s_guess, 0.0, lane)
    far = torch.sqrt((px - gx) ** 2 + (py - gy) ** 2) >= max_dist
    d2 = ((track.x0[lane] - px[..., None]) ** 2
          + (track.y0[lane] - py[..., None]) ** 2)
    finite = torch.isfinite(track.s0[lane])
    d2 = torch.where(finite, d2, torch.full_like(d2, torch.inf))
    nearest = track.s0[lane][torch.argmin(d2, dim=-1)]
    s = torch.where(far, nearest, s_guess)
    done = torch.zeros_like(far)
    for _ in range(iters):
        qx, qy, theta = frenet_to_cartesian(track, s, 0.0, lane)
        idx, _ = segment_index(track, s, lane)
        kappa = track.curv[lane][idx]
        dx, dy = qx - px, qy - py
        ct, st = torch.cos(theta), torch.sin(theta)
        jac = 2.0 * (dx * ct + dy * st)
        hess = 2.0 + 2.0 * kappa * (-dx * st + dy * ct)   # |p'| = 1 exactly
        tiny = torch.where(hess < 0, torch.full_like(hess, -1e-6),
                           torch.full_like(hess, 1e-6))
        step = jac / torch.where(torch.abs(hess) < 1e-6, tiny, hess)
        s_new = wrap_s(track, s - step, lane)
        s, done = (torch.where(done, s, s_new),
                   done | (torch.abs(s_new - s) <= tol))
    return torch.where(done, s, s_guess)
