"""Arbitrary-track ingestion: fit recorded X/Y centerlines into ``Track``
tables (PyTorch port).

Twin of ``colaborativempc_tpu/geometry/spline.py`` (reference
``Matlab-tests/MPCC-master/C++/Spline/arc_length_spline.cpp``
outlierRemoval/fitSpline/porjectOnSpline, JSON loader ``Params/track.cpp``).
The fit runs once on the host in float64 numpy/scipy and emits the flat
per-segment ``Track`` table every geometry function already reads, placed
on ``device``. ``project_on_spline`` is the batched Newton projection onto
the table, on the device, with no host synchronisation.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from colaborativempc_tpu_torch.geometry.frenet import (
    frenet_to_cartesian, segment_index, wrap_s,
)
from colaborativempc_tpu_torch.geometry.tracks import Track
from colaborativempc_tpu_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# Host-side fit pipeline (numpy/scipy, float64)
# ---------------------------------------------------------------------------

def remove_outliers(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Drop points closer than 0.7x the mean spacing to the last kept point
    (``arc_length_spline.cpp:108-175``); the first and last points stay."""
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    if x.size != y.size:
        raise ValueError("x and y must have the same length")
    if x.size < 3:
        return x, y
    d = np.hypot(np.diff(x), np.diff(y))
    mean_dist = float(d.mean())
    keep = [0]
    j = 0
    for i in range(1, x.size - 1):
        if math.hypot(x[i] - x[j], y[i] - y[j]) >= 0.7 * mean_dist:
            keep.append(i)
            j = i
    keep.append(x.size - 1)
    return x[keep], y[keep]


def _chord_arclength(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Cumulative piecewise-linear arc length (``compArcLength``)."""
    return np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(x), np.diff(y)))])


def _estimate_noise(x: np.ndarray, y: np.ndarray) -> float:
    """Robust waypoint-noise scale from third differences: iid noise of
    scale sigma gives a 2D residual whose median magnitude is
    sqrt(20 ln 4) sigma, while a smooth curve contributes O(h^3)."""
    if x.size < 6:
        return 0.0
    d3 = np.hypot(np.diff(x, 3), np.diff(y, 3))
    return float(np.median(d3) / math.sqrt(20.0 * math.log(4.0)))


class _ParamSpline:
    """Parametric (optionally smoothing, optionally periodic) 2D spline."""

    def __init__(self, s, x, y, closed: bool, smooth: float):
        from scipy.interpolate import splprep
        if closed and not (np.isclose(x[0], x[-1])
                           and np.isclose(y[0], y[-1])):
            s = np.concatenate([s, [s[-1] + math.hypot(x[0] - x[-1],
                                                       y[0] - y[-1])]])
            x = np.concatenate([x, [x[0]]])
            y = np.concatenate([y, [y[0]]])
        self.tck, _ = splprep([x, y], u=s, s=smooth, per=int(closed), k=3)
        self.total = float(s[-1])

    def __call__(self, s, der: int = 0):
        from scipy.interpolate import splev
        xs, ys = splev(np.asarray(s, np.float64), self.tck, der=der)
        return np.asarray(xs), np.asarray(ys)


def fit_centerline(x, y, halfwidth=0.5, closed: bool | None = None,
                   n_segments: int = 1000, slack: float = 0.15,
                   clean: bool = True, smooth: float | None = None,
                   dtype=torch.float32, device="cuda") -> Track:
    """Fit a measured X/Y centerline into a ``Track`` table on ``device``
    (the default ``cuda`` raises without a card).

    Pipeline (reference ``gen2DSpline``, ``arc_length_spline.cpp:226-236``):
    outlier removal -> chord-length spline fit (smoothing by the estimated
    waypoint noise unless ``smooth`` is given) -> arc-length resample ->
    second, interpolating fit -> per-segment start pose and midpoint
    curvature. ``halfwidth`` is a scalar or one value per output segment;
    ``closed`` is detected from the endpoints when None.
    """
    dev = resolve_device(device)
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    if closed is None:
        d = np.hypot(np.diff(x), np.diff(y))
        closed = bool(math.hypot(x[-1] - x[0], y[-1] - y[0]) < 3.0 * d.mean())
    if clean:
        x, y = remove_outliers(x, y)
    if closed and np.isclose(x[0], x[-1]) and np.isclose(y[0], y[-1]):
        x, y = x[:-1], y[:-1]  # drop duplicate closure point

    if smooth is None:
        sigma = _estimate_noise(x, y)
        smooth = x.size * (2.0 * sigma) ** 2

    # pass 1: chord-length parameter fit (smoothing), resample equidistantly
    s1 = _chord_arclength(np.concatenate([x, x[:1]]) if closed else x,
                          np.concatenate([y, y[:1]]) if closed else y)
    spl = _ParamSpline(s1[: x.size], x, y, closed, smooth)
    n_mid = max(n_segments, x.size)
    s_mid = np.linspace(0.0, spl.total, n_mid, endpoint=not closed)
    x2, y2 = spl(s_mid)

    # pass 2: interpolating refit on the refined arc-length parameter
    # (arc_length_spline.cpp:183-222)
    s2 = _chord_arclength(np.concatenate([x2, x2[:1]]) if closed else x2,
                          np.concatenate([y2, y2[:1]]) if closed else y2)
    spl = _ParamSpline(s2[: x2.size], x2, y2, closed, 0.0)
    total = spl.total

    n = n_segments
    s0 = np.linspace(0.0, total, n, endpoint=False) if closed else \
        np.linspace(0.0, total, n + 1)[:-1]
    seg_len = np.full(n, total / n)
    xs, ys = spl(s0)
    dxs, dys = spl(s0, 1)
    psis = np.arctan2(dys, dxs)
    sm = s0 + 0.5 * seg_len
    sm_eval = np.mod(sm, total) if closed else np.minimum(sm, total)
    dx1, dy1 = spl(sm_eval, 1)
    dx2, dy2 = spl(sm_eval, 2)
    denom = np.maximum((dx1 * dx1 + dy1 * dy1) ** 1.5, 1e-12)
    curv = (dx1 * dy2 - dy1 * dx2) / denom
    hw = np.broadcast_to(np.atleast_1d(np.asarray(halfwidth, np.float64)),
                         (n,)).copy()

    def t(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype, device=dev)

    return Track(
        x0=t(xs[None]), y0=t(ys[None]), psi0=t(psis[None]), s0=t(s0[None]),
        length=t(seg_len[None]), curv=t(curv[None]), halfwidth=t(hw[None]),
        track_length=t([total]),
        open_flag=torch.tensor(not closed, device=dev), slack=t(slack))


def halfwidth_from_boundaries(center_xy, inner_xy, outer_xy,
                              margin: float = 0.0) -> np.ndarray:
    """Per-centerline-point half-width: the distance to the nearer of the
    measured inner/outer boundary polylines (``Params/track.cpp`` X_i/Y_i,
    X_o/Y_o), minus ``margin``, floored at 1e-3."""
    c = np.asarray(center_xy, np.float64)
    i = np.asarray(inner_xy, np.float64)
    o = np.asarray(outer_xy, np.float64)
    di = np.sqrt(((c[:, None, :] - i[None, :, :]) ** 2).sum(-1)).min(1)
    do = np.sqrt(((c[:, None, :] - o[None, :, :]) ** 2).sum(-1)).min(1)
    return np.maximum(np.minimum(di, do) - margin, 1e-3)


def load_track_json(path: str):
    """Load a reference-format track JSON (``Params/track.cpp:28-42``):
    ``X, Y`` (centerline) and, when present, ``X_i, Y_i, X_o, Y_o`` as
    float64 arrays."""
    with open(path) as f:
        raw = json.load(f)
    out = {}
    for k in ("X", "Y", "X_i", "Y_i", "X_o", "Y_o"):
        if k in raw:
            out[k] = np.asarray(raw[k], np.float64)
    if "X" not in out or "Y" not in out:
        raise ValueError(f"{path}: track JSON must carry X and Y arrays")
    return out


def track_from_json(path: str, n_segments: int = 1000, margin: float = 0.0,
                    slack: float = 0.15, dtype=torch.float32,
                    device="cuda") -> Track:
    """Reference track JSON -> fitted ``Track`` with measured half-widths,
    on ``device`` (the default ``cuda`` raises without a card). With
    boundaries, a first float64 fit on the host places the segment starts,
    the half-widths are measured there and the track is refitted with
    them."""
    dev = resolve_device(device)
    d = load_track_json(path)
    x, y = d["X"], d["Y"]
    hw = 0.5
    if all(k in d for k in ("X_i", "Y_i", "X_o", "Y_o")):
        t0 = fit_centerline(x, y, halfwidth=1.0, n_segments=n_segments,
                            slack=slack, dtype=torch.float64, device="cpu")
        centers = np.stack([t0.x0[0].numpy(), t0.y0[0].numpy()], -1)
        hw = halfwidth_from_boundaries(
            centers, np.stack([d["X_i"], d["Y_i"]], -1),
            np.stack([d["X_o"], d["Y_o"]], -1), margin=margin)
    return fit_centerline(x, y, halfwidth=hw, n_segments=n_segments,
                          slack=slack, dtype=dtype, device=dev)


# ---------------------------------------------------------------------------
# On-device projection
# ---------------------------------------------------------------------------

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
