# Frozen copy of the port's plain path: colaborativempc_tpu_torch/geometry/frenet.py
# as of the benchmark's first version, imports made relative.
"""Vectorised Frenet -> Cartesian transforms and track lookups (PyTorch port).

Twin of ``colaborativempc_tpu/geometry/frenet.py`` (reference
``mapManager/track_initialization.py:305-562``, ``utilities/misc.py:28-126``):
every query is a gather over the segment table, and the inverse map
``cartesian_to_frenet`` scores every segment at once.

``lane`` is either a Python int (one lane for every query point) or an
integer tensor whose shape is a prefix of ``s``'s shape — the per-agent lane
of the fleet step (``runtime/simulate.py lateral_wall``). A tensor lane
gathers one row of the lane-major tables per agent, and the trailing
dimensions of ``s`` are the query points of that agent. The pose functions
(``cartesian_to_frenet``, ``relocalize``) take a lane tensor of the query's
own shape.
"""

from __future__ import annotations

import torch

from .tracks import Track

_EPS_KAPPA = 1e-8


def _lane(lane):
    """Lane index as Python int or int64 tensor (gather takes int64)."""
    return lane.long() if isinstance(lane, torch.Tensor) else int(lane)


def _per_lane(v: torch.Tensor, lane, s: torch.Tensor) -> torch.Tensor:
    """Per-lane scalar ``v[lane]`` broadcastable against ``s``."""
    x = v[lane]
    if isinstance(lane, torch.Tensor):
        x = x.reshape(x.shape + (1,) * (s.ndim - x.ndim))
    return x


def _gather(table: torch.Tensor, lane, idx: torch.Tensor) -> torch.Tensor:
    """``table[lane][idx]`` with a per-agent lane tensor."""
    if not isinstance(lane, torch.Tensor):
        return table[lane][idx]
    rows = table[lane]                                   # (*L, nseg)
    flat = idx.reshape(lane.shape + (-1,))
    return torch.gather(rows, -1, flat).reshape(idx.shape)


def wrap_s(track: Track, s, lane=0):
    """Wrap arc-length onto [0, track_length) (closed) or clamp (open).

    Reference semantics: ``track_initialization.py:305-317`` (open tracks
    subtract one lap then clamp at 0; closed tracks wrap modulo length).
    """
    lane = _lane(lane)
    s = torch.as_tensor(s, dtype=track.s0.dtype, device=track.s0.device)
    L = _per_lane(track.track_length, lane, s)
    s = torch.clamp_min(s, 0.0)  # negatives clamp to 0 first
    s_closed = torch.remainder(s, L)
    s_open = torch.where(s >= L, s - L, s)
    return torch.where(track.open_flag, s_open, s_closed)


def check_lap(track: Track, s, lane=0):
    """Completed-lap count (reference ``track_initialization.py:319-323``)."""
    lane = _lane(lane)
    s = torch.as_tensor(s, dtype=track.s0.dtype, device=track.s0.device)
    return torch.floor(s / _per_lane(track.track_length, lane, s))


def segment_index(track: Track, s, lane=0):
    """Index of the segment containing wrapped arc-length ``s``."""
    lane = _lane(lane)
    sw = wrap_s(track, s, lane)
    rows = track.s0[lane]
    if isinstance(lane, torch.Tensor):
        q = sw.reshape(lane.shape + (-1,))
        # right=True skips zero-length segments whose s0 duplicates; the
        # +inf padding of s0 is never selected
        idx = torch.searchsorted(rows, q.contiguous(), right=True)
        idx = idx.reshape(sw.shape)
    else:
        idx = torch.searchsorted(rows, sw.contiguous(), right=True)
    return torch.clamp(idx - 1, 0, track.n_segments - 1), sw


def curvature(track: Track, s, lane=0):
    """Signed curvature at ``s`` (reference ``utilities/misc.py:78-102``)."""
    lane = _lane(lane)
    idx, _ = segment_index(track, s, lane)
    return _gather(track.curv, lane, idx)


def halfwidth(track: Track, s, lane=0, sm=1.0):
    """Lane half-width at ``s``, optionally shrunk by safety margin ``sm``
    (reference ``utilities/misc.py:105-126``)."""
    lane = _lane(lane)
    idx, _ = segment_index(track, s, lane)
    return _gather(track.halfwidth, lane, idx) * sm


def frenet_to_cartesian(track: Track, s, ey, lane=0):
    """Map curvilinear ``(s, ey)`` to inertial ``(x, y, theta)``: one smooth
    formula for straights and arcs, selected elementwise."""
    lane = _lane(lane)
    idx, sw = segment_index(track, s, lane)
    x0 = _gather(track.x0, lane, idx)
    y0 = _gather(track.y0, lane, idx)
    psi = _gather(track.psi0, lane, idx)
    kappa = _gather(track.curv, lane, idx)
    ds = sw - _gather(track.s0, lane, idx)

    theta = psi + kappa * ds
    straight = torch.abs(kappa) < _EPS_KAPPA
    rho = 1.0 / torch.where(straight, torch.ones_like(kappa), kappa)

    x_arc = x0 + rho * (torch.sin(theta) - torch.sin(psi)) - ey * torch.sin(theta)
    y_arc = y0 + rho * (torch.cos(psi) - torch.cos(theta)) + ey * torch.cos(theta)
    x_str = x0 + ds * torch.cos(psi) - ey * torch.sin(psi)
    y_str = y0 + ds * torch.sin(psi) + ey * torch.cos(psi)

    x = torch.where(straight, x_str, x_arc)
    y = torch.where(straight, y_str, y_arc)
    return x, y, theta


def wrap_to_pi(a):
    """Wrap angle(s) to (-pi, pi]."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def _lane_rows(table: torch.Tensor, lane, shape) -> torch.Tensor:
    """``table[lane]`` for every query point: ``(*shape, n_segments)``."""
    if isinstance(lane, torch.Tensor):
        return table[torch.broadcast_to(lane.long(), shape)]
    return table[int(lane)].expand(tuple(shape) + (table.shape[-1],))


def _lane_value(v: torch.Tensor, lane, shape) -> torch.Tensor:
    """Per-lane scalar ``v[lane]`` for every query point."""
    if isinstance(lane, torch.Tensor):
        return v[torch.broadcast_to(lane.long(), shape)]
    return v[int(lane)]


def cartesian_to_frenet(track: Track, x, y, psi, lane=0):
    """Map inertial ``(x, y, psi)`` (tensors of one shape) to curvilinear
    ``(s, ey, epsi, valid)`` on ``lane``.

    Every segment's candidate local coordinates are computed at once with
    validity masks; among the valid candidates the one with the smallest
    |ey| wins, the first on ties (the JAX rule; the reference's sequential
    scan takes the first valid segment, ``track_initialization.py:438-535``,
    which is the same where the valid segment is unique). Out-of-track
    points return the reference's sentinel (1e4, 1e4, 1e4, False).
    """
    dtype = track.x0.dtype
    x = torch.as_tensor(x, dtype=dtype, device=track.x0.device)
    y = torch.as_tensor(y, dtype=dtype, device=track.x0.device)
    psi = torch.as_tensor(psi, dtype=dtype, device=track.x0.device)
    shape = torch.broadcast_shapes(x.shape, y.shape, psi.shape)
    x, y, psi = (torch.broadcast_to(v, shape)[..., None] for v in (x, y, psi))
    lx0, ly0, lpsi, ls0, llen, lk, lhw = (
        _lane_rows(t, lane, shape) for t in (
            track.x0, track.y0, track.psi0, track.s0, track.length,
            track.curv, track.halfwidth))

    straight = torch.abs(lk) < _EPS_KAPPA
    nondegenerate = llen > 0.0
    # boundary tolerance for dense spline-fitted tables (JAX frenet.py:120)
    tol_s = 1e-3 * llen

    # straight-segment candidates
    cp, sp = torch.cos(lpsi), torch.sin(lpsi)
    vx, vy = x - lx0, y - ly0
    s_loc_str = vx * cp + vy * sp
    ey_str = -vx * sp + vy * cp
    valid_str = ((s_loc_str >= -tol_s) & (s_loc_str <= llen + tol_s)
                 & (torch.abs(ey_str) <= lhw + track.slack))
    epsi_str = wrap_to_pi(psi - lpsi)

    # arc-segment candidates
    rho = 1.0 / torch.where(straight, torch.ones_like(lk), lk)
    cx = lx0 - rho * sp
    cy = ly0 + rho * cp
    wx, wy = x - cx, y - cy
    v0x, v0y = lx0 - cx, ly0 - cy
    dot = v0x * wx + v0y * wy
    det = v0x * wy - v0y * wx
    arc2 = torch.atan2(det, dot)
    arc1 = llen * lk
    r_abs = torch.abs(rho)
    s_loc_arc = torch.abs(arc2) * r_abs
    ey_arc = -torch.sign(lk) * (torch.sqrt(wx * wx + wy * wy) - r_abs)
    valid_arc = (((torch.sign(arc1) == torch.sign(arc2)) | (s_loc_arc <= tol_s))
                 & (s_loc_arc <= llen + tol_s)
                 & (torch.abs(ey_arc) <= 3.0 * lhw + track.slack))
    epsi_arc = wrap_to_pi(psi - (lpsi + arc2))

    s_loc = torch.where(straight, s_loc_str, s_loc_arc)
    ey = torch.where(straight, ey_str, ey_arc)
    epsi = torch.where(straight, epsi_str, epsi_arc)
    valid = torch.where(straight, valid_str, valid_arc) & nondegenerate

    any_valid = valid.any(dim=-1)
    inf = torch.full_like(ey, torch.inf)
    first = torch.argmin(torch.where(valid, torch.abs(ey), inf),
                         dim=-1, keepdim=True)

    def pick(t):
        return torch.take_along_dim(t, first, dim=-1)[..., 0]

    sentinel = torch.full(shape, 1e4, dtype=dtype, device=track.x0.device)
    return (torch.where(any_valid, pick(ls0) + pick(s_loc), sentinel),
            torch.where(any_valid, pick(ey), sentinel),
            torch.where(any_valid, pick(epsi), sentinel), any_valid)


def check_lane(track: Track, x, y, psi):
    """Localise against every lane and return the best (min |ey|) one,
    elementwise (reference ``track_initialization.py:418-436``). Returns
    ``(s, ey, epsi, valid, lane)`` with ``lane`` int32."""
    res = [cartesian_to_frenet(track, x, y, psi, lane=k)
           for k in range(track.n_lanes)]
    s, ey, epsi, valid = (torch.stack(f, dim=-1) for f in zip(*res))
    best = torch.argmin(torch.abs(ey), dim=-1, keepdim=True)

    def pick(t):
        return torch.take_along_dim(t, best, dim=-1)[..., 0]
    return pick(s), pick(ey), pick(epsi), pick(valid), best[..., 0].int()


def relocalize(track: Track, x: torch.Tensor, lane,
               old_lane=None) -> torch.Tensor:
    """Recompute the Frenet entries (ey, epsi, s) of 9-states ``x (..., 9)``
    from their poses (X, Y, theta) on ``lane`` (int or a tensor of shape
    ``x.shape[:-1]``), keeping the lap multiple of the old s (reference
    ``set_lane``, ``track_initialization.py:302``). The completed-lap count
    is derived against ``old_lane``'s length (default ``lane``), with the new
    lane's fractional progress rescaled, so it stays integral across lanes
    of different lengths. An out-of-lane pose keeps its old entries."""
    shape = x.shape[:-1]
    s_loc, ey, epsi, valid = cartesian_to_frenet(
        track, x[..., 7], x[..., 8], x[..., 5], lane=lane)
    L = _lane_value(track.track_length, lane, shape)
    L_old = L if old_lane is None else _lane_value(track.track_length,
                                                   old_lane, shape)
    k = torch.round((x[..., 6] - s_loc * L_old / L) / L_old)
    s_new = k * L + s_loc
    return torch.cat([
        x[..., :3],
        torch.where(valid, ey, x[..., 3])[..., None],
        torch.where(valid, epsi, x[..., 4])[..., None],
        x[..., 5:6],
        torch.where(valid, s_new, x[..., 6])[..., None],
        x[..., 7:]], dim=-1)


def select_lane(track: Track, x: torch.Tensor, prev_lane=None):
    """Dynamic lane selection for 9-states ``x (..., 9)``: localise each
    pose against every lane, pick the min-|ey| lane and relocalise onto it
    (the reference's per-step ``checkLane``/``set_lane``). ``prev_lane`` is
    the lane each ``x[..., 6]`` was measured on (see :func:`relocalize`).
    Returns ``(lane int32, x')``."""
    *_, lane = check_lane(track, x[..., 7], x[..., 8], x[..., 5])
    return lane, relocalize(track, x, lane, old_lane=prev_lane)


def check_end(track: Track, s, laps: int = 1, lane=0, atol: float = 0.15):
    """True when an agent has completed ``laps`` laps (reference
    ``utilities/misc.py:28-48``): s within ``atol`` of (or beyond) the track
    length and the completed-lap count equal to ``laps``."""
    lane = _lane(lane)
    s = torch.as_tensor(s, dtype=track.s0.dtype, device=track.s0.device)
    L = _per_lane(track.track_length, lane, s)
    near = torch.isclose(s, torch.broadcast_to(L, s.shape), atol=atol)
    return (near | (s > L)) & (check_lap(track, s, lane) == laps)

