"""Vectorised Frenet -> Cartesian transforms and track lookups (PyTorch port).

Twin of the fixed-lane functions of ``colaborativempc_tpu/geometry/frenet.py``
(reference ``mapManager/track_initialization.py:305-399``,
``utilities/misc.py:28-126``): every query is a gather over the segment
table. The dynamic-lane functions (``cartesian_to_frenet``, ``relocalize``,
``select_lane``, ``check_lane``) are not ported yet.

``lane`` is either a Python int (one lane for every query point) or an
integer tensor whose shape is a prefix of ``s``'s shape — the per-agent lane
of the fleet step (``runtime/simulate.py lateral_wall``). A tensor lane
gathers one row of the lane-major tables per agent, and the trailing
dimensions of ``s`` are the query points of that agent.
"""

from __future__ import annotations

import torch

from colaborativempc_tpu_torch.geometry.tracks import Track

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


def check_end(track: Track, s, laps: int = 1, lane=0, atol: float = 0.15):
    """True when an agent has completed ``laps`` laps (reference
    ``utilities/misc.py:28-48``): s within ``atol`` of (or beyond) the track
    length and the completed-lap count equal to ``laps``."""
    lane = _lane(lane)
    s = torch.as_tensor(s, dtype=track.s0.dtype, device=track.s0.device)
    L = _per_lane(track.track_length, lane, s)
    near = torch.isclose(s, torch.broadcast_to(L, s.shape), atol=atol)
    return (near | (s > L)) & (check_lap(track, s, lane) == laps)

