# Frozen copy of the port's plain path: colaborativempc_tpu_torch/geometry/tracks.py
# as of the benchmark's first version, imports made relative.
"""Track database and segment-table construction (PyTorch port).

Twin of ``colaborativempc_tpu/geometry/tracks.py``: the same arc-segment
specs (reference ``mapManager/track_initialization.py:23-214``) compiled
once on the host in float64 into a flat per-segment table, here as torch
tensors on a chosen device. The numpy-only helpers ``_specs`` and
``_build_lane`` are copied verbatim, so both packages build identical
tables.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device


class Track(NamedTuple):
    """Per-segment track table, lane-major. All fields are tensors.

    Shapes: ``(n_lanes, n_segments)`` for per-segment fields,
    ``(n_lanes,)`` for per-lane fields, scalars otherwise.
    """

    x0: torch.Tensor        # segment start x
    y0: torch.Tensor        # segment start y
    psi0: torch.Tensor      # tangent angle at segment start
    s0: torch.Tensor        # cumulative arc length at segment start
    length: torch.Tensor    # segment arc length
    curv: torch.Tensor      # signed curvature (0 for straight)
    halfwidth: torch.Tensor  # lane half-width on this segment
    track_length: torch.Tensor  # (n_lanes,) total length per lane
    open_flag: torch.Tensor     # scalar bool: open (non-looping) track
    slack: torch.Tensor         # scalar: out-of-track tolerance band

    @property
    def n_lanes(self) -> int:
        return self.x0.shape[0]

    @property
    def n_segments(self) -> int:
        return self.x0.shape[1]


def _wrap_pi(a: float) -> float:
    """Wrap angle to (-pi, pi] (reference ``track_initialization.py:565-573``)."""
    return math.atan2(math.sin(a), math.cos(a))


# ---------------------------------------------------------------------------
# Track spec database. Each entry: (specs, halfwidth, open, slack) where specs
# is a list of lanes, each lane a list of (length, radius) rows; halfwidth is a
# per-segment array (or scalar) applied to all lanes.
# Mirrors the geometry data of track_initialization.py:23-214.
# ---------------------------------------------------------------------------

def _specs() -> dict:
    pi = np.pi
    db = {}

    s = 0.03
    db["3110"] = dict(
        lanes=[[(60 * s, 0), (80 * s, 80 * s * 2 / pi), (20 * s, 0),
                (80 * s, 80 * s * 2 / pi), (40 * s, -40 * s * 10 / pi),
                (60 * s, 60 * s * 5 / pi), (40 * s, -40 * s * 10 / pi),
                (80 * s, 80 * s * 2 / pi), (20 * s, 0),
                (80 * s, 80 * s * 2 / pi), (80 * s, 0)]],
        halfwidth=0.6, open=False, slack=0.15)

    db["oval"] = dict(
        lanes=[[(2.0, 0), (5.85, 5.85 / pi), (4.0, 0), (5.85, 5.85 / pi), (2.0, 0)]],
        halfwidth=0.55, open=False, slack=0.15)

    db["oval_mt"] = dict(
        lanes=[[(1.0, 0), (4.5, 4.5 / pi), (2.0, 0), (4.5, 4.5 / pi), (1.0, 0)]],
        halfwidth=0.5, open=False, slack=0.15)

    oval2_l0 = [(2.0, 0), (9.0, 9.0 / pi), (4.0, 0), (9.0, 9.0 / pi), (2.0, 0)]
    oval2_l1 = [(2.0, 0), (5.85, 5.85 / pi), (4.0, 0), (5.85, 5.85 / pi), (2.0, 0)]
    db["Oval2"] = dict(lanes=[oval2_l0, oval2_l1], halfwidth=0.5, open=False,
                       slack=0.15)

    db["TestOpenMap"] = dict(
        lanes=[[(0.0, 0), (2.0, 0), (9.0, 9.0 / pi), (4.0, 0), (0.0, 0)],
               [(0.0, 0), (2.0, 0), (5.85, 5.85 / pi), (4.0, 0), (0.0, 0)]],
        halfwidth=0.5, open=True, slack=0.15)

    db["Highway"] = dict(
        lanes=[[(0.0, 0), (2.0, 0), (9.0, 9.0 / (0.5 * pi)), (4.0, 0),
                (5.0, -5.0 / (0.5 * pi)), (4.0, 0), (9.0, 9.0 / pi), (4.0, 0),
                (10.0, 0), (0.0, 0)]],
        halfwidth=0.75, open=True, slack=0.15)

    db["SL"] = dict(
        lanes=[[(0.0, 0), (6.0, 0), (2.0, 0), (2.0, 0), (2.0, 0), (2.0, 0),
                (2.0, 0), (2.0, 0), (2.0, 0), (2.0, 0), (4.0, 0), (6.0, 0)]],
        halfwidth=np.array([0.75, 0.75, 0.65, 0.65, 0.55, 0.35, 0.35, 0.55,
                            0.65, 0.65, 0.75, 0.75]),
        open=True, slack=0.15)

    lc = 4.5
    db["L_shape"] = dict(
        lanes=[[(1.0, 0), (lc, lc / pi), (lc / 2, -lc / pi), (lc, lc / pi),
                (lc / pi * 2, 0), (lc / 2, lc / pi)]],
        halfwidth=0.5, open=False, slack=0.45)

    lc = 45.0
    db["L_shape_IDIADA"] = dict(
        lanes=[[(1.0, 0), (lc, lc / pi), (lc / 2, -lc / pi), (lc, lc / pi),
                (lc / pi * 2, 0), (lc / 2, lc / pi)]],
        halfwidth=0.5, open=False, slack=6 * 0.45)

    lc = 1.5 * (pi / 2)
    db["SLAM_shape1"] = dict(
        lanes=[[(2.5, 0), (2 * lc, (lc * 2) / pi), (lc, -(lc * 2) / pi),
                (1.0, 0), (lc, lc * 2 / pi), (2.0, 0), (lc, (lc * 2) / pi),
                (4.0, 0), (lc, (lc * 2) / pi), (2.6, 0)]],
        halfwidth=0.4, open=False, slack=0.15)

    db["8_track"] = dict(
        lanes=[[(0.5, 0), (lc, (lc * 2) / pi), (1.0, 0), (lc, -(lc * 2) / pi),
                (lc, lc * 2 / pi), (lc, lc * 2 / pi), (1.0, 0),
                (lc, (lc * 2) / pi), (lc, -(lc * 2) / pi), (lc, (lc * 2) / pi),
                (1.0, 0), (lc, lc * 2 / pi)]],
        halfwidth=0.4, open=False, slack=0.15)

    return db


_TRACK_DB = _specs()
TRACK_NAMES = tuple(_TRACK_DB.keys())


def _build_lane(rows, y_start: float, open_track: bool):
    """Walk the arc-segment spec, producing per-segment start poses.

    Equivalent construction to ``track_initialization.py:229-299`` but storing
    the START pose of each segment (the reference stores end poses and reads
    row ``i-1`` for starts).
    """
    n = len(rows)
    xs, ys, psis, s0s, lens, curvs = [], [], [], [], [], []
    x, y, psi, s = 0.0, float(y_start), 0.0, 0.0

    for (l, r) in rows:
        xs.append(x); ys.append(y); psis.append(psi); s0s.append(s)
        lens.append(float(l))
        if r == 0.0:
            curvs.append(0.0)
            x += l * math.cos(psi)
            y += l * math.sin(psi)
        else:
            kappa = 1.0 / r
            curvs.append(kappa)
            rho = r  # signed radius
            theta = psi + kappa * l
            x += rho * (math.sin(theta) - math.sin(psi))
            y += rho * (math.cos(psi) - math.cos(theta))
            psi = _wrap_pi(theta)
        s += l

    if not open_track:
        # Closing straight back to the origin of this lane. Its direction is
        # the chord (end -> start), matching the reference's straight-segment
        # position interpolation between endpoints
        # (track_initialization.py:287-297, 349-367): for specs that do not
        # return exactly to heading 0 (e.g. "3110"), the chord differs from
        # the last tangent.
        l = math.hypot(0.0 - x, y_start - y)
        psi_close = math.atan2(y_start - y, 0.0 - x) if l > 1e-12 else psi
        xs.append(x); ys.append(y); psis.append(psi_close); s0s.append(s)
        lens.append(l); curvs.append(0.0)
        s += l

    return (np.array(xs), np.array(ys), np.array(psis), np.array(s0s),
            np.array(lens), np.array(curvs), s)


def make_track(name: str, device="cuda", dtype=torch.float32) -> Track:
    """Build a named track into a segment table on ``device`` (the default
    ``cuda`` raises without a card)."""
    if name not in _TRACK_DB:
        raise ValueError(f"unknown track {name!r}; available: {TRACK_NAMES}")
    dev = resolve_device(device)
    e = _TRACK_DB[name]
    lanes = e["lanes"]
    hw = e["halfwidth"]
    open_track = e["open"]

    hw0 = float(np.atleast_1d(hw)[0])
    # starting y offset per lane (reference track_initialization.py:227)
    y_inis = [2 * hw0 * (k + 1) for k in range(len(lanes))]

    built = [_build_lane(rows, y_inis[k], open_track)
             for k, rows in enumerate(lanes)]
    nseg = max(b[0].shape[0] for b in built)

    def pad(a, fill=0.0):
        out = np.full(nseg, fill, dtype=np.float64)
        out[: a.shape[0]] = a
        return out

    # pad trailing s0 with +inf so searchsorted never selects padded rows
    s0 = np.stack([np.concatenate([b[3], np.full(nseg - b[3].shape[0], np.inf)])
                   for b in built])
    hw_arr = np.broadcast_to(np.atleast_1d(np.asarray(hw, dtype=np.float64)),
                             (len(lanes[0]),)).copy()
    hw_lane = np.full(nseg, hw_arr[-1])
    hw_lane[: hw_arr.shape[0]] = hw_arr

    def t(a):
        return torch.tensor(np.array(a, np.float64), dtype=dtype, device=dev)

    return Track(
        x0=t(np.stack([pad(b[0]) for b in built])),
        y0=t(np.stack([pad(b[1]) for b in built])),
        psi0=t(np.stack([pad(b[2]) for b in built])),
        s0=t(s0),
        length=t(np.stack([pad(b[4]) for b in built])),
        curv=t(np.stack([pad(b[5]) for b in built])),
        halfwidth=t(np.broadcast_to(hw_lane, (len(lanes), nseg))),
        track_length=t(np.array([b[6] for b in built])),
        open_flag=torch.tensor(open_track, device=dev),
        slack=t(e["slack"]),
    )
