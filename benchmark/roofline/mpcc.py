"""The work of one MPCC stage-QP build (``planners/mpcc.py build_mpcc_qp``,
on the card the ``mpcc_qp_kernel`` of ``csrc/sqp_qp.cu``), counted from
shapes alone. A frozen copy of the port's ``ops/cuda_sqp.py mpcc_traffic``
(through ``sqp_qp_traffic``) as the racing cell was added; the peaks are
``benchmark/roofline/__init__.py``'s."""

from __future__ import annotations

from benchmark.roofline import NU, NX, NZ

NC = NU                 # the stage control: the input increments
MPCC_ROWS = 7           # corridor, two input boxes, ellipse, two slip, vx
MPCC_OPS_PER_STAGE = 300  # FP32 operations of one build stage, rounded up
GAINS = 10              # the racing gains read once a race


def track_floats(lanes: int, nseg: int) -> int:
    """Floats of the track's tables that every race shares: per lane the
    segments' starts, lengths and curvatures and the lane's length, and the
    open flag."""
    return lanes * (3 * nseg + 1) + 1


def build_counts(P: int, N: int, lanes: int = 1, nseg: int = 1):
    """Bytes and FP32 operations of one build of ``P`` races' stage QPs,
    the least it needs: per stage the state and input read once, per race
    the state of stage N and the gains, the track's tables once; every
    output field of the stage QP written once (F, G, d, R, r, S, D, E and
    four row bounds over N stages, Q and q over N + 1).
    ``MPCC_OPS_PER_STAGE`` per stage for the Pacejka Jacobians, the
    discrete model and the rows, whose time is far below the bytes'."""
    m = MPCC_ROWS
    out = (N * (NZ * NZ + NZ * NC + NZ + NC * NC + NC + NZ * NC
                + m * (NZ + NC + 4))
           + (N + 1) * (NZ * NZ + NZ))
    inp = N * (NX + NU) + NX + GAINS
    nbytes = 4.0 * (P * (inp + out) + track_floats(lanes, nseg))
    return nbytes, float(MPCC_OPS_PER_STAGE) * P * N
