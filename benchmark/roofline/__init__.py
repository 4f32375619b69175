"""Peaks of the card and the work the kernels' algorithms need, counted
from shapes alone (never from a program's launch plans), so the same work
is counted whatever implements it.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates): HBM 3.35
TB/s, FP32 67 TFLOP/s off the tensor cores. The port computes in float32
on the CUDA cores (TF32 pinned off), so FP32 is its arithmetic peak.

Counts (bytes in float32; a multiply-add counts as 2 operations):

- :func:`epoch_data_counts`: one ADMM epoch's fixed data (the
  rho-augmented cost, its Riccati factorisation, the prox factors);
- :func:`epoch_iteration_counts`: one epoch's ``epoch_len`` iterations
  from that data;
- :func:`epoch_work`: the two as one unit of work, the least an ADMM epoch
  needs: the stage QP, ``rho_scale``, ``z0`` and the warm ``(w, y)`` read
  once, ``z, c, w, y`` and the residuals written once; the operations of
  both;
- :func:`nl_build_counts`: one SQP stage-QP build of the NL planner.

The first two and the last are frozen copies of the port's counts as of
the benchmark's first version (``ops/cuda_lqr.py epoch_data_traffic``,
``chip_smoke.py kernel_bound``, ``ops/cuda_sqp.py nl_traffic``).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

NX, NU = 9, 2          # the bicycle model's states and inputs
NZ = NX + NU           # the QP's lifted state, [x; u_prev]
NL_OPS_PER_STAGE = 300  # FP32 operations of one NL build stage, rounded up


def lpv_shape(n_agents: int):
    """``(nz, nc, mr)`` of the LPV planner's stage QP: four rows and one
    plane row per neighbour (one placeholder when alone)."""
    return NZ, NU, 4 + (n_agents - 1 if n_agents > 1 else 1)


def nl_shape(n_agents: int, coupling: str):
    """``(nz, nc, mr)`` of the NL planner's stage QP: ``hp_opt`` adds two
    plane controls and three rows per neighbour."""
    nb = max(n_agents - 1, 1)
    hp_opt = coupling == "hp_opt"
    return (NZ, NU + (2 * nb if hp_opt else 0),
            4 + (3 * nb if hp_opt else nb))


def epoch_data_counts(P: int, N: int, nz: int, nc: int, mr: int):
    """Bytes and operations of one epoch's fixed data. Bytes: F, G, d, Q
    over N+1 stages, R, S, D, E, lo, hi, both soft weights and rho_scale
    read once; K, Quu_inv, Qxu, m, the masked D and E, rv and the prox
    factors written once. Operations per stage: the augmentation
    D'diag(rv)D, D'diag(rv)E, E'diag(rv)E; P F, F'(P F), P G, F'(P G),
    G'(P G), P d and the sums; Quu's Cholesky and the solves of the gain
    and inverse columns; P = sym(Qxx + Qxu K); the rows' factors."""
    per_stage_in = (2 * nz * nz + 2 * nz * nc + nc * nc + nz
                    + mr * (nz + nc + 4))
    inputs = N * per_stage_in + nz * nz + mr
    outputs = N * (2 * nz * nc + nc * nc + nz + mr * (nz + nc + 3))
    nbytes = 4.0 * P * (inputs + outputs)
    per_stage = (2 * mr * (nz * nz + nz * nc + nc * nc)
                 + 2 * mr * (nz + nc)
                 + 4 * nz ** 3 + 4 * nz * nz * nc + 2 * nz * nc * nc
                 + 2 * nz * nz
                 + 2 * (nz * nz + nz * nc + nc * nc)
                 + 2 * nc * nc + nc ** 3 // 3 + 2 * nc * nc * (nz + nc)
                 + 2 * nz * nz * nc + 3 * nz * nz
                 + 10 * mr)
    return nbytes, float(P) * N * per_stage


def epoch_iteration_counts(P: int, N: int, nz: int, nc: int, mr: int,
                           epoch_len: int):
    """Bytes and operations of one epoch's iterations from its fixed data.
    Bytes: the data (F, G, d, K, Quu_inv, Qxu, m, q, r, D, E, lo, hi, rv,
    the prox factors), z0 and (w, y) read once; z, c, w, y and the
    residuals written once. Operations per stage and iteration: F' t, F z
    (4 nz^2); G' t, Qxu kff, K z, G c (8 nz nc); Quu_inv Qu (2 nc^2); the
    rows' D' t, E' t, D z, E c (4 mr (nz + nc)); the penalty, relaxation,
    prox, dual step and residuals (12 mr); vector sums (4 nz)."""
    fixed = (nz * nz + 3 * nz * nc + nc * nc + 2 * nz + nc
             + mr * (nz + nc + 5))
    inputs = N * fixed + (N + 1) * nz + nz + 2 * N * mr
    outputs = (N + 1) * nz + N * nc + 2 * N * mr + 2 * mr
    nbytes = 4.0 * P * (inputs + outputs)
    per_stage = (4 * nz * nz + 8 * nz * nc + 2 * nc * nc
                 + 4 * mr * (nz + nc) + 12 * mr + 4 * nz)
    return nbytes, float(P) * N * max(epoch_len, 1) * per_stage


def epoch_work(P: int, N: int, nz: int, nc: int, mr: int, epoch_len: int):
    """Bytes and operations of one whole ADMM epoch (fixed data and
    iterations), the least the algorithm needs: inputs are the stage QP
    (F, G, d, R, r, S, D, E, lo, hi and both soft weights over N stages, Q
    and q over N+1), rho_scale, z0 and the warm (w, y); outputs are z, c,
    w, y and both residuals. The data between the two parts is neither
    read nor written by the unit."""
    qp = (N * (nz * nz + nz * nc + nz + nc * nc + nc + nz * nc
               + mr * (nz + nc + 4))
          + (N + 1) * (nz * nz + nz))
    inputs = qp + mr + nz + 2 * N * mr
    outputs = (N + 1) * nz + N * nc + 2 * N * mr + 2 * mr
    flops = (epoch_data_counts(P, N, nz, nc, mr)[1]
             + epoch_iteration_counts(P, N, nz, nc, mr, epoch_len)[1])
    return 4.0 * P * (inputs + outputs), flops


def _track_floats(lanes: int, nseg: int) -> int:
    return lanes * (3 * nseg + 1) + 1


def nl_build_counts(P: int, N: int, n_agents: int, coupling: str,
                    lanes: int = 1, nseg: int = 1):
    """Bytes and operations of one NL SQP stage-QP build: per stage the
    state and input and, per neighbour, its position at the next stage and
    its price (and hp_opt's plane); per problem the state of stage N, the
    gains, limits, lane and master mask; the track's tables once; every
    output field of the stage QP written once (F, G, d, R, r, S, D, E and
    four row bounds over N stages, Q and q over N + 1).
    ``NL_OPS_PER_STAGE`` per stage for the Jacobians, the discrete model
    and the rows."""
    nb = max(n_agents - 1, 1)
    _, nc, m = nl_shape(n_agents, coupling)
    per_stage = NX + NU + nb * (3 + (2 if coupling == "hp_opt" else 0))
    per_problem = 16 + 9 + 1 + nb
    out = (N * (NZ * NZ + NZ * nc + NZ + nc * nc + nc + NZ * nc
                + m * (NZ + nc + 4))
           + (N + 1) * (NZ * NZ + NZ))
    inp = N * per_stage + NX + per_problem
    nbytes = 4.0 * (P * (inp + out) + _track_floats(lanes, nseg))
    return nbytes, float(NL_OPS_PER_STAGE) * P * N


def bound_s(nbytes: float, flops: float):
    """The least time the card could take for work of ``nbytes`` and
    ``flops``, and which of the two sets it: ``(seconds, "bytes" |
    "operations")``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
