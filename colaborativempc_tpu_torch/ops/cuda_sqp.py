"""Hand-written CUDA kernels that build the SQP stage QPs of the nonlinear
planners, one launch per SQP iteration.

The kernels live in ``csrc/sqp_qp.cu`` (design notes there) and are built
by ``ops/_build.py`` at the first CUDA launch. :func:`nl_qp_batched`
replaces ``planners/nl.py build_nl_qp_plain`` (the linearisation of the
bicycle model, the lift, the track lookups, the cost and every row, for the
eu, hp and hp_opt couplings); :func:`mpcc_qp_batched` replaces
``planners/mpcc.py build_mpcc_qp_plain`` (the Pacejka linearisation, the
tyre rows and their Jacobians, the cost and every row). ``build_nl_qp`` and
``build_mpcc_qp`` pick one of the two by device, as ``ops/admm.py
admm_epoch_inputs`` does; the wrappers here take CUDA tensors only and
raise on anything they cannot take (device, dtype, shape, layout) — there
is no fallback to the plain version. Each counts its launches in a plain
integer attribute (``nl_qp_batched.launches``,
``mpcc_qp_batched.launches``), incremented only where the kernel is
launched. These attributes and ``ops/cuda_lqr.py``'s are the port's
counters; its spans are in ``utils/tracing.py``.

The wrappers pass the gains and limits (numbers, or tensors shared or per
problem) to the kernel as slots (:func:`pack_slots`: a pointer and a
per-problem stride into the caller's tensor, or the number itself), the
lane as a number or a per-problem tensor and the track's tables as they
are, and allocate the outputs at once (:func:`_outputs`: one
``torch.empty``, each field a contiguous view of it; a returned QP belongs
to its caller, nothing is reused). The arrays of numbers the kernel takes
(the model's constants, the slots' numbers, the ints) are built once per
distinct value and kept. The slot packing, the output layout, the order of
the batched matrix-vector products (:func:`matvec_order`) and the traffic
counts (:func:`sqp_qp_traffic`) are plain Python, so the CPU tests reach
them.
"""

from __future__ import annotations

import array
import ctypes
import functools
import math
import struct
from typing import NamedTuple

import numpy as np
import torch

from colaborativempc_tpu_torch.ops.admm import StageQP
from colaborativempc_tpu_torch.ops.cuda_lqr import (
    _check, _cuda_device, _on, _raise_on,
)
from colaborativempc_tpu_torch.ops.lqr import LQRCost, LQRDynamics

NX, NU, NZ, NC = 9, 2, 11, 2
SOFT_WEIGHT_CAP = 1e4    # planners/lpv.py SOFT_WEIGHT_CAP
LOW_VEL_THRESH = 0.2     # dynamics/bicycle.py LOW_VEL_THRESH
DIST_EPS = 1e-6          # planners/nl.py _EPS
PLANE_TRUST_THETA, PLANE_TRUST_B, PLANE_REG = 0.3, 0.2, 0.1  # planners/nl.py
SLIP_VX_FLOOR = 0.3      # dynamics/pacejka.py slip_angles
MPCC_HALFWIDTH_SM = 0.95  # planners/mpcc.py build_mpcc_qp
MPCC_ROWS = 7
COUPLINGS = ("eu", "hp", "hp_opt")

# The card's cuBLAS order for a batch of matrix-vector products, by the
# matrices' layout (the NL build's are row-major, torch.func's MPCC
# Jacobians column-major) and the batch size (problems x stages), read off
# torch 2.11.0+cu128, CUDA 12.8, NVIDIA H100 80GB HBM3 by
# scripts/library_order.py --parts matvec: HALVES, two fused multiply-add chains from zero
# over [0, ceil(n/2)) and the rest; EVEN_ODD, chains over the even and the
# odd terms; QUARTERS, chains over [0, 4), [4, 8), [8, ...) summed as a
# butterfly. Each range below is (first batch, last batch, order); the
# script read up to 60,000, and a larger batch takes HALVES unread (a field
# the library orders otherwise is then held to the plain version within
# the checks' tolerance).
HALVES, EVEN_ODD, QUARTERS = 0, 1, 2
MATVEC_ORDERS = {
    "row": ((1, 12_997, HALVES), (12_998, 37_292, EVEN_ODD),
            (37_293, 60_000, HALVES)),
    "col": ((1, 189, QUARTERS), (190, 1_335, HALVES),
            (1_336, 2_852, EVEN_ODD), (2_853, 60_000, HALVES)),
}


def matvec_order(batch: int, layout: str = "row") -> int:
    """The order the build kernel gives its matrix-vector products for a
    build of ``batch`` = problems x stages whose plain version multiplies
    ``layout`` (``row`` for NL, ``col`` for MPCC) matrices."""
    for lo, hi, order in MATVEC_ORDERS[layout]:
        if lo <= batch <= hi:
            return order
    return HALVES


def nl_shape(nb: int, coupling: str):
    """``(nc, m)`` of the NL stage QP: stage controls and rows per stage."""
    if coupling not in COUPLINGS:
        raise ValueError(f"coupling {coupling!r}: one of {COUPLINGS}")
    hp_opt = coupling == "hp_opt"
    return NC + (2 * nb if hp_opt else 0), 4 + (3 * nb if hp_opt else nb)


OPS_PER_STAGE = 300   # FP32 operations of one stage, rounded up


def sqp_qp_traffic(P: int, N: int, nc: int, m: int, per_stage_in: int,
                   per_problem_in: int, shared_in: int):
    """Bytes and FP32 operations of one build, the least the function
    needs. Bytes, in float32: each input read once (``per_stage_in`` floats
    per stage, ``per_problem_in`` per problem, the state of stage N, and
    ``shared_in`` floats that every problem shares: the track's tables) and
    each output field of the StageQP written once: F, G, d, R, r, S, D, E
    and four row bounds over N stages, Q and q over N + 1. Operations:
    ``OPS_PER_STAGE`` per stage for the Jacobians, the discrete model and
    the rows, whose time is far below the bytes'."""
    out = (N * (NZ * NZ + NZ * nc + NZ + nc * nc + nc + NZ * nc
                + m * (NZ + nc + 4))
           + (N + 1) * (NZ * NZ + NZ))
    inp = N * per_stage_in + NX + per_problem_in
    return 4.0 * (P * (inp + out) + shared_in), float(OPS_PER_STAGE) * P * N


def _track_floats(lanes: int, nseg: int) -> int:
    return lanes * (3 * nseg + 1) + 1


def nl_traffic(P: int, N: int, nb: int, coupling: str, lanes: int = 1,
               nseg: int = 1):
    """:func:`sqp_qp_traffic` of :func:`nl_qp_batched`: per stage the
    state and input and, per neighbour, its position at the next stage and
    its price (and hp_opt's plane); per problem the gains, the limits, the
    lane and the master mask; the track's tables once."""
    nc, m = nl_shape(nb, coupling)
    per_stage = NX + NU + nb * (3 + (2 if coupling == "hp_opt" else 0))
    return sqp_qp_traffic(P, N, nc, m, per_stage, 16 + 9 + 1 + nb,
                          _track_floats(lanes, nseg))


def mpcc_traffic(P: int, N: int, lanes: int = 1, nseg: int = 1):
    """:func:`sqp_qp_traffic` of :func:`mpcc_qp_batched`: per stage the
    state and input, per race the gains, the track's tables once."""
    return sqp_qp_traffic(P, N, NC, MPCC_ROWS, NX + NU, 10,
                          _track_floats(lanes, nseg))


# --- the kernels' arguments -------------------------------------------------

NL_SLOTS, MPCC_SLOTS = 16 + 9, 10   # csrc/sqp_qp.cu kNLSlots, kMPCCSlots
# csrc/sqp_qp.cu kThreads, kStages, kMaxSeg, kPair: a block of 256 threads
# builds up to 8 stages of one problem (MPCC always 8); a lane's track rows
# are staged in shared memory up to 2048 segments; each (stage, neighbour)
# pair keeps 9 scalars
THREADS, STAGES_PER_BLOCK, MAX_STAGED_SEGMENTS, PAIR_FLOATS = 256, 8, 2048, 9
# the dynamic shared memory a block may take beside the kernels' static
# arrays (under 1 KB)
SQP_SMEM_LIMIT = 232_448 - 2_048


class SqpPlan(NamedTuple):
    threads: int      # per block
    stages: int       # per block
    blocks: int       # stage groups x problems
    smem_bytes: int   # dynamic shared memory per block
    # "image" where the image and the neighbour arrays of every block lie
    # in a global scratch of scratch_bytes (NL only), else empty
    spilled: str = ""
    scratch_bytes: int = 0


def image_floats(nc: int, m: int, stages: int = STAGES_PER_BLOCK) -> int:
    """Floats of a block's output image in shared memory (the source's
    ``image_floats``): every StageQP field of its stages."""
    return stages * (2 * NZ * NZ + 2 * NZ + 2 * NZ * nc + nc * nc + nc
                     + m * (NZ + nc + 4))


def neighbour_floats(nb: int, hp_opt: bool, stages: int) -> int:
    """Floats of the NL kernel's neighbour arrays (the source's
    ``neighbour_floats``): per stage and neighbour its position, price and
    the pair's scalars (hp_opt: its plane), the master flags and the cost's
    R diagonal."""
    return (nb * (stages * (3 + PAIR_FLOATS) + 1)
            + (2 * nb * stages + 2 * nb if hp_opt else 0) + 2)


def sqp_qp_plan(P: int, N: int, nc: int, m: int, nseg: int,
                nb=None, hp_opt: bool = False, spill=None) -> SqpPlan:
    """The launch of one build: the image, the NL neighbour arrays (``nb``
    neighbours; ``None`` for MPCC) and, where they fit, the lane's three
    track rows in dynamic shared memory (the source's ``smem_bytes``). 8
    stages per block; an NL build takes the most that fit in
    ``SQP_SMEM_LIMIT`` bytes. Where one stage does not fit, the image and
    the neighbour arrays of 8 stages per block go into a global scratch
    (``spilled`` ``"image"``) and only the track rows stay in shared
    memory. ``spill`` pins the choice (NL only). Raises where P or N is
    below 1, or where a pinned choice does not fit."""
    if P < 1 or N < 1:
        raise ValueError(f"P={P}, N={N}: a build takes P, N >= 1")
    staged = 3 * nseg if nseg <= MAX_STAGED_SEGMENTS else 0
    if not spill:
        for S in range(STAGES_PER_BLOCK, 0 if nb is not None else 7, -1):
            extra = 0 if nb is None else neighbour_floats(nb, hp_opt, S)
            smem = 4 * (image_floats(nc, m, S) + extra + staged)
            if smem <= SQP_SMEM_LIMIT:
                return SqpPlan(THREADS, S, -(-N // S) * P, smem)
    if nb is None or spill is False:
        least = 4 * (image_floats(nc, m, 1) + staged + (
            0 if nb is None else neighbour_floats(nb, hp_opt, 1)))
        raise ValueError(
            f"nc={nc}, m={m}, {nb} neighbours, {nseg} track segments, "
            f"spill={spill}: one stage of the build takes {least} bytes of "
            f"shared memory, more than the {SQP_SMEM_LIMIT} a block may "
            "take, and the spill is pinned off (MPCC has none)")
    S = STAGES_PER_BLOCK
    blocks = -(-N // S) * P
    return SqpPlan(THREADS, S, blocks, 4 * staged, "image", 4 * blocks * (
        image_floats(nc, m, S) + neighbour_floats(nb, hp_opt, S)))


def nl_fields(gains, limits):
    """The NL kernel's per-problem scalars in slot order, as ``(value,
    width)``: the gains q (9), r (2), dr (2), qs (3), then the ``SysLimits``
    fields."""
    return ([(gains.q, NX), (gains.r, NU), (gains.dr, NC), (gains.qs, 3)]
            + [(v, 1) for v in limits])


def mpcc_fields(gains):
    """The MPCC kernel's per-race scalars in slot order: the
    ``MPCCGains`` fields."""
    return [(v, 1) for v in gains]


def pack_slots(fields, P: int, device):
    """The kernel's slots for ``fields`` (``(value, width)`` pairs, each
    value numbers or a tensor of ``width`` entries per problem, shared or
    one row per problem): per slot a device pointer (``None`` for a number),
    the stride from one problem to the next in floats (0: shared) and the
    float32 number a missing pointer stands for; and the tensors the
    pointers point into. A tensor is moved to ``device`` in float32, as the
    plain versions take it (one already there is taken as it is); nothing
    is packed into a new tensor."""
    device = torch.device(device)
    ptrs, strides, numbers, keep = [], [], [], []
    for v, k in fields:
        if isinstance(v, torch.Tensor):
            t = v if (v.dtype is torch.float32 and v.is_contiguous()
                      and v.device == device) else v.to(
                device=device, dtype=torch.float32).contiguous()
            n = t.numel()
            if n == k:                    # one row, shared
                keep.append(t)
                base = t.data_ptr()
                ptrs += [base + 4 * j for j in range(k)]
                strides += [0] * k
            elif n == P * k:              # a row per problem
                keep.append(t)
                base = t.data_ptr()
                ptrs += [base + 4 * j for j in range(k)]
                strides += [k] * k
            else:
                raise ValueError(f"a per-problem value of shape "
                                 f"{tuple(v.shape)}: {k} entries for 1 or "
                                 f"{P} problems expected")
            numbers += [0.0] * k
        else:
            ptrs += [None] * k
            strides += [0] * k
            if k == 1 and isinstance(v, (int, float)):
                numbers.append(v)
            else:
                numbers += np.asarray(v, np.float64).reshape(k).tolist()
    # float32 values, as float() of np.float32 gives them
    values = array.array("f", numbers).tolist()
    return ptrs, strides, values, keep


def pack_lane(lane, P: int, device):
    """The lane of every problem: a number as it is (a kernel argument),
    a tensor as ``(P,)`` int32 on ``device``."""
    if isinstance(lane, torch.Tensor):
        t = lane.to(device=device, dtype=torch.int32).reshape(-1)
        if t.shape[0] not in (1, P):
            raise ValueError(f"lane: {t.shape[0]} entries for {P} problems")
        return t.expand(P).contiguous()
    return int(lane)


def nl_consts(model, dt, coupling: str, u_trust) -> list:
    """The NL kernel's constants (``NLConst`` of the source), as the plain
    version's Python expressions form them in double precision."""
    p = model
    ut = (0.0, 0.0) if u_trust is None else u_trust
    a = p.Cf / p.m
    return [LOW_VEL_THRESH, -p.mu, a, -a, p.lf, p.Cf, p.Cr, p.m, p.I,
            p.lf * p.Cf, p.lr * p.Cr, p.lf ** 2 * p.Cf, p.lr ** 2 * p.Cr,
            p.lf * p.Cf / p.I, float(dt), DIST_EPS,
            0.5 if coupling == "hp" else 1.0, float(ut[0]), float(ut[1]),
            PLANE_TRUST_THETA, PLANE_TRUST_B, 2.0 * PLANE_REG]


def _rcp32(v) -> float:
    """1 / v as the card's float32 division of 1 by v in float32 rounds
    it."""
    return float(np.float32(1.0) / np.float32(v))


def mpcc_consts(p, dt, bounds) -> list:
    """The MPCC kernel's constants (``MPCCConst`` of the source)."""
    return [p.lf, p.lr, p.Bf, p.Cf, p.Df, p.Br, p.Cr, p.Dr, p.Cm1, p.Cm2,
            p.Cr0, p.Cr2, p.m, p.p_long, (p.p_ell * p.Dr) ** 2,
            p.max_alpha, -p.max_alpha, float(dt), bounds.trust_delta,
            bounds.trust_drive, -bounds.delta_max, bounds.delta_max,
            bounds.drive_min, bounds.drive_max, bounds.vx_min,
            SLIP_VX_FLOOR, MPCC_HALFWIDTH_SM, 1.0 / p.m, 1.0 / p.I,
            _rcp32(p.m), _rcp32(p.I)]


# --- the launches -----------------------------------------------------------

def _track_args(track, device):
    """The track's tables the kernel reads, checked and made contiguous
    (a table built from a broadcast array may not be)."""
    nl, ns = track.s0.shape
    tables = [getattr(track, k).contiguous()
              for k in ("s0", "curv", "halfwidth", "track_length")]
    for k, t in zip(("s0", "curv", "halfwidth"), tables):
        _check(f"track.{k}", t, (nl, ns), device)
    _check("track.track_length", tables[3], (nl,), device)
    _check("track.open_flag", track.open_flag, (), device, torch.bool)
    return tables + [track.open_flag], ns


@functools.lru_cache(maxsize=256)
def output_layout(P: int, N: int, nc: int, m: int):
    """The StageQP's fields in the kernel's order (F, G, d, Q, q, R, r, S,
    D, E, lo, hi, soft_lo, soft_hi), back to back in one allocation: per
    field its shape, its contiguous strides and its offset in floats, and
    the floats of them all."""
    shapes = ((P, N, NZ, NZ), (P, N, NZ, nc), (P, N, NZ),
              (P, N + 1, NZ, NZ), (P, N + 1, NZ), (P, N, nc, nc), (P, N, nc),
              (P, N, NZ, nc), (P, N, m, NZ), (P, N, m, nc), (P, N, m),
              (P, N, m), (P, N, m), (P, N, m))
    fields, at = [], 0
    for sh in shapes:
        strides = tuple(math.prod(sh[i + 1:]) for i in range(len(sh)))
        fields.append((sh, strides, at))
        at += math.prod(sh)
    return tuple(fields), at


def _outputs(P, N, nc, m, device):
    """The StageQP's fields in the kernel's order: views of one new
    allocation, each contiguous, none overlapping another."""
    fields, total = output_layout(P, N, nc, m)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    return [flat.as_strided(sh, st, at) for sh, st, at in fields]


def _stage_qp(outs) -> StageQP:
    F, G, d, Q, q, R, r, S, D, E, lo, hi, slo, shi = outs
    return StageQP(dyn=LQRDynamics(F=F, G=G, d=d),
                   cost=LQRCost(Q=Q, q=q, R=R, r=r, S=S), D=D, E=E, lo=lo,
                   hi=hi, soft_lo=slo, soft_hi=shi)


# The arrays of numbers the kernels take, built once per distinct value and
# kept. Floats are keyed by their bits: Python holds 0.0 and -0.0 equal,
# with one hash, but the kernel tells them apart.
_KEPT: dict = {}


def _kept(key, make):
    """``make()``, built once per ``key`` and kept (up to 512 keys, then
    the store starts again)."""
    got = _KEPT.get(key)
    if got is None:
        if len(_KEPT) >= 512:
            _KEPT.clear()
        got = _KEPT[key] = make()
    return got


def _bits(values) -> bytes:
    return struct.pack(f"{len(values)}d", *values)


def _doubles(values):
    return _kept(("doubles", _bits(values)),
                 lambda: (ctypes.c_double * len(values))(*values))


def _ints(values: tuple):
    return _kept(("ints", values),
                 lambda: (ctypes.c_int * len(values))(*values))


def _nl_consts_array(model, dt: float, coupling: str, u_trust):
    key = ("nl", coupling, u_trust is None,
           _bits((*model, dt, *(u_trust or ()))))
    return _kept(key, lambda: _doubles(nl_consts(model, dt, coupling,
                                                 u_trust)))


def _mpcc_consts_array(p, dt: float, bounds):
    return _kept(("mpcc", _bits((*p, dt, *bounds))),
                 lambda: _doubles(mpcc_consts(p, dt, bounds)))


def _pointers(tensors, addresses):
    """The kernel's pointer array: the tensors' device pointers (None:
    null), then the addresses (None: null), as 64-bit integers (the array
    must live until the launch has read it)."""
    return array.array("Q", [0 if t is None else t.data_ptr()
                             for t in tensors]
                       + [0 if a is None else a for a in addresses])


def _nl_args(track, gains, limits, model, N, dt, x_bar, u_bar, lambdas,
             neigh_xy, master_mask, u_trust, coupling, lane, planes0):
    """Check the arguments of one NL build and allocate its outputs.
    Returns the arguments of ``cmpc_nl_qp`` up to the stream, the outputs,
    the device and the tensors the pointers point into."""
    nb = neigh_xy.shape[-2]
    dev = _cuda_device(x_bar)
    P = x_bar.shape[0]
    nc, m = nl_shape(nb, coupling)
    hp_opt = coupling == "hp_opt"
    _check("x_bar", x_bar, (P, N + 1, NX), dev)
    _check("u_bar", u_bar, (P, N, NU), dev)
    _check("lambdas", lambdas, (P, nb, N), dev)
    _check("neigh_xy", neigh_xy, (P, N + 1, nb, 2), dev)
    _check("master_mask", master_mask, (P, nb), dev)
    if hp_opt:
        _check("planes0", planes0, (P, nb, N, 2), dev)
    sp, ss, sv, alive = pack_slots(nl_fields(gains, limits), P, dev)
    ln = pack_lane(lane, P, dev)
    lane_t = ln if isinstance(ln, torch.Tensor) else None
    tr, nseg = _track_args(track, dev)
    outs = _outputs(P, N, nc, m, dev)
    if u_trust is not None:
        u_trust = tuple(float(v) for v in u_trust)
    plan = sqp_qp_plan(P, N, nc, m, nseg, nb, hp_opt)
    scratch = (torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                           device=dev) if plan.spilled else None)
    ptrs = _pointers([x_bar, u_bar, lambdas, neigh_xy, master_mask,
                      planes0 if hp_opt else None, lane_t, *tr, *outs],
                     sp + [None if scratch is None else scratch.data_ptr()])
    ints = (P, N, nb, COUPLINGS.index(coupling), int(u_trust is not None),
            matvec_order(P * N, "row"), nseg,
            0 if lane_t is not None else ln, plan.smem_bytes, plan.stages,
            *ss)
    args = (ptrs, _nl_consts_array(model, float(dt), coupling, u_trust),
            _doubles(sv), _ints(ints))
    return args, outs, dev, alive + [lane_t, tr, scratch], plan


def _mpcc_args(track, gains, p, N, dt, x_bar, u_bar, bounds):
    """Check the arguments of one MPCC build and allocate its outputs, as
    :func:`_nl_args`."""
    dev = _cuda_device(x_bar)
    P = x_bar.shape[0]
    _check("x_bar", x_bar, (P, N + 1, NX), dev)
    _check("u_bar", u_bar, (P, N, NU), dev)
    sp, ss, sv, alive = pack_slots(mpcc_fields(gains), P, dev)
    tr, nseg = _track_args(track, dev)
    outs = _outputs(P, N, NC, MPCC_ROWS, dev)
    plan = sqp_qp_plan(P, N, NC, MPCC_ROWS, nseg)
    ints = (P, N, matvec_order(P * N, "col"), nseg, plan.smem_bytes, *ss)
    args = (_pointers([x_bar, u_bar, *tr, *outs], sp),
            _mpcc_consts_array(p, float(dt), bounds),
            _doubles(sv), _ints(ints))
    return args, outs, dev, alive + [tr], plan


def nl_qp_batched(track, gains, limits, model, N: int, dt, x_bar, u_bar,
                  lambdas, neigh_xy, master_mask, u_trust=(0.06, 0.6),
                  coupling: str = "eu", lane=0, planes0=None) -> StageQP:
    """The NL SQP stage QPs of P problems on the card, in one launch of
    ``cmpc_nl_qp``: the arguments and the result as
    ``planners/nl.py build_nl_qp`` (float32, contiguous CUDA tensors;
    ``planes0`` for hp_opt only). Limits are taken in float32."""
    from colaborativempc_tpu_torch.ops import _build
    args, outs, dev, alive, _ = _nl_args(
        track, gains, limits, model, N, dt, x_bar, u_bar, lambdas, neigh_xy,
        master_mask, u_trust, coupling, lane, planes0)
    lib = _build.load()
    ptrs, *rest = args
    with _on(dev):
        err = lib.cmpc_nl_qp(ptrs.buffer_info()[0], *rest,
                             torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "nl_qp_batched")
    nl_qp_batched.launches += 1
    return _stage_qp(outs)


nl_qp_batched.launches = 0


def mpcc_qp_batched(track, gains, p, N: int, dt, x_bar, u_bar,
                    bounds) -> StageQP:
    """The MPCC SQP stage QPs of B races on the card, in one launch of
    ``cmpc_mpcc_qp``: the arguments and the result as
    ``planners/mpcc.py build_mpcc_qp`` (float32, contiguous CUDA
    tensors)."""
    from colaborativempc_tpu_torch.ops import _build
    args, outs, dev, alive, _ = _mpcc_args(track, gains, p, N, dt, x_bar,
                                           u_bar, bounds)
    lib = _build.load()
    ptrs, *rest = args
    with _on(dev):
        err = lib.cmpc_mpcc_qp(ptrs.buffer_info()[0], *rest,
                               torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "mpcc_qp_batched")
    mpcc_qp_batched.launches += 1
    return _stage_qp(outs)


mpcc_qp_batched.launches = 0


def sqp_qp_clocked(family: str, source=None, **kw):
    """:func:`nl_qp_batched` (``family`` ``nl``) or :func:`mpcc_qp_batched`
    (``mpcc``) on the keyword arguments ``kw``, through the clock-stamped
    build of the kernels (``ops/_build.py load_sqp_qp_clocks``; ``source``
    another copy of ``sqp_qp.cu`` with the same entries). A measurement
    tool, not counted in the wrappers' launches. Returns the
    StageQP, the stamps ``(P * stage groups, stamps, 3)`` int64 (label,
    thread 0's clock, the last warp's clock at each stamp of a block, in
    order) and the labels' names."""
    from colaborativempc_tpu_torch.ops import _build
    if family == "nl":
        kw = dict(dict(u_trust=(0.06, 0.6), coupling="eu", lane=0,
                       planes0=None), **kw)
        args, outs, dev, alive, plan = _nl_args(**kw)
    else:
        args, outs, dev, alive, plan = _mpcc_args(**kw)
    lib = _build.load_sqp_qp_clocks(source)
    n = lib.cmpc_sqp_qp_clock_stamps()
    blocks = plan.blocks
    clocks = torch.full((blocks, n, 3), -1, dtype=torch.int64, device=dev)
    entry = (lib.cmpc_nl_qp_clocked if family == "nl"
             else lib.cmpc_mpcc_qp_clocked)
    ptrs, *rest = args
    with _on(dev):
        err = entry(ptrs.buffer_info()[0], *rest,
                    torch.cuda.current_stream(dev).cuda_stream,
                    clocks.data_ptr(), n)
    _raise_on(err, f"sqp_qp_clocked ({family})")
    names = lib.cmpc_sqp_qp_clock_names().decode().split(";")
    return _stage_qp(outs), clocks, names
