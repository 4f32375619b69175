"""Hand-written CUDA kernels for the batched LQR affine pass, the whole
ADMM epoch and the epoch's fixed data, the first two beside their plain
PyTorch twins.

Counterpart of ``colaborativempc_tpu/ops/pallas_lqr.py``. The kernels live
in ``csrc/lqr_kernels.cu`` and ``csrc/epoch_data.cu`` (design notes there)
and are built by ``ops/_build.py`` at the first CUDA launch.

A wrapper launches its kernel for CUDA tensors and runs its ``*_plain`` twin
for CPU tensors; a CUDA tensor it cannot take (wrong dtype, shape, layout or
device) raises — there is no fallback from the CUDA path to the plain one.
:func:`epoch_data_batched` takes CUDA tensors only: its plain version is
``ops/admm.py admm_epoch_inputs_plain``, and ``ops/admm.py
admm_epoch_inputs`` picks one of the two by device. Each wrapper counts its
kernel launches in a plain integer attribute
(``admm_epoch_batched.launches``, ``lqr_affine_solve_batched.launches``,
``epoch_data_batched.launches``), incremented only where the kernel is
launched. These attributes and ``ops/cuda_sqp.py``'s are the port's
counters; its spans are in ``utils/tracing.py``.

Layout: row-major with the batch of problems first, ``(P, N, ...)``;
``Quu_inv`` is the explicit inverse of the nc x nc ``Quu`` (as in the
Pallas kernels).

:func:`kernel_plan` chooses each epoch or affine launch's QPs per block,
ring depth and shared-memory bytes from the shapes and the card's SM count;
:func:`epoch_data_plan` the epoch-data launch's threads, chunk of stages and
shared memory. Where a block's shared memory does not hold a QP, a plan
names what it keeps in global memory instead (``spilled``) and the
scratch that takes (``scratch_bytes``, allocated by the wrapper with
``torch.empty`` on the tensors' device); the kernels' arithmetic is the
same either way. Both are plain Python, so the CPU tests reach them.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

# NVIDIA H100 (sm_90): dynamic shared memory a block may use, shared memory
# of an SM (each resident block reserves 1 KB of it), resident blocks and
# warps per SM, registers per SM, and its SM count.
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1_024
MAX_BLOCKS_PER_SM = 32
MAX_WARPS_PER_SM = 64
REGISTERS_PER_SM = 65_536
H100_SMS = 132
_RING_CANDIDATES = (32, 16, 8, 4, 2, 1)


# What an epoch or affine launch keeps in global memory, by level (the
# source's Spill): nothing; w, y and kff over the horizon; those and the
# ring of fixed data (read where it lies in the inputs); those and the
# chunk scratch (no shared memory at all).
SPILLS = ("", "horizon", "horizon+ring", "horizon+ring+chunk")


class KernelPlan(NamedTuple):
    """One launch's geometry: ``qps_per_block`` warps (one QP each) per
    block; ``ring`` stages per ring slot (``>= N``: the whole horizon is
    resident and loads once per launch, else two slots stream chunks of
    ``ring`` stages; from ``horizon+ring`` the stages of one chunk of the
    QP's scratch); ``smem_bytes`` of dynamic shared memory per block;
    ``waves``, the rounds of blocks the card runs one after another;
    ``spilled``, what lies in global memory (one of :data:`SPILLS`), and
    ``scratch_bytes``, the global scratch that takes."""
    qps_per_block: int
    ring: int
    smem_bytes: int
    waves: int
    spilled: str = ""
    scratch_bytes: int = 0

    @property
    def spill(self) -> int:
        """The level of :data:`SPILLS` (the source's ``Spill``)."""
        return SPILLS.index(self.spilled)


def stage_floats(nz: int, nc: int, mr: int) -> int:
    """Floats of one stage's fixed data in a ring slot (``stage_floats`` of
    ``csrc/lqr_kernels.cu``)."""
    return nz * nz + 3 * nz * nc + nc * nc + 3 * nz + nc + mr * (nz + nc + 5)


def qp_floats(N: int, ring: int, nz: int, nc: int, mr: int,
              spill: int = 0) -> int:
    """Floats of one QP's work at spill level ``spill`` (``qp_floats`` of
    the source): w, y, kff over the horizon (below level 1), one chunk's
    scratch, one or two ring slots (below level 2). In shared memory, or
    in the global scratch at level 3."""
    S = min(ring, N)
    slots = 0 if spill >= 2 else (1 if ring >= N else 2)
    horizon = 0 if spill >= 1 else 2 * N * mr + N * nc
    return (horizon + (S + 1) * nz + S * (nz + mr + nc) + nc
            + slots * S * stage_floats(nz, nc, mr))


def kernel_plan(P: int, N: int, nz: int, nc: int, mr: int,
                sms: int = H100_SMS, ring: Optional[int] = None,
                qps_per_block: Optional[int] = None,
                spill: Optional[int] = None) -> KernelPlan:
    """The launch plan for P QPs of horizon N (``mr = 0``: the affine
    kernel). Among the whole horizon and rings of 32, 16, 8, 4, 2 and 1
    stages, and 1 to 4 QPs per block, it takes the fewest waves; then the
    resident horizon over a streamed ring, the deeper ring, the plan spread
    over more SMs, and more QPs per block. So the horizon stays resident
    when every QP's horizon fits on the card at once, and streams when a
    ring saves waves. Where no plan fits one block's shared memory, it
    takes the first spill level of :data:`SPILLS` at which one does (the
    last needs no shared memory). ``ring``, ``qps_per_block`` and
    ``spill`` (a level) pin a choice. Raises on dimensions below 1 (mr
    below 0), past 32 states (lane i owns state row i), and where the
    pinned choices fit no block."""
    if min(P, N, nz, nc) < 1 or mr < 0:
        raise ValueError(f"P={P}, N={N}, nz={nz}, nc={nc}, mr={mr}: the "
                         "ADMM epoch and affine kernels take P, N, nz, nc "
                         ">= 1 and mr >= 0")
    if nz > 32:
        raise ValueError(f"nz={nz}: the ADMM epoch and affine kernels take "
                         "at most 32 states (one lane per state row)")
    rings = ([ring] if ring is not None else
             [N] + [r for r in _RING_CANDIDATES if r < N])
    qpbs = [qps_per_block] if qps_per_block is not None else [4, 3, 2, 1]
    for level in [spill] if spill is not None else range(len(SPILLS)):
        best, best_key = None, None
        for R in rings:
            per_qp = 4 * qp_floats(N, R, nz, nc, mr, level)
            for qpb in qpbs:
                smem = 0 if level == 3 else qpb * per_qp
                if smem > SMEM_PER_BLOCK:
                    continue
                per_sm = min(MAX_BLOCKS_PER_SM, MAX_WARPS_PER_SM // qpb,
                             SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK))
                blocks = -(-P // qpb)
                waves = -(-blocks // (sms * per_sm))
                key = (waves, R < N, -min(R, N), -min(sms, blocks), -qpb)
                if best_key is None or key < best_key:
                    scratch = ((4 * P * N * nc if level >= 1 else 0)
                               + (P * per_qp if level == 3 else 0))
                    best_key = key
                    best = KernelPlan(qpb, min(R, N), smem, waves,
                                      SPILLS[level], scratch)
        if best is not None:
            return best
    raise ValueError(
        f"no launch plan fits P={P}, N={N}, nz={nz}, nc={nc}, mr={mr}, "
        f"ring={ring}, qps_per_block={qps_per_block}, spill={spill}: one QP "
        f"takes at least "
        f"{4 * min(qp_floats(N, R, nz, nc, mr, spill) for R in rings)} "
        f"bytes of shared memory, more than the {SMEM_PER_BLOCK} a block "
        "has")


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def lqr_affine_solve_batched_plain(F, G, d, K, Quu_inv, Qxu, m, q, r, z0):
    """Plain twin of :func:`lqr_affine_solve_batched`."""
    N = F.shape[1]
    p = q[:, N]
    kff = [None] * N
    for k in range(N - 1, -1, -1):
        t = p + m[:, k]
        Qu = r[:, k] + _mv(G[:, k].transpose(-1, -2), t)
        kff[k] = -_mv(Quu_inv[:, k], Qu)
        p = q[:, k] + _mv(F[:, k].transpose(-1, -2), t) + _mv(Qxu[:, k], kff[k])
    z, zs, cs = z0, [z0], []
    for k in range(N):
        c = _mv(K[:, k], z) + kff[k]
        z = _mv(F[:, k], z) + _mv(G[:, k], c) + d[:, k]
        zs.append(z)
        cs.append(c)
    return torch.stack(zs, 1), torch.stack(cs, 1)


def admm_epoch_batched_plain(data, z0, w0, y0, *, epoch_len: int = 25,
                             alpha: float = 1.6, affine=None):
    """Plain twin of :func:`admm_epoch_batched`: ``epoch_len`` ADMM
    iterations with the fixed factorisation in ``data`` (an
    ``ops/admm.py ADMMEpochData`` with leading batch axis P).

    ``affine(q, r) -> (z, c)`` is each iteration's inner affine solve from
    ``z0``; by default the kernel's sequential pass over ``data``'s factors
    (``ops/admm.py admm_epoch_assoc`` passes the associative one)."""
    N = data.F.shape[1]
    if affine is None:
        def affine(q, r):
            return lqr_affine_solve_batched_plain(
                data.F, data.G, data.d, data.K, data.Quu_inv, data.Qxu,
                data.m, q, r, z0)
    mask = (data.rv > 0).to(data.rv.dtype)
    w, y = w0, y0
    for _ in range(epoch_len):
        t = data.rv * (y - w)                               # (P, N, mr)
        q_pen = torch.sum(data.D * t[..., None], dim=-2)    # (P, N, nz)
        r_pen = torch.sum(data.E * t[..., None], dim=-2)    # (P, N, nc)
        q = torch.cat([data.q[:, :N] + q_pen, data.q[:, N:]], dim=1)
        z, c = affine(q, data.r + r_pen)
        v = _mv(data.D, z[:, :N]) + _mv(data.E, c)
        vhat = alpha * v + (1.0 - alpha) * w
        wbar = vhat + y
        w_new = torch.where(wbar > data.hi,
                            data.hi + data.fac_hi * (wbar - data.hi), wbar)
        w_new = torch.where(wbar < data.lo,
                            data.lo + data.fac_lo * (wbar - data.lo), w_new)
        y = y + vhat - w_new
        rp = torch.amax(torch.abs(mask * (v - w_new)), dim=1)
        rd = torch.amax(torch.abs(mask * (w_new - w)), dim=1)
        w = w_new
    return z, c, w, y, rp, rd


def _check(name, t, shape, device, dtype=torch.float32):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes "
                        f"{str(dtype).replace('torch.', '')}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _cuda_device(z0: torch.Tensor) -> torch.device:
    if z0.device.type != "cuda":
        raise ValueError(f"no kernel for device {z0.device}")
    return z0.device


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def _plan_for(dev, plan, P, N, nz, nc, mr) -> KernelPlan:
    if plan is not None:
        return plan
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return kernel_plan(P, N, nz, nc, mr, sms=sms)


def _spill_scratch(plan: KernelPlan, P, N, nz, nc, mr, dev):
    """The global scratch of a spilled plan, ``(kff, work)``, each a tensor
    or None where the plan keeps it in shared memory: kff over the horizon
    ``(P, N, nc)`` from level 1, each QP's work at level 3. Freed after the
    launch is queued, their memory goes only to work queued after it on the
    same stream."""
    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    kff = empty(P, N, nc) if plan.spill >= 1 else None
    work = (empty(P, qp_floats(N, plan.ring, nz, nc, mr, 3))
            if plan.spill == 3 else None)
    return kff, work


def _ptr_or_null(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def lqr_affine_solve_batched(F, G, d, K, Quu_inv, Qxu, m, q, r, z0, *,
                             plan: Optional[KernelPlan] = None):
    """Batched affine LQR solve with fixed factors.

    Args (leading batch axis P): F (P,N,nz,nz), G (P,N,nz,nc), d (P,N,nz),
    K (P,N,nc,nz), Quu_inv (P,N,nc,nc), Qxu (P,N,nz,nc), m (P,N,nz),
    q (P,N+1,nz), r (P,N,nc), z0 (P,nz). ``plan`` pins the launch plan
    (default :func:`kernel_plan` for the card).
    Returns z (P,N+1,nz), c (P,N,nc).
    """
    if z0.device.type == "cpu":
        return lqr_affine_solve_batched_plain(F, G, d, K, Quu_inv, Qxu, m,
                                              q, r, z0)
    dev = _cuda_device(z0)
    P, N, nz, nc = F.shape[0], F.shape[1], F.shape[2], G.shape[-1]
    shapes = dict(F=(P, N, nz, nz), G=(P, N, nz, nc), d=(P, N, nz),
                  K=(P, N, nc, nz), Quu_inv=(P, N, nc, nc),
                  Qxu=(P, N, nz, nc), m=(P, N, nz), q=(P, N + 1, nz),
                  r=(P, N, nc), z0=(P, nz))
    args = dict(F=F, G=G, d=d, K=K, Quu_inv=Quu_inv, Qxu=Qxu, m=m, q=q, r=r,
                z0=z0)
    for k, shape in shapes.items():
        _check(k, args[k], shape, dev)
    plan = _plan_for(dev, plan, P, N, nz, nc, 0)
    from colaborativempc_tpu_torch.ops import _build
    lib = _build.load()
    z = torch.empty((P, N + 1, nz), dtype=torch.float32, device=dev)
    c = torch.empty((P, N, nc), dtype=torch.float32, device=dev)
    kff, work = _spill_scratch(plan, P, N, nz, nc, 0, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cmpc_lqr_affine(
            *[_ptr(args[k]) for k in shapes], _ptr(z), _ptr(c),
            _ptr_or_null(kff), _ptr_or_null(work),
            P, N, nz, nc, plan.qps_per_block, plan.ring, plan.spill,
            plan.smem_bytes, ctypes.c_void_p(stream))
    _raise_on(err, "lqr_affine_solve_batched")
    lqr_affine_solve_batched.launches += 1
    return z, c


lqr_affine_solve_batched.launches = 0

_EPOCH_FIELDS = ("F", "G", "d", "K", "Quu_inv", "Qxu", "m", "q", "r", "D",
                 "E", "lo", "hi", "rv", "fac_lo", "fac_hi")


def admm_epoch_batched(data, z0, w0, y0, *, epoch_len: int = 25,
                       alpha: float = 1.6,
                       plan: Optional[KernelPlan] = None):
    """Run a full ADMM epoch for a batch of stage QPs.

    Args:
      data: ``ops/admm.py ADMMEpochData`` with a leading batch axis P on
        every field.
      z0 (P,nz), w0/y0 (P,N,mr): initial state / splitting warm starts.
      plan: pins the launch plan (default :func:`kernel_plan` for the card).
    Returns:
      z (P,N+1,nz), c (P,N,nc), w (P,N,mr), y (P,N,mr), r_prim (P,mr),
      r_dual (P,mr) — the last iteration's per-row-class residuals.
    """
    if z0.device.type == "cpu":
        return admm_epoch_batched_plain(data, z0, w0, y0,
                                        epoch_len=epoch_len, alpha=alpha)
    dev = _cuda_device(z0)
    P, N, nz = data.F.shape[0], data.F.shape[1], data.F.shape[2]
    nc, mr = data.G.shape[-1], data.lo.shape[-1]
    if epoch_len < 1:
        raise ValueError(f"epoch_len must be >= 1, got {epoch_len}")
    row = (P, N, mr)
    shapes = dict(F=(P, N, nz, nz), G=(P, N, nz, nc), d=(P, N, nz),
                  K=(P, N, nc, nz), Quu_inv=(P, N, nc, nc),
                  Qxu=(P, N, nz, nc), m=(P, N, nz), q=(P, N + 1, nz),
                  r=(P, N, nc), D=(P, N, mr, nz), E=(P, N, mr, nc), lo=row,
                  hi=row, rv=row, fac_lo=row, fac_hi=row)
    for k in _EPOCH_FIELDS:
        _check(k, getattr(data, k), shapes[k], dev)
    _check("z0", z0, (P, nz), dev)
    _check("w0", w0, row, dev)
    _check("y0", y0, row, dev)
    plan = _plan_for(dev, plan, P, N, nz, nc, mr)
    from colaborativempc_tpu_torch.ops import _build
    lib = _build.load()

    def out(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    z, c, w, y = out(P, N + 1, nz), out(P, N, nc), out(*row), out(*row)
    rp, rd = out(P, mr), out(P, mr)
    kff, work = _spill_scratch(plan, P, N, nz, nc, mr, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cmpc_admm_epoch(
            *[_ptr(getattr(data, k)) for k in _EPOCH_FIELDS],
            _ptr(z0), _ptr(w0), _ptr(y0),
            _ptr(z), _ptr(c), _ptr(w), _ptr(y), _ptr(rp), _ptr(rd),
            _ptr_or_null(kff), _ptr_or_null(work), P, N, nz, nc, mr,
            int(epoch_len),
            ctypes.c_float(alpha), plan.qps_per_block, plan.ring, plan.spill,
            plan.smem_bytes, ctypes.c_void_p(stream))
    _raise_on(err, "admm_epoch_batched")
    admm_epoch_batched.launches += 1
    return z, c, w, y, rp, rd


admm_epoch_batched.launches = 0


# --- the epoch's fixed data (csrc/epoch_data.cu) -----------------------------

_CHUNK_CANDIDATES = (8, 4, 2, 1)


class EpochDataPlan(NamedTuple):
    """One epoch-data launch's geometry: one block of ``threads`` per QP
    (:func:`epoch_data_threads`; each pass strides over what lies past
    them), stages streamed in chunks
    of ``chunk`` through two slots, ``smem_bytes`` of dynamic shared
    memory per block, ``blocks_per_sm`` resident at once, and ``waves``,
    the rounds of blocks the card runs one after another; ``spilled``,
    ``"block"`` where the block's whole layout lies in a global scratch of
    ``scratch_bytes`` (one per block), else empty."""
    threads: int
    chunk: int
    smem_bytes: int
    blocks_per_sm: int
    waves: int
    spilled: str = ""
    scratch_bytes: int = 0


def _round4(n: int) -> int:
    return -(-n // 4) * 4


EPOCH_DATA_REG_NC = 8   # csrc/epoch_data.cu kRegNC


def epoch_data_widths(nz: int, nc: int, mr: int):
    """Floats of a row in the kernel's shared memory (``width_z`` and
    ``width_r`` of ``csrc/epoch_data.cu``): a vector of nz entries and one
    of mr entries. Up to 32 in every dimension both 12 (nz, mr <= 12) or
    32; beyond, 12 (nz <= 12) or nz, and mr, each rounded up to whole
    float4s."""
    if max(nz, nc, mr) <= 32:
        w = 12 if nz <= 12 and mr <= 12 else 32
        return w, w
    return (12 if nz <= 12 else _round4(nz)), _round4(mr)


def epoch_data_stage_floats(nz: int, nc: int, mr: int) -> int:
    """Floats of one stage in a chunk slot (``data_stage_floats`` of the
    source): F and G transposed and d's two halves (rows of nz entries),
    D and E transposed and their weighted copies (rows of mr entries), a
    row of :func:`epoch_data_widths` each; Q, R, S, lo, hi and both soft
    weights, every field on whole float4s."""
    wz, wr = epoch_data_widths(nz, nc, mr)
    return ((nz + nc + 2) * wz + 2 * (nz + nc) * wr + _round4(nz * nz)
            + _round4(nc * nc) + _round4(nz * nc) + 4 * _round4(mr))


def epoch_data_floats(nz: int, nc: int, mr: int, chunk: int) -> int:
    """Floats of one block's shared memory (``data_block_floats`` of the
    source): two slots of ``chunk`` stages, P, the two halves of its rows
    and (P F)' (a row each per row or column), (P G)', Qxx, Qxu, Quu,
    rho_scale and, above ``EPOCH_DATA_REG_NC`` controls (the factor in
    shared memory), the reciprocals of the factor's diagonal."""
    wz, _ = epoch_data_widths(nz, nc, mr)
    return (2 * chunk * epoch_data_stage_floats(nz, nc, mr)
            + (4 * nz + nc) * wz + _round4(nz * nz)
            + _round4(nz * nc) + _round4(nc * nc) + _round4(mr)
            + (_round4(nc) if nc > EPOCH_DATA_REG_NC else 0))


def _warps(n: int) -> int:
    return -(-n // 32) * 32


def epoch_data_threads(nz: int, nc: int) -> int:
    """Threads of one block (``data_threads`` of the source): the largest
    of the chain's three intervals (P F, P G, m; Qxx, Qxu, Quu; P's upper
    triangle and Quu_inv's columns), each kind of entry in whole warps of
    its own, at most 1024. The chunk's passes stride over them."""
    return min(1024, max(
        _warps(nz * nz) + _warps(nz * nc) + _warps(nz),
        _warps(nz * nz) + _warps(nz * nc) + _warps(nc * nc),
        _warps(nz * (nz + 1) // 2) + _warps(nc)))


def epoch_data_registers(nz: int, nc: int, mr: int) -> int:
    """Registers per thread the kernel's instantiation for these dimensions
    may use at most (its ``__launch_bounds__``): 72 for nc <= 2, 96 for
    nc <= 8 (rows of 12 floats), 64 otherwise."""
    if max(nz, nc, mr) <= 32 and epoch_data_widths(nz, nc, mr)[0] == 12 \
            and nc <= 8:
        return 72 if nc <= 2 else 96
    return 64


def epoch_data_plan(P: int, N: int, nz: int, nc: int, mr: int,
                    sms: int = H100_SMS,
                    spill: Optional[bool] = None) -> EpochDataPlan:
    """The launch plan of :func:`epoch_data_batched` for P QPs of horizon N:
    :func:`epoch_data_threads` threads per block, at most
    :func:`epoch_data_registers` registers each; among chunks of 8, 4, 2
    and 1 stages (at most N) it takes the fewest waves, then the deeper
    chunk. Where the block's shared memory does not fit even one stage per
    chunk, the block's whole layout at one stage per chunk goes into a
    global scratch (``spilled`` ``"block"``, no dynamic shared memory).
    ``spill`` pins the choice (True only where the kernel takes rows of
    runtime width: a dimension past 32 or nc past ``EPOCH_DATA_REG_NC``).
    Raises where P, N, nz, nc or mr is below 1."""
    if min(P, N, nz, nc, mr) < 1:
        raise ValueError(f"P={P}, N={N}, nz={nz}, nc={nc}, mr={mr}: the "
                         "epoch-data kernel takes P, N, nz, nc, mr >= 1")
    threads = epoch_data_threads(nz, nc)
    regs = epoch_data_registers(nz, nc, mr)

    def plan_at(chunk, smem, spilled="", scratch=0):
        per_sm = min(MAX_BLOCKS_PER_SM, MAX_WARPS_PER_SM // (threads // 32),
                     SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK),
                     REGISTERS_PER_SM // (regs * threads))
        return EpochDataPlan(threads, chunk, smem, per_sm,
                             -(-P // (sms * per_sm)), spilled, scratch)
    best = None
    if not spill:
        for chunk in sorted({min(c, N) for c in _CHUNK_CANDIDATES},
                            reverse=True):
            smem = 4 * epoch_data_floats(nz, nc, mr, chunk)
            if smem <= SMEM_PER_BLOCK:
                plan = plan_at(chunk, smem)
                if best is None or plan.waves < best.waves:
                    best = plan
    if best is None and spill is not False:
        if max(nz, nc, mr) <= 32 and nc <= EPOCH_DATA_REG_NC:
            raise ValueError(f"nz={nz}, nc={nc}, mr={mr}: the epoch-data "
                             "kernel spills only rows of runtime width")
        best = plan_at(1, 0, "block", 4 * P * epoch_data_floats(nz, nc, mr, 1))
    if best is None:
        raise ValueError(
            f"nz={nz}, nc={nc}, mr={mr}: the epoch-data kernel's block "
            f"takes {4 * epoch_data_floats(nz, nc, mr, 1)} bytes of shared "
            f"memory at one stage per chunk, more than the "
            f"{SMEM_PER_BLOCK} a block has, and the spill is pinned off")
    return best


def epoch_data_traffic(P: int, N: int, nz: int, nc: int, mr: int):
    """Bytes and FP32 operations of one epoch-data launch, the least the
    function needs. Bytes: each input the kernel reads (F, G, d, Q over N+1
    stages, R, S, D, E, lo, hi, both soft weights, rho_scale) once and each
    output it writes (K, Quu_inv, Qxu, m, the masked D and E, rv, fac_lo,
    fac_hi) once, in float32; q, r and the QP's own F, G, d, lo, hi pass
    through unread. Operations per stage, a multiply-add counted as 2: the
    augmentation D'diag(rv)D, D'diag(rv)E, E'diag(rv)E with the rows'
    masking and weighting; P F, F'(P F), P G, F'(P G), G'(P G), P d and
    the additions of the terms; the symmetrised Quu, its Cholesky and the
    solves of the nz gain columns and nc inverse columns; P = sym(Qxx +
    Qxu K); the rows' rv and prox factors."""
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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_plan_cached = functools.lru_cache(maxsize=256)(epoch_data_plan)


def _epoch_data_args(qp, rho, rho_scale, reg):
    """Check ``qp``, plan and allocate the outputs of one epoch-data launch.
    Returns the arguments of ``cmpc_epoch_data`` up to the stream, the
    fields of ADMMEpochData, the plan, the device and the spill's scratch
    (None unless the plan spills), which the caller holds until the launch
    is queued."""
    dev = _cuda_device(qp.lo)
    F, G, d = qp.dyn.F, qp.dyn.G, qp.dyn.d
    P, N, mr = qp.lo.shape
    nz, nc = F.shape[-1], G.shape[-1]
    plan = _plan_cached(P, N, nz, nc, mr, _sm_count(dev.index))
    row = (P, N, mr)
    args = dict(F=F, G=G, d=d, Q=qp.cost.Q, R=qp.cost.R, S=qp.cost.S,
                D=qp.D, E=qp.E, lo=qp.lo, hi=qp.hi, soft_lo=qp.soft_lo,
                soft_hi=qp.soft_hi)
    shapes = dict(F=(P, N, nz, nz), G=(P, N, nz, nc), d=(P, N, nz),
                  Q=(P, N + 1, nz, nz), R=(P, N, nc, nc), S=(P, N, nz, nc),
                  D=(P, N, mr, nz), E=(P, N, mr, nc), lo=row, hi=row,
                  soft_lo=row, soft_hi=row)
    for k, shape in shapes.items():
        if args[k] is not None:
            _check(k, args[k], shape, dev)
    _check("q", qp.cost.q, (P, N + 1, nz), dev)
    _check("r", qp.cost.r, (P, N, nc), dev)
    rs = torch.broadcast_to(torch.as_tensor(rho_scale, dtype=torch.float32,
                                            device=dev), (P, mr)).contiguous()
    # one allocation for every output, carved into contiguous views
    out_shapes = ((P, N, nc, nz), (P, N, nc, nc), (P, N, nz, nc), (P, N, nz),
                  (P, N, mr, nz), (P, N, mr, nc), row, row, row)
    sizes = [math.prod(sh) for sh in out_shapes]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    outs = [v.view(sh) for v, sh in zip(flat.split(sizes), out_shapes)]
    # the spill's per-block layouts, kept by the caller until the launch is
    # queued (then their memory goes only to work queued after it on the
    # same stream)
    scratch = (torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                           device=dev) if plan.spilled else None)
    ptrs = [None if args[k] is None else args[k].data_ptr() for k in shapes]
    ptrs += [rs.data_ptr()] + [t.data_ptr() for t in outs]
    ptrs.append(None if scratch is None else scratch.data_ptr())
    K, Qi, Qxu, m, Dm, Em, rv, flo, fhi = outs
    fields = (F, G, d, K, Qi, Qxu, m, qp.cost.q, qp.cost.r, Dm, Em, qp.lo,
              qp.hi, rv, flo, fhi)
    return ((*ptrs, P, N, nz, nc, mr, rho, reg, plan.threads, plan.chunk,
             plan.smem_bytes), fields, plan, dev, scratch)


def _on(dev: torch.device):
    """The context that makes ``dev`` current: none when it already is."""
    return (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
            else torch.cuda.device(dev))


def epoch_data_batched(qp, rho: float = 10.0, rho_scale=1.0,
                       reg: float = 1e-8):
    """The fixed data of one ADMM epoch for a batch of stage QPs on the
    card, in one launch of ``cmpc_epoch_data``.

    Args:
      qp: an ``ops/admm.py StageQP`` of contiguous float32 CUDA tensors
        with a leading batch axis P (soft weights may be None: hard rows).
      rho: the base penalty (a number); ``rho_scale``: per-row multipliers,
        a scalar, ``(mr,)`` or ``(P, mr)``; ``reg``: the regularisation of
        ``Quu``.
    Returns:
      the fields of ``ops/admm.py ADMMEpochData`` in its order: the QP's
      own F, G, d, q, r, lo, hi (the same tensors) and the kernel's K,
      Quu_inv, Qxu, m, masked D and E, rv, fac_lo, fac_hi (views of one
      allocation, each contiguous).
    """
    from colaborativempc_tpu_torch.ops import _build
    args, fields, _, dev, scratch = _epoch_data_args(qp, rho, rho_scale,
                                                     reg)
    lib = _build.load()
    with _on(dev):
        err = lib.cmpc_epoch_data(*args,
                                  torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "epoch_data_batched")
    epoch_data_batched.launches += 1
    return fields


def epoch_data_clocked(qp, rho: float = 10.0, rho_scale=1.0,
                       reg: float = 1e-8, source: Optional[str] = None):
    """:func:`epoch_data_batched` through the clock-stamped build of the
    kernel (``ops/_build.py load_epoch_data_clocks``; ``source`` another
    copy of ``epoch_data.cu`` with the same entry). A measurement tool,
    not counted in ``epoch_data_batched.launches``. Returns the fields,
    the stamps ``(P, stamps, 3)`` int64 (label, thread 0's clock, the
    last warp's clock at each barrier of a block, in order), the labels'
    names and the plan."""
    from colaborativempc_tpu_torch.ops import _build
    args, fields, plan, dev, scratch = _epoch_data_args(qp, rho, rho_scale,
                                                        reg)
    lib = _build.load_epoch_data_clocks(source)
    P, N = qp.lo.shape[:2]
    n = lib.cmpc_epoch_data_clock_stamps(N, plan.chunk)
    clocks = torch.full((P, n, 3), -1, dtype=torch.int64, device=dev)
    with _on(dev):
        err = lib.cmpc_epoch_data_clocked(
            *args, torch.cuda.current_stream(dev).cuda_stream,
            clocks.data_ptr(), n)
    _raise_on(err, "epoch_data_clocked")
    names = lib.cmpc_epoch_data_clock_names().decode().split(";")
    return fields, clocks, names, plan


epoch_data_batched.launches = 0
