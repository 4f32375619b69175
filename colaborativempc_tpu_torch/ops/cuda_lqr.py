"""Hand-written CUDA kernels for the batched LQR affine pass and the whole
ADMM epoch, each beside its plain PyTorch twin.

Counterpart of ``colaborativempc_tpu/ops/pallas_lqr.py``. The kernels live
in ``csrc/lqr_kernels.cu`` (design notes there) and are built by
``ops/_build.py`` at the first CUDA launch.

A wrapper launches its kernel for CUDA tensors and runs its ``*_plain`` twin
for CPU tensors; a CUDA tensor it cannot take (wrong dtype, shape, layout or
device) raises — there is no fallback from the CUDA path to the plain one.
Each wrapper counts its kernel launches in a plain integer attribute
(``admm_epoch_batched.launches``, ``lqr_affine_solve_batched.launches``),
incremented only where the kernel is launched.

Layout: row-major with the batch of problems first, ``(P, N, ...)``;
``Quu_inv`` is the explicit inverse of the 2x2 ``Quu`` (as in the Pallas
kernels).

:func:`kernel_plan` chooses each launch's QPs per block, ring depth and
shared-memory bytes from the shapes and the card's SM count; it is plain
Python, so the CPU tests reach it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

# NVIDIA H100 (sm_90): dynamic shared memory a block may use, shared memory
# of an SM (each resident block reserves 1 KB of it), resident blocks and
# warps per SM, and its SM count.
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1_024
MAX_BLOCKS_PER_SM = 32
MAX_WARPS_PER_SM = 64
H100_SMS = 132
_RING_CANDIDATES = (32, 16, 8, 4, 2, 1)


class KernelPlan(NamedTuple):
    """One launch's geometry: ``qps_per_block`` warps (one QP each) per
    block; ``ring`` stages per ring slot (``>= N``: the whole horizon is
    resident and loads once per launch, else two slots stream chunks of
    ``ring`` stages); ``smem_bytes`` of dynamic shared memory per block;
    ``waves``, the rounds of blocks the card runs one after another."""
    qps_per_block: int
    ring: int
    smem_bytes: int
    waves: int


def stage_floats(nz: int, nc: int, mr: int) -> int:
    """Floats of one stage's fixed data in a ring slot (``stage_floats`` of
    ``csrc/lqr_kernels.cu``)."""
    return nz * nz + 3 * nz * nc + nc * nc + 3 * nz + nc + mr * (nz + nc + 5)


def qp_floats(N: int, ring: int, nz: int, nc: int, mr: int) -> int:
    """Floats of shared memory one QP takes (``qp_floats`` of the source):
    w, y, kff over the horizon, one chunk's scratch, one or two ring
    slots."""
    S = min(ring, N)
    slots = 1 if ring >= N else 2
    return (2 * N * mr + N * nc + (S + 1) * nz + S * (nz + mr + nc) + nc
            + slots * S * stage_floats(nz, nc, mr))


def kernel_plan(P: int, N: int, nz: int, nc: int, mr: int,
                sms: int = H100_SMS, ring: Optional[int] = None,
                qps_per_block: Optional[int] = None) -> KernelPlan:
    """The launch plan for P QPs of horizon N (``mr = 0``: the affine
    kernel). Among the whole horizon and rings of 32, 16, 8, 4, 2 and 1
    stages, and 1 to 4 QPs per block, it takes the fewest waves; then the
    resident horizon over a streamed ring, the deeper ring, the plan spread
    over more SMs, and more QPs per block. So the horizon stays resident
    when every QP's horizon fits on the card at once, and streams when a
    ring saves waves. ``ring`` and ``qps_per_block`` pin a choice."""
    rings = ([ring] if ring is not None else
             [N] + [r for r in _RING_CANDIDATES if r < N])
    qpbs = [qps_per_block] if qps_per_block is not None else [4, 3, 2, 1]
    best, best_key = None, None
    for R in rings:
        per_qp = 4 * qp_floats(N, R, nz, nc, mr)
        for qpb in qpbs:
            smem = qpb * per_qp
            if smem > SMEM_PER_BLOCK:
                continue
            per_sm = min(MAX_BLOCKS_PER_SM, MAX_WARPS_PER_SM // qpb,
                         SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK))
            blocks = -(-P // qpb)
            waves = -(-blocks // (sms * per_sm))
            key = (waves, R < N, -min(R, N), -min(sms, blocks), -qpb)
            if best_key is None or key < best_key:
                best_key = key
                best = KernelPlan(qpb, min(R, N), smem, waves)
    if best is None:
        raise ValueError(f"no launch plan fits P={P}, N={N}, nz={nz}, "
                         f"nc={nc}, mr={mr}, ring={ring}, "
                         f"qps_per_block={qps_per_block} in "
                         f"{SMEM_PER_BLOCK} bytes of shared memory")
    return best


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
                             alpha: float = 1.6):
    """Plain twin of :func:`admm_epoch_batched`: ``epoch_len`` ADMM
    iterations with the fixed factorisation in ``data`` (an
    ``ops/admm.py ADMMEpochData`` with leading batch axis P)."""
    N = data.F.shape[1]
    mask = (data.rv > 0).to(data.rv.dtype)
    w, y = w0, y0
    for _ in range(epoch_len):
        t = data.rv * (y - w)                               # (P, N, mr)
        q_pen = torch.sum(data.D * t[..., None], dim=-2)    # (P, N, nz)
        r_pen = torch.sum(data.E * t[..., None], dim=-2)    # (P, N, nc)
        q = torch.cat([data.q[:, :N] + q_pen, data.q[:, N:]], dim=1)
        z, c = lqr_affine_solve_batched_plain(
            data.F, data.G, data.d, data.K, data.Quu_inv, data.Qxu, data.m,
            q, data.r + r_pen, z0)
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


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes float32")
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cmpc_lqr_affine(
            *[_ptr(args[k]) for k in shapes], _ptr(z), _ptr(c),
            P, N, nz, nc, plan.qps_per_block, plan.ring, plan.smem_bytes,
            ctypes.c_void_p(stream))
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
    if max(nz, nc, mr) > 32:
        raise ValueError(f"nz={nz}, nc={nc}, mr={mr}: the kernel maps each "
                         "onto one warp's 32 lanes")
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cmpc_admm_epoch(
            *[_ptr(getattr(data, k)) for k in _EPOCH_FIELDS],
            _ptr(z0), _ptr(w0), _ptr(y0),
            _ptr(z), _ptr(c), _ptr(w), _ptr(y), _ptr(rp), _ptr(rd),
            P, N, nz, nc, mr, int(epoch_len), ctypes.c_float(alpha),
            plan.qps_per_block, plan.ring, plan.smem_bytes,
            ctypes.c_void_p(stream))
    _raise_on(err, "admm_epoch_batched")
    admm_epoch_batched.launches += 1
    return z, c, w, y, rp, rd


admm_epoch_batched.launches = 0
