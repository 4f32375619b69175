"""Inequality-constrained stage QP via ADMM with Riccati inner solves
(PyTorch port).

Twin of ``colaborativempc_tpu/ops/admm.py`` (the on-device replacement for
OSQP, reference ``LPV_Planner.py:192-249``), batched over P problems: every
tensor carries a leading axis P, where the JAX functions are per problem
and vmapped.

Problem:

    min   sum_k stage_cost(z_k, c_k)        (LQRCost quadratics)
    s.t.  z_{k+1} = F_k z_k + G_k c_k + d_k,   z_0 fixed
          lo_k <= D_k z_k + E_k c_k <= hi_k    (per-stage, stage-local)

Soft bounds carry a quadratic violation weight that only enters the
closed-form prox of the w-step, never the Riccati matrices. Each
refactorisation epoch first derives its fixed data
(:func:`admm_epoch_inputs`: the rho-augmented cost, its Riccati
factorisation and the prox factors). On CUDA tensors that is one launch of
the CUDA kernel ``ops/cuda_lqr.py epoch_data_batched``
(``csrc/epoch_data.cu``); on CPU tensors its plain version
:func:`admm_epoch_inputs_plain`, batched torch around ``ops/lqr.py
lqr_factorize``, as it was plain XLA in JAX. Then the epoch runs
``ops/cuda_lqr.py admm_epoch_batched``: the CUDA kernel for CUDA tensors,
its plain twin for CPU tensors; on CPU tensors ``assoc=True`` runs
:func:`admm_epoch_assoc` instead, which keeps the plain factorisation (see
:func:`admm_solve`). Between epochs the per-row-class rho is rescaled
OSQP-style, in torch.

Per-problem freeze: under the JAX double vmap each problem's
``while_loop`` stops on its own convergence while its batch-mates iterate.
Here an ``active`` mask of shape (P,) applies each epoch's results only to
problems still running, so every problem gets the result (and iteration
count) of its standalone solve. The host reads the mask once per epoch.
On CPU tensors each epoch's ops run as they come. On CUDA tensors the
loop's state stays in static buffers and each epoch is one replay of a
CUDA graph (:class:`_EpochGraph`), so an epoch costs the host a graph
launch and that read.
"""

from __future__ import annotations

import itertools
import math
from collections import OrderedDict
from typing import NamedTuple, Optional

import torch

from colaborativempc_tpu_torch.ops.cuda_lqr import (
    admm_epoch_batched, admm_epoch_batched_plain, epoch_data_batched,
)
from colaborativempc_tpu_torch.ops.lqr import (
    LQRCost, LQRDynamics, lqr_affine_solve_assoc, lqr_factorize,
)
from colaborativempc_tpu_torch.utils.graphs import record
from colaborativempc_tpu_torch.utils.tracing import span


class StageQP(NamedTuple):
    """A batch of stage-structured QPs: LQR data + per-stage inequality rows.

    ``soft_lo``/``soft_hi``: optional per-row quadratic penalty weights;
    +inf (or None) means a hard bound.
    """
    dyn: LQRDynamics
    cost: LQRCost
    D: torch.Tensor    # (P, N, m, nz)
    E: torch.Tensor    # (P, N, m, nc)
    lo: torch.Tensor   # (P, N, m)
    hi: torch.Tensor   # (P, N, m)
    soft_lo: Optional[torch.Tensor] = None   # (P, N, m) weights or None
    soft_hi: Optional[torch.Tensor] = None


class ADMMSolution(NamedTuple):
    z: torch.Tensor          # (P, N+1, nz)
    c: torch.Tensor          # (P, N, nc)
    w: torch.Tensor          # (P, N, m)
    y: torch.Tensor          # (P, N, m)
    rho_scale: torch.Tensor  # (P, m) per-row-class rho multipliers
    iterations: torch.Tensor  # (P,) int
    r_prim: torch.Tensor     # (P,)
    r_dual: torch.Tensor     # (P,)
    feasible: torch.Tensor   # (P,) primal residual below tolerance at exit


def _active_rows(qp: StageQP) -> torch.Tensor:
    """Mask of rows with at least one finite bound; fully unbounded rows are
    excluded from the splitting so they add no proximal damping."""
    return (torch.isfinite(qp.lo) | torch.isfinite(qp.hi)).to(qp.D.dtype)


def build_admm_cost(qp: StageQP, rho) -> LQRCost:
    """Quadratic cost augmented with the rho-penalty terms; ``rho`` is a
    scalar or a per-row ``(P, N, m)`` tensor."""
    mask = _active_rows(qp)
    rv = rho * mask
    D = qp.D * mask[..., None]
    E = qp.E * mask[..., None]
    Dw = D * rv[..., None]
    DtD = Dw.transpose(-1, -2) @ D
    EtE = (E * rv[..., None]).transpose(-1, -2) @ E
    DtE = Dw.transpose(-1, -2) @ E
    N = qp.lo.shape[1]
    Q = torch.cat([qp.cost.Q[:, :N] + DtD, qp.cost.Q[:, N:]], dim=1)
    return LQRCost(Q=Q, q=qp.cost.q, R=qp.cost.R + EtE, r=qp.cost.r,
                   S=qp.cost.S + DtE)


class ADMMEpochData(NamedTuple):
    """Everything one ADMM epoch needs besides the (w, y) state — the
    factorisation and constraint data fixed across the epoch's iterations,
    with a leading batch axis P. Produced by :func:`admm_epoch_inputs`: on
    the card by the CUDA kernel ``ops/cuda_lqr.py epoch_data_batched``
    (``csrc/epoch_data.cu``), on the CPU by its plain version
    :func:`admm_epoch_inputs_plain`. Consumed by ``ops/cuda_lqr.py
    admm_epoch_batched`` (kernel and twin).
    """
    F: torch.Tensor        # (P, N, nz, nz) dynamics
    G: torch.Tensor        # (P, N, nz, nc)
    d: torch.Tensor        # (P, N, nz)
    K: torch.Tensor        # (P, N, nc, nz) Riccati gains (rho-augmented)
    Quu_inv: torch.Tensor  # (P, N, nc, nc) explicit inverses (nc is tiny)
    Qxu: torch.Tensor      # (P, N, nz, nc)
    m: torch.Tensor        # (P, N, nz) P_{k+1} d_k drift
    q: torch.Tensor        # (P, N+1, nz) linear state cost
    r: torch.Tensor        # (P, N, nc)
    D: torch.Tensor        # (P, N, mr, nz) masked constraint rows
    E: torch.Tensor        # (P, N, mr, nc)
    lo: torch.Tensor       # (P, N, mr)
    hi: torch.Tensor       # (P, N, mr)
    rv: torch.Tensor       # (P, N, mr) effective per-row rho (0 if inactive)
    fac_lo: torch.Tensor   # (P, N, mr) soft-row prox shrink factors
    fac_hi: torch.Tensor   # (P, N, mr)


def _soft(qp: StageQP, weights) -> torch.Tensor:
    if weights is None:
        return torch.full_like(qp.lo, torch.inf)
    return weights.to(qp.lo.dtype)


def _epoch_data(qp: StageQP, rho, rho_scale, reg):
    """What every epoch derives before its iterations: the effective
    per-row rho ``rv``, the factorisation of the rho-augmented cost and the
    soft-row prox shrink factors, packed as :class:`ADMMEpochData`; the
    factors are returned as well for the Cholesky-based affine solves."""
    dtype, dev = qp.lo.dtype, qp.lo.device
    P, _, mr = qp.lo.shape
    rho_scale = torch.as_tensor(rho_scale, dtype=dtype, device=dev)
    rho_scale = torch.broadcast_to(rho_scale, (P, mr))
    mask = _active_rows(qp)
    rv = rho * mask * rho_scale[:, None, :]
    slo, shi = _soft(qp, qp.soft_lo), _soft(qp, qp.soft_hi)
    aug_cost = build_admm_cost(qp, rv)
    fac = lqr_factorize(qp.dyn, aug_cost, reg)
    rv_safe = torch.where(rv > 0, rv, torch.ones_like(rv))
    zero = torch.zeros_like(rv)
    fac_lo = torch.where(torch.isinf(slo), zero, rv_safe / (rv_safe + 2.0 * slo))
    fac_hi = torch.where(torch.isinf(shi), zero, rv_safe / (rv_safe + 2.0 * shi))
    nc = qp.dyn.G.shape[-1]
    eye = torch.eye(nc, dtype=dtype, device=dev).expand(fac.Quu_chol.shape)
    data = ADMMEpochData(
        F=qp.dyn.F, G=qp.dyn.G, d=qp.dyn.d,
        K=fac.K, Quu_inv=torch.cholesky_solve(eye, fac.Quu_chol),
        Qxu=fac.Qxu, m=fac.m, q=aug_cost.q, r=aug_cost.r,
        D=qp.D * mask[..., None], E=qp.E * mask[..., None],
        lo=qp.lo, hi=qp.hi, rv=rv, fac_lo=fac_lo, fac_hi=fac_hi)
    return data, fac


def admm_epoch_inputs_plain(qp: StageQP, rho: float = 10.0,
                            rho_scale=1.0, reg: float = 1e-8
                            ) -> ADMMEpochData:
    """Plain version of :func:`admm_epoch_inputs` on any device: batched
    torch around ``ops/lqr.py lqr_factorize``. Every field is contiguous,
    as the epoch kernel takes it."""
    data, _ = _epoch_data(qp, rho, rho_scale, reg)
    return ADMMEpochData(*(t.contiguous() for t in data))


def admm_epoch_inputs(qp: StageQP, rho: float = 10.0,
                      rho_scale=1.0, reg: float = 1e-8) -> ADMMEpochData:
    """Factorise and precompute one epoch's fixed data for the per-row rho
    multipliers ``rho_scale`` (scalar, ``(m,)`` or ``(P, m)``).

    On CPU tensors: :func:`admm_epoch_inputs_plain`. On CUDA tensors: one
    launch of ``ops/cuda_lqr.py epoch_data_batched``, which raises on a
    tensor it cannot take (dtype, shape, layout); there is no fallback to
    the plain version. Every field is contiguous, as the epoch kernel takes
    it."""
    if qp.lo.device.type == "cpu":
        return admm_epoch_inputs_plain(qp, rho, rho_scale, reg)
    return ADMMEpochData(*epoch_data_batched(qp, rho, rho_scale, reg))


def admm_epoch_assoc(qp: StageQP, z0: torch.Tensor, w0: torch.Tensor,
                     y0: torch.Tensor, rho: float = 10.0, rho_scale=1.0,
                     reg: float = 1e-8, *, epoch_len: int = 25,
                     alpha: float = 1.6):
    """One ADMM epoch whose inner affine solves are
    ``ops/lqr.py lqr_affine_solve_assoc``: the XLA epoch of JAX
    ``admm_solve`` with ``assoc=True`` (``admm.py:361-405``), Cholesky
    solves included. It is the kernel's plain twin's iteration with that
    affine solve in place of the sequential one. Plain torch on any device,
    with the plain factorisation (the affine solves need its Cholesky
    factors); returns what ``admm_epoch_batched`` returns: ``z, c, w, y,
    r_prim (P, mr), r_dual (P, mr)``."""
    data, fac = _epoch_data(qp, rho, rho_scale, reg)

    def affine(q, r):
        return lqr_affine_solve_assoc(qp.dyn, fac, q, r, z0)

    return admm_epoch_batched_plain(data, z0, w0, y0, epoch_len=epoch_len,
                                    alpha=alpha, affine=affine)


def scale_stage_qp(qp: StageQP, tz, tc) -> StageQP:
    """Diagonal change of variables z = diag(tz) z~, c = diag(tc) c~ of a
    batch of stage QPs (JAX ``scale_stage_qp``, the reference MPCC's
    T_x/T_u normalisation, ``mpc.cpp:91-132``). ``tz (nz,)`` / ``tc (nc,)``
    are shared by every problem, or ``(P, nz)`` / ``(P, nc)`` per problem.
    Constraint values ``D z + E c`` are invariant, so ADMM's (w, y,
    rho_scale) warm starts and residuals keep their meaning; de-normalise
    with ``z = z~ * tz``, ``c = c~ * tc``."""
    dtype, dev = qp.lo.dtype, qp.lo.device
    nz, nc = qp.dyn.F.shape[-1], qp.dyn.G.shape[-1]
    tz = torch.as_tensor(tz, dtype=dtype, device=dev).reshape(-1, 1, nz)
    tc = torch.as_tensor(tc, dtype=dtype, device=dev).reshape(-1, 1, nc)
    tzi = 1.0 / tz
    col_z, row_z = tz[..., None, :], tz[..., :, None]
    col_c, row_c = tc[..., None, :], tc[..., :, None]
    dyn = LQRDynamics(F=tzi[..., :, None] * qp.dyn.F * col_z,
                      G=tzi[..., :, None] * qp.dyn.G * col_c,
                      d=qp.dyn.d * tzi)
    cost = LQRCost(Q=row_z * qp.cost.Q * col_z, q=qp.cost.q * tz,
                   R=row_c * qp.cost.R * col_c, r=qp.cost.r * tc,
                   S=row_z * qp.cost.S * col_c)
    return qp._replace(dyn=dyn, cost=cost, D=qp.D * col_z, E=qp.E * col_c)


def default_epoch_len(N: int) -> int:
    """N-dependent refactorisation epoch length (JAX ``admm_solve``)."""
    return 10 if N < 16 else (20 if N < 48 else 30)




class _ADMMState(NamedTuple):
    """:func:`admm_solve`'s state between epochs; the float fields first,
    in the order :class:`_EpochGraph` lays them out."""
    z: torch.Tensor          # (P, N+1, nz)
    c: torch.Tensor          # (P, N, nc)
    w: torch.Tensor          # (P, N, m)
    y: torch.Tensor          # (P, N, m)
    rho_scale: torch.Tensor  # (P, m)
    r_prim: torch.Tensor     # (P, m) the last epoch's per-row-class residuals
    r_dual: torch.Tensor     # (P, m)
    it: torch.Tensor         # (P,) int64 iterations run


def _epoch_step(qp: StageQP, z0: torch.Tensor, st: _ADMMState,
                active: torch.Tensor, *, rho, alpha, eps, reg, epoch_len,
                max_rho_scale, assoc: bool = False) -> _ADMMState:
    """One epoch of :func:`admm_solve` from state ``st``: the epoch data and
    the epoch (see :func:`admm_solve` for which), the OSQP-style rho
    rescale, and the new state for the problems in ``active`` ``(P,)``
    bool; the others keep theirs. A plain function of tensors: the loop on
    CPU tensors calls it, and on the card it is the body of each epoch's
    CUDA graph (:class:`_EpochGraph`)."""
    if assoc and z0.device.type == "cpu":
        z_e, c_e, w_e, y_e, rp_e, rd_e = admm_epoch_assoc(
            qp, z0, st.w, st.y, rho, st.rho_scale, reg,
            epoch_len=epoch_len, alpha=alpha)
    else:
        data = admm_epoch_inputs(qp, rho, st.rho_scale, reg)
        z_e, c_e, w_e, y_e, rp_e, rd_e = admm_epoch_batched(
            data, z0, st.w.contiguous(), st.y.contiguous(),
            epoch_len=epoch_len, alpha=alpha)
    # OSQP-style per-class rescale, bounded; the scaled dual follows.
    # Classes already inside tolerance keep their rho.
    ratio = torch.sqrt(rp_e / torch.clamp_min(rd_e, 1e-12))
    ratio = torch.clamp(ratio, 0.2, 10.0)
    new_scale = torch.clamp(st.rho_scale * ratio, 1e-3, max_rho_scale)
    quiet = (rp_e < eps) & (rd_e < eps)
    new_scale = torch.where(quiet, st.rho_scale, new_scale)
    y_e = y_e * (st.rho_scale / new_scale)[:, None, :]

    a1 = active[:, None]
    a2 = active[:, None, None]
    return _ADMMState(
        z=torch.where(a2, z_e, st.z), c=torch.where(a2, c_e, st.c),
        w=torch.where(a2, w_e, st.w), y=torch.where(a2, y_e, st.y),
        rho_scale=torch.where(a1, new_scale, st.rho_scale),
        r_prim=torch.where(a1, rp_e, st.r_prim),
        r_dual=torch.where(a1, rd_e, st.r_dual),
        it=st.it + epoch_len * active.to(st.it.dtype))


def _still_active(st: _ADMMState, eps, budget: int) -> torch.Tensor:
    """``(P,)`` bool: the problems that run the next epoch, those with
    iterations left and a row class outside tolerance."""
    not_conv = ((torch.amax(st.r_prim, dim=1) > eps)
                | (torch.amax(st.r_dual, dim=1) > eps))
    return (st.it < budget) & not_conv


def _solution(st: _ADMMState, feas_tol: float) -> ADMMSolution:
    r_p = torch.amax(st.r_prim, dim=1)
    return ADMMSolution(z=st.z, c=st.c, w=st.w, y=st.y,
                        rho_scale=st.rho_scale, iterations=st.it,
                        r_prim=r_p, r_dual=torch.amax(st.r_dual, dim=1),
                        # tolerant acceptance mirroring the reference, which
                        # treats OSQP 'solved_inaccurate' and even
                        # 'max_iter_reached' as usable
                        # (LPV_Planner.py:241-249)
                        feasible=r_p < feas_tol)


def _qp_leaves(qp: StageQP):
    return (qp.dyn.F, qp.dyn.G, qp.dyn.d, qp.cost.Q, qp.cost.q, qp.cost.R,
            qp.cost.r, qp.cost.S, qp.D, qp.E, qp.lo, qp.hi, qp.soft_lo,
            qp.soft_hi)


# the wrappers' launch counters, which a replay advances by what its
# epoch's launches would
_LAUNCH_COUNTERS = ((admm_epoch_batched, "launches"),
                    (admm_epoch_batched, "pipelined_launches"),
                    (epoch_data_batched, "launches"))


class _EpochGraph:
    """:func:`admm_solve`'s loop on the card for one layout. The QP, z0 and
    the loop's state live in static buffers for the whole solve, the state
    in one allocation carved into views. Every epoch is one replay of a
    CUDA graph of :meth:`step`: :func:`_epoch_step` on the buffers, in
    place, then the next ``active`` mask and its ``any()``, which the host
    reads. The layout's first epoch runs :meth:`step` eagerly (it loads
    whatever loads lazily) and then records it; the recording runs
    nothing and counts no launch, and each replay advances the wrappers'
    launch counters as its epoch's launches would, and
    ``admm_solve.graph_replays`` by one."""

    def __init__(self, qp: StageQP, z0: torch.Tensor, opts: dict,
                 budget: int):
        dev, dtype = z0.device, z0.dtype
        P, N, m = qp.lo.shape
        nz, nc = qp.dyn.F.shape[-1], qp.dyn.G.shape[-1]
        self.opts, self.budget = opts, budget
        F, G, d, Q, q, R, r, S, D, E, lo, hi, slo, shi = (
            None if t is None else torch.empty(t.shape, dtype=t.dtype,
                                               device=dev)
            for t in _qp_leaves(qp))
        self.qp = StageQP(LQRDynamics(F, G, d), LQRCost(Q, q, R, r, S), D, E,
                          lo, hi, slo, shi)
        self.z0 = torch.empty(z0.shape, dtype=dtype, device=dev)
        self._shapes = ((P, N + 1, nz), (P, N, nc), (P, N, m), (P, N, m),
                        (P, m), (P, m), (P, m))
        self._starts = list(itertools.accumulate(
            [0] + [math.prod(s) for s in self._shapes]))
        self.flat = torch.empty(self._starts[-1], dtype=dtype, device=dev)
        self.state = _ADMMState(*self._carve(self.flat),
                                it=torch.empty((P,), dtype=torch.int64,
                                               device=dev))
        self.active = torch.empty((P,), dtype=torch.bool, device=dev)
        self.graph = self.flag = self.launches = None

    def _carve(self, flat: torch.Tensor):
        """The float fields' views of ``flat`` (or of a prefix of it)."""
        return [flat[a:a + math.prod(s)].view(s)
                for a, s in zip(self._starts, self._shapes)
                if a < flat.numel()]

    def load(self, qp: StageQP, z0, w0, y0, rho_scale0) -> bool:
        """Copy one solve's QP, start and warm starts in and reset the
        state. Returns whether the first epoch runs: with a finite ``eps``
        every problem does (no iteration run, infinite residuals), so only
        a non-finite one reads the mask from the card."""
        st = self.state
        torch._foreach_copy_(
            [t for t in _qp_leaves(self.qp) if t is not None]
            + [self.z0, st.w, st.y],
            [t for t in _qp_leaves(qp) if t is not None] + [z0, w0, y0])
        self.flat[:self._starts[2]].zero_()           # z, c
        self.flat[self._starts[5]:].fill_(math.inf)   # r_prim, r_dual
        st.it.zero_()
        if isinstance(rho_scale0, (int, float)):
            st.rho_scale.fill_(rho_scale0)
        else:
            st.rho_scale.copy_(torch.as_tensor(
                rho_scale0, dtype=st.rho_scale.dtype,
                device=st.rho_scale.device))
        eps = self.opts["eps"]
        if math.isfinite(eps):
            self.active.fill_(True)
            return True
        self.active.copy_(_still_active(st, eps, self.budget))
        with span("cmpc.admm.sync"):
            return bool(self.active.any())

    def step(self) -> torch.Tensor:
        """The epoch the graph holds, on the buffers in place; returns
        whether any problem runs the next epoch, a one-element tensor."""
        st = _epoch_step(self.qp, self.z0, self.state, self.active,
                         **self.opts)
        active = _still_active(st, self.opts["eps"], self.budget)
        # one multi-tensor copy for the float fields (one dtype each list)
        torch._foreach_copy_(list(self.state[:-1]), list(st[:-1]))
        self.state.it.copy_(st.it)
        self.active.copy_(active)
        return active.any()

    def run(self) -> torch.Tensor:
        """One epoch on the card: a replay, or on the layout's first epoch
        :meth:`step` and then the recording. Returns :meth:`step`'s flag."""
        if self.graph is None:
            flag = self.step()
            self._record()
            return flag
        self.graph.replay()
        for (fn, name), n in zip(_LAUNCH_COUNTERS, self.launches):
            setattr(fn, name, getattr(fn, name) + n)
        admm_solve.graph_replays += 1
        return self.flag

    def _record(self):
        before = [getattr(fn, name) for fn, name in _LAUNCH_COUNTERS]
        try:
            graph, flag = record(self.step, self.flat.device)
            self.launches = [getattr(fn, name) - b for (fn, name), b
                             in zip(_LAUNCH_COUNTERS, before)]
        finally:
            for (fn, name), b in zip(_LAUNCH_COUNTERS, before):
                setattr(fn, name, b)
        self.graph, self.flag = graph, flag
        admm_solve.graph_records += 1

    def solve(self, qp: StageQP, z0, w0, y0, rho_scale0, n_epochs: int,
              feas_tol: float) -> ADMMSolution:
        """:func:`admm_solve`'s loop over the buffers: one :meth:`run` an
        epoch and, after each epoch but the budget's last, one host read of
        its flag. The solution is cloned out (the float fields in one copy),
        so the next solve cannot overwrite it."""
        go = self.load(qp, z0, w0, y0, rho_scale0)
        for e in range(n_epochs):
            if not go:
                break
            with span("cmpc.admm.epoch"):
                flag = self.run()
                if e + 1 < n_epochs:
                    with span("cmpc.admm.sync"):
                        go = bool(flag)
        st = self.state
        z, c, w, y, rho_scale = self._carve(
            self.flat[:self._starts[5]].clone())
        return _solution(st._replace(z=z, c=c, w=w, y=y, rho_scale=rho_scale,
                                     it=st.it.clone()), feas_tol)


# one graph per layout (shapes, dtypes, device and the numbers the graph
# bakes in), the least recently used dropped past this many
_MAX_GRAPHS = 8
_GRAPHS: "OrderedDict[tuple, _EpochGraph]" = OrderedDict()


def _epoch_graph(qp: StageQP, z0: torch.Tensor, opts: dict,
                 budget: int) -> _EpochGraph:
    key = (tuple(None if t is None else (t.shape, t.dtype)
                 for t in _qp_leaves(qp)),
           z0.shape, z0.dtype, z0.device, budget, tuple(opts.items()))
    g = _GRAPHS.pop(key, None)
    if g is None:
        g = _EpochGraph(qp, z0, opts, budget)
    _GRAPHS[key] = g
    while len(_GRAPHS) > _MAX_GRAPHS:
        _GRAPHS.popitem(last=False)
    return g


def admm_solve(qp: StageQP, z0: torch.Tensor,
               w0: Optional[torch.Tensor] = None,
               y0: Optional[torch.Tensor] = None,
               iters: int = 100, rho: float = 10.0, alpha: float = 1.6,
               eps: float = 1e-4, reg: float = 1e-8,
               epoch_len: Optional[int] = None,
               rho_scale0=1.0,
               max_rho_scale: float = 1e6,
               feas_tol: float = 1e-2,
               assoc: bool = False) -> ADMMSolution:
    """Solve P stage QPs with warm-startable ``(w0, y0, rho_scale0)``.

    ``z0 (P, nz)``; ``w0``/``y0`` ``(P, N, m)``; ``rho_scale0`` scalar,
    ``(m,)`` or ``(P, m)``. ``iters`` rounds DOWN to whole epochs
    (``iters // epoch_len``, at least one). A problem stops once every row
    class has primal and dual residual below ``eps`` or its budget is
    spent; its batch-mates go on.

    Which epoch runs: on CUDA tensors every epoch is the kernel
    (``admm_epoch_batched``), whatever ``assoc`` says — the port's
    counterpart of JAX's ``use_pallas=True``, under which the Pallas epoch
    wins over ``assoc`` (``admm.py:310,426``: ``epoch_pallas`` ignores the
    affine solve). On CPU tensors ``assoc=False`` runs the kernel's plain
    twin and ``assoc=True`` runs :func:`admm_epoch_assoc`, the JAX XLA
    epoch with the associative affine solve. ``admm_epoch_assoc`` is plain
    torch and runs on the card as well, but ``admm_solve`` never selects it
    there.

    How the loop runs: on CPU tensors each epoch's ops run as they come,
    with a host read of the ``active`` mask before the first epoch and
    after each but the last. On CUDA tensors each epoch is one replay of a
    CUDA graph recorded once per layout (:class:`_EpochGraph`, counted in
    ``admm_solve.graph_records`` and ``admm_solve.graph_replays``), and
    the read before the first epoch is made only for a non-finite ``eps``
    (with a finite one every problem runs it): the same epochs and the
    same bits.
    """
    with span("cmpc.admm.solve"):
        P, N, m = qp.lo.shape
        dtype, dev = z0.dtype, z0.device
        nz, nc = qp.dyn.F.shape[-1], qp.dyn.G.shape[-1]
        if epoch_len is None:
            epoch_len = default_epoch_len(N)
        n_epochs = max(1, iters // epoch_len)
        budget = n_epochs * epoch_len
        opts = dict(rho=rho, alpha=alpha, eps=eps, reg=reg,
                    epoch_len=epoch_len, max_rho_scale=max_rho_scale)

        if w0 is None:
            w0 = torch.clamp(torch.zeros((P, N, m), dtype=dtype, device=dev),
                             qp.lo, qp.hi)
        if y0 is None:
            y0 = torch.zeros((P, N, m), dtype=dtype, device=dev)
        if dev.type == "cuda":
            return _epoch_graph(qp, z0, opts, budget).solve(
                qp, z0, w0, y0, rho_scale0, n_epochs, feas_tol)

        st = _ADMMState(
            z=torch.zeros((P, N + 1, nz), dtype=dtype, device=dev),
            c=torch.zeros((P, N, nc), dtype=dtype, device=dev),
            w=w0, y=y0,
            rho_scale=torch.broadcast_to(
                torch.as_tensor(rho_scale0, dtype=dtype, device=dev),
                (P, m)).clone(),
            r_prim=torch.full((P, m), torch.inf, dtype=dtype, device=dev),
            r_dual=torch.full((P, m), torch.inf, dtype=dtype, device=dev),
            it=torch.zeros((P,), dtype=torch.int64, device=dev))
        z0c = z0.contiguous()

        def any_active():
            # the one host sync per epoch: whether any problem runs the next
            active = _still_active(st, eps, budget)
            with span("cmpc.admm.sync"):
                return active, bool(active.any())

        # each epoch's span holds the sync that decides the next epoch, so
        # there is one span per epoch run
        active, go = any_active()
        for e in range(n_epochs):
            if not go:
                break
            with span("cmpc.admm.epoch"):
                st = _epoch_step(qp, z0c, st, active, assoc=assoc, **opts)
                if e + 1 < n_epochs:
                    active, go = any_active()
        return _solution(st, feas_tol)


admm_solve.graph_records = 0   # graphs recorded (one per layout)
admm_solve.graph_replays = 0   # epochs run by a replay
