"""``admm_solve``'s loop on the card, run eagerly on CPU tensors.

On CUDA tensors ``ops/admm.py admm_solve`` keeps the QP, z0 and the
loop's state in static buffers (``_EpochGraph``) and replays each epoch
from a CUDA graph of ``_EpochGraph.step``; on CPU tensors it runs each
epoch's ops as they come. Here the graph's body is looped eagerly on CPU
tensors, through the same loop the card runs (``_EpochGraph.solve`` with
``step`` in place of the replay), and held bit for bit to the loop as it
was before the graph (a frozen copy below) at the benchmark's three
families' shapes, with problems freezing at different epochs and a batch
that stops early; the CPU path is held to it as well. The replay against
this eager body on a card is tests/test_torch_cuda.py's
``test_cuda_graphed_admm_solve_keeps_the_eager_bits``.
"""

import math

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from colaborativempc_tpu_torch.ops import admm
from colaborativempc_tpu_torch.ops.admm import (
    ADMMSolution, admm_epoch_assoc, admm_epoch_inputs, admm_solve,
    default_epoch_len,
)
from colaborativempc_tpu_torch.ops.cuda_lqr import admm_epoch_batched

from test_torch_cuda import problems

torch.set_num_threads(2)


def frozen_admm_solve(qp, z0, w0=None, y0=None, iters=100, rho=10.0,
                      alpha=1.6, eps=1e-4, reg=1e-8, epoch_len=None,
                      rho_scale0=1.0, max_rho_scale=1e6, feas_tol=1e-2,
                      assoc=False):
    """``admm_solve``'s loop before the CUDA graph, spans left out: the
    reference of the bits."""
    P, N, m = qp.lo.shape
    dtype, dev = z0.dtype, z0.device
    nz, nc = qp.dyn.F.shape[-1], qp.dyn.G.shape[-1]
    if epoch_len is None:
        epoch_len = default_epoch_len(N)
    n_epochs = max(1, iters // epoch_len)
    if w0 is None:
        w0 = torch.clamp(torch.zeros((P, N, m), dtype=dtype, device=dev),
                         qp.lo, qp.hi)
    if y0 is None:
        y0 = torch.zeros((P, N, m), dtype=dtype, device=dev)
    z = torch.zeros((P, N + 1, nz), dtype=dtype, device=dev)
    c = torch.zeros((P, N, nc), dtype=dtype, device=dev)
    w, y = w0, y0
    rho_scale = torch.broadcast_to(
        torch.as_tensor(rho_scale0, dtype=dtype, device=dev), (P, m)).clone()
    it = torch.zeros((P,), dtype=torch.int64, device=dev)
    r_prim = torch.full((P, m), torch.inf, dtype=dtype, device=dev)
    r_dual = torch.full((P, m), torch.inf, dtype=dtype, device=dev)
    z0c = z0.contiguous()

    def any_active():
        not_conv = ((torch.amax(r_prim, dim=1) > eps)
                    | (torch.amax(r_dual, dim=1) > eps))
        active = (it < n_epochs * epoch_len) & not_conv
        return active, bool(active.any())

    active, go = any_active()
    for e in range(n_epochs):
        if not go:
            break
        if assoc and dev.type == "cpu":
            z_e, c_e, w_e, y_e, rp_e, rd_e = admm_epoch_assoc(
                qp, z0c, w, y, rho, rho_scale, reg, epoch_len=epoch_len,
                alpha=alpha)
        else:
            data = admm_epoch_inputs(qp, rho, rho_scale, reg)
            z_e, c_e, w_e, y_e, rp_e, rd_e = admm_epoch_batched(
                data, z0c, w.contiguous(), y.contiguous(),
                epoch_len=epoch_len, alpha=alpha)
        ratio = torch.sqrt(rp_e / torch.clamp_min(rd_e, 1e-12))
        ratio = torch.clamp(ratio, 0.2, 10.0)
        new_scale = torch.clamp(rho_scale * ratio, 1e-3, max_rho_scale)
        quiet = (rp_e < eps) & (rd_e < eps)
        new_scale = torch.where(quiet, rho_scale, new_scale)
        y_e = y_e * (rho_scale / new_scale)[:, None, :]
        a1 = active[:, None]
        a2 = active[:, None, None]
        z = torch.where(a2, z_e, z)
        c = torch.where(a2, c_e, c)
        w = torch.where(a2, w_e, w)
        y = torch.where(a2, y_e, y)
        rho_scale = torch.where(a1, new_scale, rho_scale)
        r_prim = torch.where(a1, rp_e, r_prim)
        r_dual = torch.where(a1, rd_e, r_dual)
        it = it + epoch_len * active.to(it.dtype)
        if e + 1 < n_epochs:
            active, go = any_active()
    r_p = torch.amax(r_prim, dim=1)
    return ADMMSolution(z=z, c=c, w=w, y=y, rho_scale=rho_scale,
                        iterations=it, r_prim=r_p,
                        r_dual=torch.amax(r_dual, dim=1),
                        feasible=r_p < feas_tol)


def eager_graph(qp, z0, *, iters, epoch_len, eps=1e-4, rho=10.0,
                alpha=1.6, reg=1e-8, max_rho_scale=1e6):
    """An ``_EpochGraph`` whose epochs run its body eagerly, and the number
    of its budget's epochs."""
    n_epochs = max(1, iters // epoch_len)
    g = admm._EpochGraph(qp, z0, dict(rho=rho, alpha=alpha, eps=eps,
                                      reg=reg, epoch_len=epoch_len,
                                      max_rho_scale=max_rho_scale),
                         n_epochs * epoch_len)
    g.run = g.step
    return g, n_epochs


def bits_equal(a, b):
    return [k for k, x, y in zip(ADMMSolution._fields, a, b)
            if x.dtype != y.dtype or x.shape != y.shape
            or not torch.equal(x, y)]


# (P, N, mr, iters, epoch_len, eps) at the benchmark's three families'
# shapes (LPV one fleet, NL a few agents, MPCC one race) and a batch that
# stops before its budget; the warm starts and rho_scale0 differ per case
CASES = {
    "lpv_p3_n125": (3, 125, 6, 300, 15, 1e-4),
    "nl_p6_n20": (6, 20, 6, 300, 20, 1e-4),
    "mpcc_p1_n60": (1, 60, 7, 200, 15, 1e-4),
    "stops_early": (5, 20, 6, 2000, 20, 1e-3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_epoch_body_looped_eagerly_keeps_the_bits(case):
    P, N, mr, iters, el, eps = CASES[case]
    qp, z0, w0, y0 = problems(70 + P + N, P=P, N=N, mr=mr)
    rs0 = torch.linspace(0.5, 2.0, mr)
    kw = dict(iters=iters, epoch_len=el, eps=eps)
    ref = frozen_admm_solve(qp, z0, w0, y0, rho_scale0=rs0, **kw)
    g, n_epochs = eager_graph(qp, z0, **kw)
    got = g.solve(qp, z0, w0, y0, rs0, n_epochs, 1e-2)
    assert bits_equal(got, ref) == []
    assert bits_equal(admm_solve(qp, z0, w0, y0, rho_scale0=rs0, **kw),
                      ref) == []
    its = ref.iterations.tolist()
    assert min(its) >= el
    if P > 1:
        assert len(set(its)) > 1, its        # problems freeze apart
    if case == "stops_early":
        assert max(its) < n_epochs * el, its
    # the buffers are reused: a second solve of other problems in the same
    # graph gives that solve's bits and leaves the first's result alone
    kept = [t.clone() for t in got]
    qp2, z02, w02, y02 = problems(170 + P + N, P=P, N=N, mr=mr)
    got2 = g.solve(qp2, z02, w02, y02, 1.0, n_epochs, 1e-2)
    assert bits_equal(got2, frozen_admm_solve(qp2, z02, w02, y02,
                                              **kw)) == []
    assert bits_equal(got, kept) == []


def test_epoch_with_no_active_problem_changes_no_state():
    qp, z0, w0, y0 = problems(81, P=4, N=20)
    g, n_epochs = eager_graph(qp, z0, iters=100, epoch_len=20)
    g.load(qp, z0, w0, y0, 1.0)
    g.step()                                 # a state of one real epoch
    before = admm._ADMMState(*(t.clone() for t in g.state))
    g.active.fill_(False)
    flag = g.step()
    for name, a, b in zip(admm._ADMMState._fields, g.state, before):
        assert torch.equal(a, b), name
    # the next mask is the unchanged state's
    nxt = admm._still_active(before, 1e-4, n_epochs * 20)
    assert torch.equal(g.active, nxt) and bool(flag) == bool(nxt.any())


class Reads(TorchDispatchMode):
    """Counts the ops that read a tensor's value on the host."""
    READS = {"_local_scalar_dense", "item", "is_nonzero", "equal",
             "nonzero"}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func.overloadpacket.__name__ in self.READS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("eps", [1e-4, math.inf, -math.inf, math.nan])
def test_first_read_only_where_eps_is_not_finite(eps):
    """With a finite eps every problem runs the first epoch (no iteration
    yet, infinite residuals), so the loop reads nothing before it; a
    non-finite eps reads the mask as before and keeps the old result (inf
    and nan: no epoch; -inf: the whole budget)."""
    qp, z0, w0, y0 = problems(82, P=4, N=8)
    kw = dict(iters=100, epoch_len=10, eps=eps)
    g, n_epochs = eager_graph(qp, z0, **kw)
    with Reads() as reads:
        go = g.load(qp, z0, w0, y0, 1.0)
    assert reads.n == (0 if math.isfinite(eps) else 1)
    assert go == (eps < math.inf)
    got = g.solve(qp, z0, w0, y0, 1.0, n_epochs, 1e-2)
    ref = frozen_admm_solve(qp, z0, w0, y0, **kw)
    assert bits_equal(got, ref) == []
    if not math.isfinite(eps):
        assert set(ref.iterations.tolist()) == {100 if eps < 0 else 0}


def test_cpu_tensors_record_and_replay_no_graph():
    qp, z0, w0, y0 = problems(83, P=3, N=8)
    before = (admm_solve.graph_records, admm_solve.graph_replays,
              list(admm._GRAPHS))
    for assoc in (False, True):
        admm_solve(qp, z0, w0, y0, iters=60, epoch_len=10, assoc=assoc)
    assert (admm_solve.graph_records, admm_solve.graph_replays,
            list(admm._GRAPHS)) == before


class Traffic(TorchDispatchMode):
    """Lists each op that reads a value back on the host, builds a tensor
    from Python data, or touches tensors of more than one device: none of
    them may run inside a recorded epoch."""
    FROM_HOST = {"lift_fresh", "lift_fresh_copy"}

    def __init__(self):
        super().__init__()
        self.bad, self.names = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        self.names.append(name)
        devs = {t.device for t in torch.utils._pytree.tree_leaves(
            (args, kwargs, out)) if isinstance(t, torch.Tensor)}
        if "device" in kwargs and kwargs["device"] is not None:
            devs.add(torch.device(kwargs["device"]))
        if name in Reads.READS | self.FROM_HOST or len(devs) > 1:
            self.bad.append(name)
        return out


def test_graphed_epoch_reads_nothing_back():
    """The graph's body (``_EpochGraph.step``) reads no value on the host
    and builds no tensor from Python data; on the card the same listing
    also holds every op to the card's tensors."""
    qp, z0, w0, y0 = problems(84, P=3, N=20)
    g, _ = eager_graph(qp, z0, iters=100, epoch_len=20)
    g.load(qp, z0, w0, y0, 1.0)
    with Traffic() as ops:
        g.step()
    assert len(ops.names) > 20 and "_foreach_copy_" in ops.names
    assert ops.bad == []
