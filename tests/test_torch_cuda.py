"""The port's CUDA kernels against their plain PyTorch twins, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device: a
CUDA kernel has no CPU mode, and on CPU tensors the wrappers run the twins
that tests/test_torch_ops.py holds against the JAX package. This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

Tolerances are those the JAX package holds its Pallas kernels to
(tests/test_ops.py): 5e-5 for the affine solve; 1e-3 on z/c/w/y and 1e-4
on the residuals for the epoch; 1e-3 on a rollout's plans. The epoch-data
kernel (``csrc/epoch_data.cu``) holds each field of its output within 1e-4
of the plain version's, relative to the larger of 1 and the field's max
|value| (float32 rounding over an N-stage Riccati chain, as
``chip_smoke.py`` phase 3c).
"""

import numpy as np
import pytest
import torch

from colaborativempc_tpu_torch.ops import (
    ADMMEpochData, LQRCost, LQRDynamics, StageQP, admm_epoch_inputs,
    admm_solve, cuda_lqr,
)
from colaborativempc_tpu_torch.ops.admm import admm_epoch_inputs_plain

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)

F32 = torch.float32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def problems(seed, P, N, nz=11, nc=2, mr=6):
    """P random stage QPs banded around a feasible rollout: row 0 soft,
    row 1 one-sided (hi = +inf), row 2 unbounded, the rest hard."""
    rng = np.random.default_rng(seed)
    F = np.eye(nz) + 0.05 * rng.normal(size=(P, N, nz, nz))
    G = 0.2 * rng.normal(size=(P, N, nz, nc))
    d = 0.01 * rng.normal(size=(P, N, nz))
    A = rng.normal(size=(P, N + 1, nz, nz))
    Rm = rng.normal(size=(P, N, nc, nc))
    z0 = rng.normal(size=(P, nz))
    D = 0.5 * rng.normal(size=(P, N, mr, nz))
    E = 0.5 * rng.normal(size=(P, N, mr, nc))
    ct = 0.3 * rng.normal(size=(P, N, nc))
    zs = [z0]
    for k in range(N):
        zs.append(np.einsum("pij,pj->pi", F[:, k], zs[-1])
                  + np.einsum("pij,pj->pi", G[:, k], ct[:, k]) + d[:, k])
    zs = np.stack(zs, 1)
    vt = (np.einsum("pkmi,pki->pkm", D, zs[:, :-1])
          + np.einsum("pkmi,pki->pkm", E, ct))
    lo = vt - rng.uniform(0.05, 0.5, size=vt.shape)
    hi = vt + rng.uniform(0.05, 0.5, size=vt.shape)
    hi[:, :, 1] = np.inf
    lo[:, :, 2], hi[:, :, 2] = -np.inf, np.inf
    soft = np.full(vt.shape, np.inf)
    soft[:, :, 0] = 50.0
    t = lambda a: torch.tensor(a, dtype=F32)  # noqa: E731
    qp = StageQP(
        dyn=LQRDynamics(t(F), t(G), t(d)),
        cost=LQRCost(t(0.1 * A @ np.swapaxes(A, -1, -2) + np.eye(nz)),
                     t(0.5 * rng.normal(size=(P, N + 1, nz))),
                     t(0.1 * Rm @ np.swapaxes(Rm, -1, -2) + np.eye(nc)),
                     t(0.5 * rng.normal(size=(P, N, nc))),
                     t(0.05 * rng.normal(size=(P, N, nz, nc)))),
        D=t(D), E=t(E), lo=t(lo), hi=t(hi), soft_lo=t(soft), soft_hi=t(soft))
    w0 = t(np.clip(0.1 * rng.normal(size=vt.shape), lo, hi))
    y0 = t(0.05 * rng.normal(size=vt.shape))
    return qp, t(z0), w0, y0


def to(tree, dev):
    return type(tree)(*(to(x, dev) if isinstance(x, tuple) else x.to(dev)
                        for x in tree))


def close(got, ref, atol):
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [20, 125])
def test_cuda_epoch_kernel_matches_plain_twin(cuda, N):
    qp, z0, w0, y0 = problems(51, P=37, N=N)
    data = admm_epoch_inputs(qp, rho=10.0)
    before = cuda_lqr.admm_epoch_batched.launches
    got = cuda_lqr.admm_epoch_batched(to(data, cuda), z0.to(cuda),
                                      w0.to(cuda), y0.to(cuda),
                                      epoch_len=20, alpha=1.6)
    torch.cuda.synchronize()
    assert cuda_lqr.admm_epoch_batched.launches == before + 1
    ref = cuda_lqr.admm_epoch_batched_plain(data, z0, w0, y0, epoch_len=20,
                                            alpha=1.6)
    for g, r in zip(got[:4], ref[:4]):
        close(g, r, 1e-3)
    for g, r in zip(got[4:], ref[4:]):
        close(g, r, 1e-4)


@pytest.mark.cuda
def test_cuda_affine_kernel_matches_plain_twin(cuda):
    qp, z0, _, _ = problems(52, P=37, N=20)
    d = admm_epoch_inputs(qp)
    args = (d.F, d.G, d.d, d.K, d.Quu_inv, d.Qxu, d.m, d.q, d.r, z0)
    before = cuda_lqr.lqr_affine_solve_batched.launches
    got = cuda_lqr.lqr_affine_solve_batched(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert cuda_lqr.lqr_affine_solve_batched.launches == before + 1
    ref = cuda_lqr.lqr_affine_solve_batched_plain(*args)
    close(got[0], ref[0], 5e-5)
    close(got[1], ref[1], 5e-5)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    qp, z0, w0, y0 = problems(53, P=5, N=8)
    dd = to(admm_epoch_inputs(qp), cuda)
    z0, w0, y0 = z0.to(cuda), w0.to(cuda), y0.to(cuda)
    before = cuda_lqr.admm_epoch_batched.launches
    with pytest.raises(TypeError, match="float32"):
        cuda_lqr.admm_epoch_batched(ADMMEpochData(*(t.double() for t in dd)),
                                    z0.double(), w0.double(), y0.double())
    with pytest.raises(ValueError, match="not contiguous"):
        cuda_lqr.admm_epoch_batched(
            dd._replace(F=dd.F.transpose(-1, -2)), z0, w0, y0)
    with pytest.raises(ValueError, match="shape"):
        cuda_lqr.admm_epoch_batched(dd, z0[:, :4].contiguous(), w0, y0)
    with pytest.raises(ValueError, match="expected cuda"):
        cuda_lqr.admm_epoch_batched(dd, z0, w0.cpu(), y0)
    assert cuda_lqr.admm_epoch_batched.launches == before


@pytest.mark.cuda
def test_cuda_admm_solve_runs_one_launch_per_epoch(cuda):
    """One launch of the epoch kernel and one of the epoch-data kernel per
    epoch."""
    qp, z0, _, _ = problems(54, P=16, N=20)
    before = cuda_lqr.admm_epoch_batched.launches
    before_data = cuda_lqr.epoch_data_batched.launches
    sol = admm_solve(to(qp, cuda), z0.to(cuda), iters=300, epoch_len=20)
    launches = cuda_lqr.admm_epoch_batched.launches - before
    assert launches == int(sol.iterations.max()) // 20 >= 1
    assert cuda_lqr.epoch_data_batched.launches - before_data == launches
    ref = admm_solve(qp, z0, iters=300, epoch_len=20)
    np.testing.assert_array_equal(sol.feasible.cpu().numpy(),
                                  ref.feasible.numpy())
    close(sol.z[ref.feasible], ref.z[ref.feasible], 1e-3)


@pytest.mark.cuda
def test_cuda_fleet_rollout_matches_cpu(cuda):
    from colaborativempc_tpu_torch.config import (
        ExperimentConfig, SolverConfig, lpv_gains,
    )
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.parallel import batch_fleet_state
    from colaborativempc_tpu_torch.runtime import (
        init_lpv_fleet, make_lpv_fleet_rollout,
    )
    cfg = ExperimentConfig(n_agents=3, N=8, dt=0.02, map_type="Highway",
                           gains=lpv_gains(),
                           solver=SolverConfig(admm_iters=100))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        track = make_track("Highway", device=dev)
        st = batch_fleet_state(init_lpv_fleet(track, cfg, device=dev), 2,
                               device=dev)
        dx = np.random.default_rng(0).normal(size=tuple(st.x0.shape)) * 0.02
        st = st._replace(x0=st.x0 + torch.tensor(dx, dtype=F32, device=dev))
        out[dev.type] = make_lpv_fleet_rollout(track, cfg, 3)(st)
    (fg, (_, _, mg)), (fc, (_, _, mc)) = out["cuda"], out["cpu"]
    close(fg.x_pred, fc.x_pred, 1e-3)
    assert torch.equal(mg.feasible.cpu(), mc.feasible)


@pytest.mark.cuda
def test_cuda_epoch_kernel_matches_plain_twin_at_the_hp_opt_shape(cuda):
    """The NL planner's hp_opt rows with three agents: nc=6, mr=10."""
    qp, z0, w0, y0 = problems(55, P=37, N=20, nc=6, mr=10)
    data = admm_epoch_inputs(qp, rho=10.0)
    got = cuda_lqr.admm_epoch_batched(to(data, cuda), z0.to(cuda),
                                      w0.to(cuda), y0.to(cuda),
                                      epoch_len=20, alpha=1.6)
    ref = cuda_lqr.admm_epoch_batched_plain(data, z0, w0, y0, epoch_len=20,
                                            alpha=1.6)
    for g, r in zip(got[:4], ref[:4]):
        close(g, r, 1e-3)
    for g, r in zip(got[4:], ref[4:]):
        close(g, r, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("coupling,sweep,tol", [
    ("eu", "jacobi", 1e-3), ("hp_opt", "jacobi", 1e-3),
    ("hp_opt", "gauss_seidel", 5e-3)])
def test_cuda_nl_rollout_matches_cpu(cuda, coupling, sweep, tol):
    """B=2 NL-OCD fleets for 3 steps on the card and on the CPU: plans
    within ``tol``, equal feasible flags and OCD iteration counts.

    hp_opt under Gauss-Seidel carries the JAX plane-slot defect (ROADMAP
    queue 3): pair (1, 2)'s price grows on a wrong plane, and the result
    becomes sensitive to float32 rounding — the JAX package and the port,
    both on the CPU, land 2.2e-3 apart at this shape (the other two cases
    ~1e-6). Its plans are held to 5e-3."""
    from colaborativempc_tpu_torch.scripts import monte_carlo
    out = {}
    for dev in (cuda, torch.device("cpu")):
        _, rollout, st = monte_carlo.setup(
            "nl", scenarios=2, agents=3, N=8, steps=3, device=dev,
            coupling=coupling, sweep=sweep)
        before = cuda_lqr.admm_epoch_batched.launches
        out[dev.type] = rollout(st)
        launched = cuda_lqr.admm_epoch_batched.launches - before
        assert (launched > 0) == (dev.type == "cuda")
    (fg, (_, _, mg)), (fc, (_, _, mc)) = out["cuda"], out["cpu"]
    close(fg.x_pred, fc.x_pred, tol)
    assert torch.equal(mg.feasible.cpu(), mc.feasible)
    assert torch.equal(mg.ocd_iterations.cpu(), mc.ocd_iterations)


@pytest.mark.cuda
@pytest.mark.parametrize("P,N,nc,mr,epoch_len,ring,qpb", [
    (37, 48, 2, 6, 20, None, None),   # N=48, the horizon resident
    (37, 125, 2, 6, 20, 8, None),     # a ring shorter than N, streamed
    (1, 20, 2, 6, 20, None, None),    # one QP
    (7, 20, 2, 6, 20, None, 4),       # the last block one warp short
    (37, 20, 2, 6, 1, None, None),    # epoch_len = 1
    (37, 20, 6, 10, 20, 4, None),     # hp_opt rows, streamed
])
def test_cuda_epoch_kernel_plans_match_plain_twin(cuda, P, N, nc, mr,
                                                  epoch_len, ring, qpb):
    """The epoch kernel under the launch plans it meets: resident and
    streamed rings, ragged blocks, one iteration, the hp_opt shape."""
    qp, z0, w0, y0 = problems(60 + N + P, P=P, N=N, nc=nc, mr=mr)
    data = admm_epoch_inputs(qp, rho=10.0)
    plan = cuda_lqr.kernel_plan(P, N, 11, nc, mr, ring=ring,
                                qps_per_block=qpb)
    assert (plan.ring < N) == (ring is not None and ring < N)
    got = cuda_lqr.admm_epoch_batched(to(data, cuda), z0.to(cuda),
                                      w0.to(cuda), y0.to(cuda),
                                      epoch_len=epoch_len, alpha=1.6,
                                      plan=plan)
    torch.cuda.synchronize()
    ref = cuda_lqr.admm_epoch_batched_plain(data, z0, w0, y0,
                                            epoch_len=epoch_len, alpha=1.6)
    for g, r in zip(got[:4], ref[:4]):
        close(g, r, 1e-3)
    for g, r in zip(got[4:], ref[4:]):
        close(g, r, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("ring", [None, 16])
def test_cuda_affine_kernel_matches_plain_twin_at_n125(cuda, ring):
    qp, z0, _, _ = problems(57, P=37, N=125)
    d = admm_epoch_inputs(qp)
    args = (d.F, d.G, d.d, d.K, d.Quu_inv, d.Qxu, d.m, d.q, d.r, z0)
    plan = cuda_lqr.kernel_plan(37, 125, 11, 2, 0, ring=ring)
    got = cuda_lqr.lqr_affine_solve_batched(*(a.to(cuda) for a in args),
                                            plan=plan)
    torch.cuda.synchronize()
    ref = cuda_lqr.lqr_affine_solve_batched_plain(*args)
    close(got[0], ref[0], 5e-5)
    close(got[1], ref[1], 5e-5)


def mpcc_qps(dev, P, N):
    """The first SQP iteration's normalised stage QPs of P cold-started
    races on oval_mt at horizon N."""
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.planners.mpcc import MPCCConfig
    from colaborativempc_tpu_torch.runtime import racing
    cfg = MPCCConfig(N=N)
    return racing.cold_start_qps(make_track(cfg.map_type, device=dev), cfg, P)


@pytest.mark.cuda
@pytest.mark.parametrize("P,N,epoch_len", [(1, 60, 15), (18, 20, 20)])
def test_cuda_epoch_kernel_matches_plain_twin_on_mpcc_qps(cuda, P, N,
                                                          epoch_len):
    """MPCC's 7-row QPs at the race's N=60 (one QP: one warp on one SM)
    and at the battery's 18 races, N=20."""
    qp, z0 = mpcc_qps(torch.device("cpu"), P, N)
    data = admm_epoch_inputs(qp, rho=10.0)
    assert data.lo.shape[-1] == 7
    w0 = torch.clamp(torch.zeros_like(qp.lo), qp.lo, qp.hi)
    y0 = torch.zeros_like(w0)
    got = cuda_lqr.admm_epoch_batched(to(data, cuda), z0.to(cuda),
                                      w0.to(cuda), y0.to(cuda),
                                      epoch_len=epoch_len, alpha=1.6)
    ref = cuda_lqr.admm_epoch_batched_plain(data, z0, w0, y0,
                                            epoch_len=epoch_len, alpha=1.6)
    for g, r in zip(got[:4], ref[:4]):
        close(g, r, 1e-3)
    for g, r in zip(got[4:], ref[4:]):
        close(g, r, 1e-4)


@pytest.mark.cuda
def test_cuda_admm_solve_runs_the_kernel_whatever_assoc_says(cuda):
    """On the card every epoch is the kernel: ``assoc=True`` launches it
    once per epoch and returns exactly what ``assoc=False`` returns."""
    qp, z0, _, _ = problems(56, P=3, N=60)
    qp, z0 = to(qp, cuda), z0.to(cuda)
    before = cuda_lqr.admm_epoch_batched.launches
    before_data = cuda_lqr.epoch_data_batched.launches
    a = admm_solve(qp, z0, iters=150, epoch_len=15, assoc=True)
    launches = cuda_lqr.admm_epoch_batched.launches - before
    assert launches == int(a.iterations.max()) // 15 >= 1
    assert cuda_lqr.epoch_data_batched.launches - before_data == launches
    b = admm_solve(qp, z0, iters=150, epoch_len=15, assoc=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_mpcc_race_matches_cpu(cuda):
    """Two races for 3 steps from a cold start on the card and on the CPU:
    states within 1e-3, equal reset flags."""
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.planners.mpcc import MPCCConfig
    from colaborativempc_tpu_torch.runtime import racing
    cfg = MPCCConfig(N=20)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        track = make_track(cfg.map_type, device=dev)
        st = racing.init_mpcc(track, cfg, races=2, device=dev)
        out[dev.type] = racing.make_mpcc_rollout(track, cfg, 3)(st)
    (fg, mg), (fc, mc) = out["cuda"], out["cpu"]
    close(fg.x, fc.x, 1e-3)
    assert torch.equal(mg.reset.cpu(), mc.reset)


def close_to_scale(got, ref, tol):
    """Each field within ``tol`` of the reference, relative to the larger
    of 1 and the reference field's max |finite value|; NaN and infinite
    entries (unbounded rows' lo, hi) exactly where the reference has
    them."""
    for f, g, r in zip(ADMMEpochData._fields, got, ref):
        g, r = g.double().cpu(), r.double().cpu()
        fin = torch.isfinite(r)
        assert torch.equal(fin, torch.isfinite(g)), f
        assert torch.equal(g[~fin].nan_to_num(), r[~fin].nan_to_num()), f
        if bool(fin.any()):
            scale = max(1.0, float(r[fin].abs().max()))
            err = float((g[fin] - r[fin]).abs().max())
            assert err <= tol * scale, (f, err, scale)


def bits_differing(got, ref) -> int:
    """Entries whose bits differ (NaN against NaN counts as equal)."""
    return sum(int((g != r).sum()) - int((g.isnan() & r.isnan()).sum())
               for g, r in zip(got, ref))


def twice(qp):
    """A StageQP with every tensor repeated along the batch axis."""
    return type(qp)(*(twice(x) if isinstance(x, tuple) else
                      None if x is None else torch.cat([x, x]) for x in qp))


# (P, N, nz, nc, mr, source): the phase-3c shapes of chip_smoke.py, then
# every instantiation of the kernel (nc <= 2 / 8 / 32, rows of 12 or 32
# floats) at a shape the port reaches: hard rows only (soft weights None),
# NL hp_opt with 4 agents (nc=8, mr=13) and 5 (nc=10, mr=16), nz > 12
EPOCH_DATA_CASES = {
    "headline": (768, 20, 11, 2, 6, "random"),
    "n125": (24, 125, 11, 2, 6, "random"),
    "p7_inactive_rows": (7, 20, 11, 2, 6, "random"),
    "nl_eu": (192, 20, 11, 2, 6, "random"),
    "nl_hp_opt": (192, 20, 11, 6, 10, "random"),
    "mpcc_p18_n20": (18, 20, 11, 2, 7, "mpcc"),
    "mpcc_p1_n60": (1, 60, 11, 2, 7, "mpcc"),
    "hard_rows": (3, 60, 11, 2, 7, "hard"),
    "nl_hp_opt_4_agents": (256, 20, 11, 8, 13, "random"),
    "nl_hp_opt_5_agents": (320, 20, 11, 10, 16, "random"),
    "nz16": (48, 20, 16, 2, 6, "random"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EPOCH_DATA_CASES))
def test_cuda_epoch_data_kernel_matches_plain_version(cuda, case):
    """``admm_epoch_inputs`` on the card (one launch of the epoch-data
    kernel) against its plain version on the same CUDA tensors, at the
    shapes of the main paths and at every instantiation of the kernel: 0
    entries whose bits differ (the kernel keeps the order of the card
    libraries' batched routines), each field within 1e-4 of its scale.
    Random QPs carry a per-problem rho_scale and unbounded, one-sided and
    soft rows (hard ones: no soft weights at all); MPCC's are the races'
    own, a single QP compared as a batch of two (the libraries take
    other routines for one matrix)."""
    P, N, nz, nc, mr, source = EPOCH_DATA_CASES[case]
    if source == "mpcc":
        qp = mpcc_qps(cuda, P, N)[0]
        scale = 1.0
    else:
        qp, _, _, _ = problems(70 + N + nc + P, P=P, N=N, nz=nz, nc=nc,
                               mr=mr)
        qp = to(qp, cuda)
        if source == "hard":
            qp = qp._replace(soft_lo=None, soft_hi=None)
        scale = torch.linspace(0.5, 2.0, P * mr, device=cuda).reshape(P, mr)
    assert qp.lo.shape == (P, N, mr) and qp.dyn.F.shape[-1] == nz
    if P == 1:
        qp = twice(qp)
    before = cuda_lqr.epoch_data_batched.launches
    got = admm_epoch_inputs(qp, 10.0, scale)
    torch.cuda.synchronize()
    assert cuda_lqr.epoch_data_batched.launches == before + 1
    ref = admm_epoch_inputs_plain(qp, 10.0, scale)
    assert all(t.is_contiguous() and t.is_cuda for t in got)
    if source != "mpcc":
        assert bool((got.rv == 0).any())
    assert bits_differing(got, ref) == 0
    close_to_scale(got, ref, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("nc,mr", [(2, 6), (6, 10)])
def test_cuda_clocked_build_matches_default_build(cuda, nc, mr):
    """The clock-stamped build (``-DCMPC_EPOCH_DATA_CLOCKS``, a library of
    its own) gives the default build's outputs bit for bit, and stamps
    every barrier of every block in order: known labels, the last warp
    never before thread 0, the clocks rising; each block's last row holds
    its SM and its start and end on the global timer."""
    qp, _, _, _ = problems(90 + nc, P=9, N=21, nc=nc, mr=mr)
    qp = to(qp, cuda)
    before = cuda_lqr.epoch_data_batched.launches
    got, stamps, names, plan = cuda_lqr.epoch_data_clocked(qp, 10.0, 1.3)
    assert cuda_lqr.epoch_data_batched.launches == before
    ref = cuda_lqr.epoch_data_batched(qp, 10.0, 1.3)
    torch.cuda.synchronize()
    assert bits_differing(got, ref) == 0
    assert all(torch.equal(g.isnan(), r.isnan()) for g, r in zip(got, ref))
    st, block = stamps[:, :-1].cpu(), stamps[:, -1].cpu()
    assert stamps.shape[0] == 9 and bool((st[..., 0] >= 1).all())
    assert bool((st[..., 0] < len(names)).all())
    assert bool((st[..., 2] >= st[..., 1]).all())
    assert bool((st[:, 1:, 2] > st[:, :-1, 2]).all())
    assert bool((block[:, 0] <= -2).all())
    assert bool((block[:, 2] > block[:, 1]).all())
    assert plan.chunk <= 21


@pytest.mark.cuda
def test_cuda_epoch_data_kernel_gives_nan_where_quu_is_indefinite(cuda):
    """A stage whose Quu is not positive definite: NaN at the same places
    as the plain version (that stage's K and Quu_inv, every earlier
    stage's data), the same values elsewhere."""
    qp, _, _, _ = problems(71, P=4, N=12)
    R = qp.cost.R.clone()
    R[:, 5] = -100.0 * torch.eye(2)
    qp = to(qp._replace(cost=qp.cost._replace(R=R)), cuda)
    got = admm_epoch_inputs(qp, 10.0)
    ref = admm_epoch_inputs_plain(qp, 10.0)
    assert bool(torch.isnan(got.K[:, :6]).all())
    assert bool(torch.isfinite(got.K[:, 6:]).all())
    close_to_scale(got, ref, 1e-4)


@pytest.mark.cuda
def test_cuda_epoch_data_refuses_what_the_kernel_does_not_take(cuda):
    """float64, a transposed (non-contiguous) field, a wrong shape and a
    field left on the CPU each raise before any launch; nothing falls back
    to the plain version."""
    qp, _, _, _ = problems(72, P=5, N=8)
    qp = to(qp, cuda)
    before = cuda_lqr.epoch_data_batched.launches
    with pytest.raises(TypeError, match="float32"):
        admm_epoch_inputs(to(qp, cuda)._replace(
            dyn=LQRDynamics(*(t.double() for t in qp.dyn))))
    with pytest.raises(ValueError, match="not contiguous"):
        admm_epoch_inputs(qp._replace(
            dyn=qp.dyn._replace(F=qp.dyn.F.transpose(-1, -2))))
    with pytest.raises(ValueError, match="shape"):
        admm_epoch_inputs(qp._replace(D=qp.D[..., :4].contiguous()))
    with pytest.raises(ValueError, match="expected cuda"):
        admm_epoch_inputs(qp._replace(hi=qp.hi.cpu()))
    assert cuda_lqr.epoch_data_batched.launches == before


# --- the SQP build kernels (csrc/sqp_qp.cu) ----------------------------------

def nl_build_args(dev, B, N, coupling, map_type="Highway", lanes=False,
                  edges=False, seed=7):
    """``build_nl_qp``'s arguments for B perturbed 3-agent fleets as the
    Jacobi sweep hands them to it, with random prices; ``lanes`` puts every
    other problem on lane 1, ``edges`` vx below and at the velocity gate
    and a NaN into the linearisation point (as ``chip_smoke.py`` phase
    3d)."""
    from colaborativempc_tpu_torch.config import SysLimits
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.runtime.ocd import _bisector_planes
    from colaborativempc_tpu_torch.runtime.simulate import (
        _neighbour_index, _per_agent_limits,
    )
    from colaborativempc_tpu_torch.scripts import monte_carlo
    n = 3
    cfg, _, st = monte_carlo.setup("nl", scenarios=B, agents=n, N=N,
                                   steps=1, device=dev, coupling=coupling,
                                   map_type=map_type)
    ns = torch.as_tensor(_neighbour_index(n), device=dev)
    ids = torch.arange(n, device=dev)
    rng = np.random.default_rng(seed)
    lam = torch.tensor(rng.uniform(0.0, 1.0, size=(B, n, n - 1, N)),
                       dtype=F32, device=dev)
    x_bar = torch.cat([st.x0[:, :, None], st.x_pred[:, :, 1:]], dim=2)
    planes = _bisector_planes(x_bar)[:, torch.minimum(ids[:, None], ns),
                                     torch.maximum(ids[:, None], ns)]
    neigh = x_bar[:, ns][..., 7:9].transpose(2, 3)

    def flat(t):
        return t.reshape((B * n,) + t.shape[2:]).contiguous()
    x_bar = flat(x_bar)
    if edges:
        x_bar[:, 2:N:4, 0] = 0.1
        x_bar[:, 3:N:4, 0] = 0.2
        x_bar[0, 1, 0] = float("nan")
    P = B * n
    return dict(
        track=make_track(map_type, device=dev), gains=cfg.gains,
        limits=SysLimits(*(v.repeat(B) for v in _per_agent_limits(cfg, dev))),
        model=cfg.model, N=N, dt=cfg.dt, x_bar=x_bar, u_bar=flat(st.u_pred),
        lambdas=flat(lam), neigh_xy=flat(neigh),
        master_mask=flat((ids[:, None] < ns).float().expand(B, n, n - 1)),
        coupling=coupling, lane=torch.arange(P, device=dev) % 2 if lanes
        else 0, planes0=flat(planes) if coupling == "hp_opt" else None)


def mpcc_build_args(dev, P, N, edges=False, seed=11):
    """``build_mpcc_qp``'s arguments for P cold-started races with noise;
    ``edges`` vx at and below the slip floor and a NaN."""
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.geometry.frenet import frenet_to_cartesian
    from colaborativempc_tpu_torch.planners.mpcc import MPCCConfig
    from colaborativempc_tpu_torch.runtime import racing
    cfg = MPCCConfig(N=N)
    track = make_track(cfg.map_type, device=dev)
    s = torch.arange(P, dtype=F32, device=dev) * (
        float(track.track_length[0]) / P)
    px, py, th = frenet_to_cartesian(track, s, 0.0)
    zero = torch.zeros_like(s)
    x0 = torch.stack([0.5 + 0.05 * torch.arange(P, device=dev), zero, zero,
                      zero, zero, th, s, px, py], dim=-1)
    x_bar, u_bar = racing._cold_guess(track, cfg, x0)
    rng = np.random.default_rng(seed)
    x_bar = x_bar + torch.tensor(
        rng.normal(size=x_bar.shape) * [0.1, 0.05, 0.3, 0.05, 0.05, 0, 0, 0,
                                        0], dtype=F32, device=dev)
    u_bar = u_bar + torch.tensor(rng.normal(size=u_bar.shape) * [0.05, 0.1],
                                 dtype=F32, device=dev)
    if edges:
        x_bar[:, 2:N:4, 0] = 0.3
        x_bar[:, 3:N:4, 0] = 0.1
        x_bar[0, 1, 0] = float("nan")
    return dict(track=track, gains=cfg.gains, p=cfg.model, N=N, dt=cfg.dt,
                x_bar=x_bar.contiguous(), u_bar=u_bar.contiguous(),
                bounds=cfg.bounds)


def qp_close_to_scale(got, ref, tol):
    """``close_to_scale`` over every field of two StageQPs."""
    for g, r in ((got.dyn, ref.dyn), (got.cost, ref.cost)):
        for f, a, b in zip(g._fields, g, r):
            _field_close(f, a, b, tol)
    for f in ("D", "E", "lo", "hi", "soft_lo", "soft_hi"):
        _field_close(f, getattr(got, f), getattr(ref, f), tol)


def _field_close(f, g, r, tol):
    assert g.is_cuda and g.is_contiguous() and g.shape == r.shape, f
    g, r = g.double().cpu(), r.double().cpu()
    fin = torch.isfinite(r)
    assert torch.equal(fin, torch.isfinite(g)), f
    assert torch.equal(g[~fin].nan_to_num(), r[~fin].nan_to_num()), f
    if bool(fin.any()):
        scale = max(1.0, float(r[fin].abs().max()))
        err = float((g[fin] - r[fin]).abs().max())
        assert err <= tol * scale, (f, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nl_eu", "nl_hp_opt_edges",
                                  "nl_eu_oval2_lanes_n40", "mpcc_edges"])
def test_cuda_build_kernels_match_plain_versions(cuda, case):
    """``build_nl_qp`` / ``build_mpcc_qp`` on the card (one launch of the
    build kernel) against their plain versions on the same CUDA tensors,
    every field within 1e-4 of its scale (as ``chip_smoke.py`` phase 3d),
    NaN and infinities in the same places."""
    from colaborativempc_tpu_torch.ops import cuda_sqp
    from colaborativempc_tpu_torch.planners import mpcc, nl
    if case == "mpcc_edges":
        args = mpcc_build_args(cuda, 4, 20, edges=True)
        build, plain = mpcc.build_mpcc_qp, mpcc.build_mpcc_qp_plain
        wrapper = cuda_sqp.mpcc_qp_batched
    else:
        args = {"nl_eu": lambda: nl_build_args(cuda, 4, 20, "eu"),
                "nl_hp_opt_edges": lambda: nl_build_args(
                    cuda, 2, 20, "hp_opt", edges=True),
                "nl_eu_oval2_lanes_n40": lambda: nl_build_args(
                    cuda, 2, 40, "eu", map_type="Oval2", lanes=True)}[case]()
        build, plain = nl.build_nl_qp, nl.build_nl_qp_plain
        wrapper = cuda_sqp.nl_qp_batched
    before = wrapper.launches
    got = build(**args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    qp_close_to_scale(got, plain(**args), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["nl", "mpcc"])
def test_cuda_build_kernels_launch_once_per_sqp_build(cuda, family):
    """A 2-step rollout on the card: the build kernel launched once per
    SQP build (one per solve of the planner), the other family's never,
    and neither the linearisation nor torch.func ran."""
    from colaborativempc_tpu_torch.dynamics import pacejka
    from colaborativempc_tpu_torch.ops import cuda_sqp
    from colaborativempc_tpu_torch.planners import mpcc, nl
    planner = nl if family == "nl" else mpcc
    solves, forbidden = [], []
    orig = planner.admm_solve
    watched = {(nl, "_linearize_horizon"), (pacejka, "linearize_pacejka"),
               (pacejka, "tire_row_jacobians"),
               (pacejka, "_batched_jacobians"),
               (mpcc, "linearize_pacejka"), (mpcc, "tire_row_jacobians")}
    saved = {(m, a): getattr(m, a) for m, a in watched}

    def solve(*a, **kw):
        solves.append(1)
        return orig(*a, **kw)

    def refuse(name):
        def f(*a, **kw):
            forbidden.append(name)
            return saved[name](*a, **kw)
        return f
    planner.admm_solve = solve
    for key in watched:
        setattr(key[0], key[1], refuse(key))
    before = (cuda_sqp.nl_qp_batched.launches,
              cuda_sqp.mpcc_qp_batched.launches)
    try:
        if family == "nl":
            from colaborativempc_tpu_torch.scripts import monte_carlo
            _, roll, st = monte_carlo.setup("nl", scenarios=2, agents=3,
                                            N=20, steps=2, device=cuda)
            roll(st)
        else:
            from colaborativempc_tpu_torch.geometry import make_track
            from colaborativempc_tpu_torch.runtime import racing
            cfg = mpcc.MPCCConfig(N=20)
            track = make_track(cfg.map_type, device=cuda)
            racing.make_mpcc_rollout(track, cfg, 2)(
                racing.init_mpcc(track, cfg, races=2, device=cuda))
        torch.cuda.synchronize()
    finally:
        planner.admm_solve = orig
        for (m, a), fn in saved.items():
            setattr(m, a, fn)
    launched = (cuda_sqp.nl_qp_batched.launches - before[0],
                cuda_sqp.mpcc_qp_batched.launches - before[1])
    assert solves and not forbidden
    assert launched == ((len(solves), 0) if family == "nl"
                        else (0, len(solves)))


@pytest.mark.cuda
def test_cuda_build_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    """float64, a transposed (non-contiguous) input and a track left on
    the CPU each raise before any launch; nothing falls back to the plain
    version."""
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.ops import cuda_sqp
    args = nl_build_args(cuda, 1, 8, "eu")
    before = cuda_sqp.nl_qp_batched.launches
    with pytest.raises(TypeError, match="float32"):
        cuda_sqp.nl_qp_batched(**dict(args, x_bar=args["x_bar"].double()))
    lam = args["lambdas"]
    with pytest.raises(ValueError, match="not contiguous"):
        cuda_sqp.nl_qp_batched(**dict(
            args, lambdas=lam.transpose(1, 2).contiguous().transpose(1, 2)))
    with pytest.raises(ValueError, match="expected cuda"):
        cuda_sqp.nl_qp_batched(**dict(args, track=make_track(
            "Highway", device="cpu")))
    assert cuda_sqp.nl_qp_batched.launches == before
