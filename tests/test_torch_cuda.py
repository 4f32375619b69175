"""The port's CUDA kernels against their plain PyTorch twins, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device: a
CUDA kernel has no CPU mode, and on CPU tensors the wrappers run the twins
that tests/test_torch_ops.py holds against the JAX package. This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

Tolerances are those the JAX package holds its Pallas kernels to
(tests/test_ops.py): 5e-5 for the affine solve; 1e-3 on z/c/w/y and 1e-4
on the residuals for the epoch; 1e-3 on a rollout's plans.
"""

import numpy as np
import pytest
import torch

from colaborativempc_tpu_torch.ops import (
    ADMMEpochData, LQRCost, LQRDynamics, StageQP, admm_epoch_inputs,
    admm_solve, cuda_lqr,
)

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
    qp, z0, _, _ = problems(54, P=16, N=20)
    before = cuda_lqr.admm_epoch_batched.launches
    sol = admm_solve(to(qp, cuda), z0.to(cuda), iters=300, epoch_len=20)
    launches = cuda_lqr.admm_epoch_batched.launches - before
    assert launches == int(sol.iterations.max()) // 20 >= 1
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
