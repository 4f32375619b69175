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


# (P, N, epoch_len) of the benchmark's epoch launches: the LPV Monte-Carlo's
# 192 QPs and one LPV fleet's 3 at N=125, the NL Monte-Carlo's 192 at N=20
BENCH_EPOCHS = [(192, 125, 15), (3, 125, 15), (192, 20, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("P,N,epoch_len",
                         [(37, 20, 20), (37, 125, 20)] + BENCH_EPOCHS)
def test_cuda_epoch_kernel_matches_plain_twin(cuda, P, N, epoch_len):
    """The epoch kernel against its plain twin, also at the benchmark's
    shapes; each launch takes the register chain."""
    qp, z0, w0, y0 = problems(51, P=P, N=N)
    data = admm_epoch_inputs(qp, rho=10.0)
    before = (cuda_lqr.admm_epoch_batched.launches,
              cuda_lqr.admm_epoch_batched.pipelined_launches)
    got = cuda_lqr.admm_epoch_batched(to(data, cuda), z0.to(cuda),
                                      w0.to(cuda), y0.to(cuda),
                                      epoch_len=epoch_len, alpha=1.6)
    torch.cuda.synchronize()
    assert (cuda_lqr.admm_epoch_batched.launches,
            cuda_lqr.admm_epoch_batched.pipelined_launches) == (
                before[0] + 1, before[1] + 1)
    ref = cuda_lqr.admm_epoch_batched_plain(data, z0, w0, y0,
                                            epoch_len=epoch_len, alpha=1.6)
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
    (7, 20, 2, 35, 20, None, None),   # LPV 32 agents: rows past a warp
    (7, 20, 33, 33, 20, 4, None),     # controls and rows of 33, streamed
    (5, 20, 34, 52, 20, 4, None),     # NL hp_opt 17 agents, streamed
    (3, 20, 64, 97, 20, 1, None),     # NL hp_opt 32 agents, ring of 1
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
def test_cuda_epoch_kernel_at_hp_opt_16_agents_n125_as_near_float64(cuda):
    """NL hp_opt's 16 agents at N=125 (nc=32, mr=49, a streamed ring):
    z, c, w, y within 1e-3 of the float32 twin; the residuals, where the
    float32 twin itself lies ~1.5e-4 from the twin in float64 (over the
    1e-4 the other shapes are held to), no farther from the float64 twin
    than 1.5 times the float32 twin is."""
    qp, z0, w0, y0 = problems(62, P=8, N=125, nc=32, mr=49)
    data = admm_epoch_inputs(qp, rho=10.0)
    kw = dict(epoch_len=20, alpha=1.6)
    before = cuda_lqr.admm_epoch_batched.launches
    got = cuda_lqr.admm_epoch_batched(to(data, cuda), z0.to(cuda),
                                      w0.to(cuda), y0.to(cuda), **kw)
    torch.cuda.synchronize()
    assert cuda_lqr.admm_epoch_batched.launches == before + 1
    ref = cuda_lqr.admm_epoch_batched_plain(data, z0, w0, y0, **kw)
    ref64 = cuda_lqr.admm_epoch_batched_plain(
        type(data)(*(t.double() for t in data)), z0.double(), w0.double(),
        y0.double(), **kw)
    for g, r in zip(got[:4], ref[:4]):
        close(g, r, 1e-3)
    for g, r, r64 in zip(got[4:], ref[4:], ref64[4:]):
        kernel = float((g.cpu().double() - r64).abs().max())
        plain = float((r.double() - r64).abs().max())
        assert kernel <= 1.5 * plain, (kernel, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("nc", [33, 52])
def test_cuda_affine_kernel_matches_plain_twin_past_32_controls(cuda, nc):
    """The affine kernel with more controls than a warp has lanes: each
    lane takes controls i, i + 32, ..."""
    qp, z0, _, _ = problems(58 + nc, P=9, N=20, nc=nc, mr=8)
    d = admm_epoch_inputs(qp)
    args = (d.F, d.G, d.d, d.K, d.Quu_inv, d.Qxu, d.m, d.q, d.r, z0)
    got = cuda_lqr.lqr_affine_solve_batched(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    ref = cuda_lqr.lqr_affine_solve_batched_plain(*args)
    close(got[0], ref[0], 5e-5)
    close(got[1], ref[1], 5e-5)


def held_epoch(got, data, z0, w0, y0, **kw):
    """An epoch launch against its plain twin on the CPU: z, c, w, y within
    1e-3; each residual (r_prim, r_dual) within 1e-4 of the twin's, or else
    held against the twin in float64: in the mean over the QPs of each
    QP's max |error|, the kernel no farther from it than twice the larger
    of the float32 twin's distance and 1e-4 (``chip_smoke.py``
    TOL_RESID_F64: over a long horizon or many rows the kernel's
    sequential sums part from the twin's library products past 1e-4 on
    the residuals, up to 2.1x as far from float64 in that measure already
    at shapes that fit shared memory: ``scripts/epoch_f64.py``)."""
    ref = cuda_lqr.admm_epoch_batched_plain(data, z0, w0, y0, **kw)
    for g, r in zip(got[:4], ref[:4]):
        close(g, r, 1e-3)
    ref64 = None
    for i, (g, r) in enumerate(zip(got[4:], ref[4:])):
        g = g.cpu()
        if float((g - r).abs().max()) <= 1e-4:
            continue
        if ref64 is None:
            ref64 = cuda_lqr.admm_epoch_batched_plain(
                type(data)(*(t.double() for t in data)), z0.double(),
                w0.double(), y0.double(), **kw)
        r64 = ref64[4 + i]
        plain = float((r.double() - r64).abs().amax(dim=1).mean())
        kernel = float((g.double() - r64).abs().amax(dim=1).mean())
        assert kernel <= 2.0 * max(plain, 1e-4), (i, kernel, plain)


@pytest.mark.cuda
def test_cuda_wrappers_spill_where_shared_memory_does_not_fit(cuda):
    """No size limit but device memory: the inputs that raised before the
    spill (the epoch kernel at NL hp_opt's 32 agents and N=125, nc=64 and
    mr=97; the epoch data at 1200 rows; the NL build at 70 hp_opt
    neighbours) now launch once each, from a plan that names what it
    spilled, and match their plain versions (the epoch by
    ``held_epoch``, the others bit for bit)."""
    from colaborativempc_tpu_torch.ops import cuda_sqp
    from colaborativempc_tpu_torch.planners import nl
    qp, z0, w0, y0 = problems(59, P=1, N=125, nc=64, mr=97)
    data = admm_epoch_inputs(qp)
    assert cuda_lqr.kernel_plan(1, 125, 11, 64, 97).spilled == "horizon"
    before = cuda_lqr.admm_epoch_batched.launches
    wide = cuda_lqr.admm_epoch_batched.pipelined_launches
    got = cuda_lqr.admm_epoch_batched(to(data, cuda), z0.to(cuda),
                                      w0.to(cuda), y0.to(cuda), epoch_len=5)
    torch.cuda.synchronize()
    assert cuda_lqr.admm_epoch_batched.launches == before + 1
    assert cuda_lqr.admm_epoch_batched.pipelined_launches == wide
    held_epoch(got, data, z0, w0, y0, epoch_len=5)
    big, _, _, _ = problems(60, P=2, N=2, nc=2, mr=1200)
    big = to(big, cuda)
    assert cuda_lqr.epoch_data_plan(2, 2, 11, 2, 1200).spilled == "block"
    before = cuda_lqr.epoch_data_batched.launches
    got = admm_epoch_inputs(big)
    torch.cuda.synchronize()
    assert cuda_lqr.epoch_data_batched.launches == before + 1
    assert bits_differing(got, admm_epoch_inputs_plain(big)) == 0
    args = sqp_build_case(cuda, "nl_hp_opt_9_agents")[1]
    P, N = args["x_bar"].shape[0], args["N"]
    args["neigh_xy"] = torch.zeros((P, N + 1, 70, 2), device=cuda)
    args["lambdas"] = torch.zeros((P, 70, N), device=cuda)
    args["master_mask"] = torch.zeros((P, 70), device=cuda)
    args["planes0"] = torch.zeros((P, 70, N, 2), device=cuda)
    before = cuda_sqp.nl_qp_batched.launches
    got = nl.build_nl_qp(**args)
    torch.cuda.synchronize()
    assert cuda_sqp.nl_qp_batched.launches == before + 1
    assert bits_differing(qp_leaves(got),
                          qp_leaves(nl.build_nl_qp_plain(**args))) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("spill", [1, 2, 3])
@pytest.mark.parametrize("P,N,nc,mr,ring", [
    (7, 20, 2, 6, None),      # one lane per index, the horizon resident
    (9, 45, 2, 6, 8),         # a streamed ring (below level 2)
    (5, 20, 34, 52, 4),       # lanes over controls and rows past 32
    (192, 125, 2, 6, None),   # the benchmark's: LPV Monte-Carlo (ring 32),
    (3, 125, 2, 6, None),     # one LPV fleet (the horizon resident),
    (192, 20, 2, 6, None),    # NL Monte-Carlo
])
def test_cuda_spilled_epoch_kernels_keep_the_bits(cuda, spill, P, N, nc, mr,
                                                  ring):
    """A launch whose plan spills w, y and kff (level 1), the ring too (2)
    or all its work (3) to global memory gives the bits of the same launch
    from shared memory, for the epoch kernel and the affine kernel; the
    benchmark's shapes keep the plan's ring."""
    qp, z0, w0, y0 = problems(300 + nc + N, P=P, N=N, nc=nc, mr=mr)
    d = to(admm_epoch_inputs(qp, rho=10.0), cuda)
    z0, w0, y0 = z0.to(cuda), w0.to(cuda), y0.to(cuda)
    if ring is None and N > 32:
        ring = cuda_lqr.kernel_plan(P, N, 11, nc, mr).ring
    pin = dict(ring=ring, qps_per_block=1)
    for m in (mr, 0):
        shared = cuda_lqr.kernel_plan(P, N, 11, nc, m, spill=0, **pin)
        spilled = cuda_lqr.kernel_plan(P, N, 11, nc, m, spill=spill, **pin)
        assert spilled.spilled == cuda_lqr.SPILLS[spill]
        assert spilled.scratch_bytes > 0 and shared.spilled == ""
        if m:
            run = lambda plan: cuda_lqr.admm_epoch_batched(  # noqa: E731
                d, z0, w0, y0, epoch_len=7, plan=plan)
        else:
            run = lambda plan: cuda_lqr.lqr_affine_solve_batched(  # noqa
                d.F, d.G, d.d, d.K, d.Quu_inv, d.Qxu, d.m, d.q, d.r, z0,
                plan=plan)
        a, b = run(shared), run(spilled)
        torch.cuda.synchronize()
        assert bits_differing(a, b) == 0


# the first fleets past one block's shared memory, (P = agents of one
# fleet, N, nc, mr): NL hp_opt 31 and 36 agents at N=125 (w, y and kff
# spilled), 48 agents at N=20 (the ring too), LPV 200 agents at N=125 and
# 760 at N=20
EPOCH_SPILL_SHAPES = {
    "hp_opt_31_agents_n125": (31, 125, 62, 94),
    "hp_opt_36_agents_n125": (36, 125, 72, 109),
    "hp_opt_48_agents": (48, 20, 96, 145),
    "lpv_200_agents_n125": (200, 125, 2, 203),
    "lpv_760_agents": (760, 20, 2, 763),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EPOCH_SPILL_SHAPES))
def test_cuda_epoch_kernels_at_the_spill_shapes_match_plain_twins(cuda,
                                                                   case):
    """The epoch kernel at the first fleets that spill, under the plan
    ``kernel_plan`` picks (``held_epoch``), and the affine kernel there
    (mr = 0) within 5e-5."""
    P, N, nc, mr = EPOCH_SPILL_SHAPES[case]
    qp, z0, w0, y0 = problems(400 + P + N, P=P, N=N, nc=nc, mr=mr)
    data = admm_epoch_inputs(qp, rho=10.0)
    plan = cuda_lqr.kernel_plan(P, N, 11, nc, mr)
    assert plan.spilled in ("horizon", "horizon+ring")
    wide = cuda_lqr.admm_epoch_batched.pipelined_launches
    got = cuda_lqr.admm_epoch_batched(to(data, cuda), z0.to(cuda),
                                      w0.to(cuda), y0.to(cuda),
                                      epoch_len=10, alpha=1.6)
    torch.cuda.synchronize()
    assert cuda_lqr.admm_epoch_batched.pipelined_launches == wide
    held_epoch(got, data, z0, w0, y0, epoch_len=10, alpha=1.6)
    args = (data.F, data.G, data.d, data.K, data.Quu_inv, data.Qxu, data.m,
            data.q, data.r, z0)
    got = cuda_lqr.lqr_affine_solve_batched(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    ref = cuda_lqr.lqr_affine_solve_batched_plain(*args)
    close(got[0], ref[0], 5e-5)
    close(got[1], ref[1], 5e-5)


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
    # the large fleets: rows past 32 with the factor in registers (NL eu
    # and LPV), the factor in shared memory in the libraries' panels (NL
    # hp_opt from 9 agents), either side of 32 controls and rows
    "nl_eu_10_agents": (20, 20, 11, 2, 13, "random"),
    "lpv_32_agents": (256, 20, 11, 2, 35, "random"),
    "nl_hp_opt_9_agents": (18, 20, 11, 18, 28, "random"),
    "nl_hp_opt_11_agents": (22, 20, 11, 22, 34, "random"),
    "nl_hp_opt_16_agents": (32, 20, 11, 32, 49, "random"),
    "nl_hp_opt_17_agents": (34, 20, 11, 34, 52, "random"),
    "nl_hp_opt_32_agents": (64, 20, 11, 64, 97, "random"),
    "nc32_mr32": (7, 20, 11, 32, 32, "random"),
    "nc33_mr33": (7, 20, 11, 33, 33, "random"),
    # past one block's shared memory, the block's layout in a global
    # scratch: NL hp_opt 36 and 48 agents (also 36 at N=125), LPV 1000
    "nl_hp_opt_36_agents": (36, 20, 11, 72, 109, "random"),
    "nl_hp_opt_48_agents": (48, 20, 11, 96, 145, "random"),
    "nl_hp_opt_36_agents_n125": (36, 125, 11, 72, 109, "random"),
    "lpv_1000_agents": (1000, 20, 11, 2, 1003, "random"),
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
@pytest.mark.parametrize("P,N,nc,mr", [(256, 20, 2, 35), (16, 20, 6, 40),
                                       (22, 20, 22, 34)])
def test_cuda_spilled_epoch_data_keeps_the_bits(cuda, P, N, nc, mr, monkeypatch):
    """The epoch data with its block's layout spilled to a global scratch
    (pinned) gives the bits of the launch from shared memory, for each
    instantiation that spills (nc <= 2, nc <= 8 with rows of runtime
    width, the factor in shared memory)."""
    qp, _, _, _ = problems(500 + nc, P=P, N=N, nc=nc, mr=mr)
    qp = to(qp, cuda)
    shared = admm_epoch_inputs(qp, 10.0, 1.3)
    plain_plan = cuda_lqr.epoch_data_plan
    monkeypatch.setattr(cuda_lqr, "_plan_cached", lambda *a: plain_plan(
        *a, spill=True))
    before = cuda_lqr.epoch_data_batched.launches
    spilled = admm_epoch_inputs(qp, 10.0, 1.3)
    torch.cuda.synchronize()
    assert cuda_lqr.epoch_data_batched.launches == before + 1
    assert bits_differing(spilled, shared) == 0


@pytest.mark.cuda
def test_cuda_epoch_data_at_hp_opt_11_agents_in_704_fleets_as_near_float64(
        cuda):
    """NL hp_opt's 11 agents at the Monte-Carlo's 64 scenarios (704 QPs,
    N=20: 14,080 stage matrices of 22 controls), where the card's batched
    solve takes another order than the kernel follows: each field within
    1e-4 of its scale of the float32 plain version, and no farther from
    the float64 plain version (as a share of the field's scale) than 1.5
    times the float32 plain version is."""
    qp, _, _, _ = problems(81, P=704, N=20, nc=22, mr=34)
    qp = to(qp, cuda)
    before = cuda_lqr.epoch_data_batched.launches
    got = admm_epoch_inputs(qp, 10.0, 1.3)
    torch.cuda.synchronize()
    assert cuda_lqr.epoch_data_batched.launches == before + 1
    ref = admm_epoch_inputs_plain(qp, 10.0, 1.3)
    close_to_scale(got, ref, 1e-4)
    ref64 = admm_epoch_inputs_plain(
        type(qp)(*(type(x)(*(t.double() for t in x)) if isinstance(x, tuple)
                   else None if x is None else x.double() for x in qp)),
        10.0, 1.3)
    share = {"kernel": 0.0, "plain": 0.0}
    for g, r, r64 in zip(got, ref, ref64):
        fin = torch.isfinite(r64)
        if not bool(fin.any()):
            continue
        scale = max(1.0, float(r64[fin].abs().max()))
        for name, x in (("kernel", g), ("plain", r)):
            share[name] = max(share[name], float(
                (x[fin].double() - r64[fin]).abs().max()) / scale)
    assert share["kernel"] <= 1.5 * share["plain"], share


def share_from_f64(got, ref, ref64):
    """The kernel's and the float32 plain version's largest distance from
    the float64 plain version, each as a share of the field's scale."""
    share = {"kernel": 0.0, "plain": 0.0}
    for g, r, r64 in zip(got, ref, ref64):
        fin = torch.isfinite(r64)
        if not bool(fin.any()):
            continue
        scale = max(1.0, float(r64[fin].abs().max()))
        for name, x in (("kernel", g), ("plain", r)):
            share[name] = max(share[name], float(
                (x[fin].double() - r64[fin]).abs().max()) / scale)
    return share


@pytest.mark.cuda
def test_cuda_epoch_data_at_hp_opt_100_agents_as_near_float64(cuda):
    """NL hp_opt's 100 agents (nc=200, mr=301; the block spilled), past the
    widths whose library order the kernel follows (cuBLAS's Qxu K over 200
    terms, MAGMA's K solves at 128-200 controls in small batches): each
    field within 1e-4 of its scale of the float32 plain version, and no
    farther from the float64 plain version than 1.5 times it is."""
    qp, _, _, _ = problems(82, P=100, N=20, nc=200, mr=301)
    qp = to(qp, cuda)
    assert cuda_lqr.epoch_data_plan(100, 20, 11, 200, 301).spilled == "block"
    got = admm_epoch_inputs(qp, 10.0, 1.3)
    ref = admm_epoch_inputs_plain(qp, 10.0, 1.3)
    close_to_scale(got, ref, 1e-4)
    ref64 = admm_epoch_inputs_plain(
        type(qp)(*(type(x)(*(t.double() for t in x)) if isinstance(x, tuple)
                   else None if x is None else x.double() for x in qp)),
        10.0, 1.3)
    share = share_from_f64(got, ref, ref64)
    assert share["kernel"] <= 1.5 * share["plain"], share


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
@pytest.mark.parametrize("P,N,ring", [(5, 45, 8), (3, 20, None)])
def test_cuda_clocked_epoch_kernel_matches_default_build(cuda, P, N, ring):
    """The clock-stamped epoch kernel (``-DCMPC_ADMM_EPOCH_CLOCKS``, a
    library of its own) gives the default build's outputs bit for bit and
    stamps every part of every QP's solve in order: known labels, the
    clocks rising, a streamed ring's feeds and waits where the ring holds
    fewer stages than N; each QP's last row holds its SM and its start and
    end on the global timer. It counts no launch of the main path."""
    qp, z0, w0, y0 = problems(95, P=P, N=N)
    data = to(admm_epoch_inputs(qp, rho=10.0), cuda)
    z0, w0, y0 = z0.to(cuda), w0.to(cuda), y0.to(cuda)
    plan = cuda_lqr.kernel_plan(P, N, 11, 2, 6, ring=ring)
    before = cuda_lqr.admm_epoch_batched.launches
    got, stamps, names, _ = cuda_lqr.admm_epoch_clocked(
        data, z0, w0, y0, epoch_len=3, plan=plan)
    assert cuda_lqr.admm_epoch_batched.launches == before
    ref = cuda_lqr.admm_epoch_batched(data, z0, w0, y0, epoch_len=3,
                                      plan=plan)
    torch.cuda.synchronize()
    assert bits_differing(got, ref) == 0
    st, qp_row = stamps[:, :-1].cpu(), stamps[:, -1].cpu()
    used = st[0, :, 0] >= 0
    assert bool((st[:, used, 0] == st[0, used, 0]).all())
    labels = st[0, used, 0].tolist()
    assert labels[:2] == [0, 1] and max(labels) < len(names)
    assert bool((st[:, used, 1] == st[:, used, 2]).all())
    assert bool((st[:, used][:, 1:, 2] >= st[:, used][:, :-1, 2]).all())
    assert (names.index("ring feed") in labels) == (plan.ring < N)
    assert bool((qp_row[:, 0] <= -2).all())
    assert bool((qp_row[:, 2] > qp_row[:, 1]).all())


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

def sqp_build_case(dev, case):
    """``(family, arguments)`` of a build case: ``chip_smoke.py`` phase
    3d's inputs (``scripts/sqp_qp_split.py nl_build_args`` /
    ``mpcc_build_args``: perturbed 3-agent fleets as the Jacobi sweep hands
    them to the build, cold-started races), at the case's shape."""
    from colaborativempc_tpu_torch.scripts.sqp_qp_split import (
        mpcc_build_args, nl_build_args,
    )
    family, P, n, N, opts = SQP_CASES[case]
    if family == "nl":
        args = nl_build_args(dev, P, n, N, **{
            k: v for k, v in opts.items() if k not in ("gains", "trust")})
        if opts.get("trust") is False:
            args["u_trust"] = None
        if opts.get("gains") == "per_problem":
            # every gain and limit a per-problem tensor, each problem its own
            rng = np.random.default_rng(P)
            g, lim = args["gains"], args["limits"]
            args["gains"] = g._replace(**{
                k: torch.tensor(np.asarray(v, np.float64) * rng.uniform(
                    0.5, 2.0, size=(P, np.size(v))), dtype=F32, device=dev)
                for k, v in g._asdict().items()})
            args["limits"] = type(lim)(*(
                torch.as_tensor(v, dtype=F32, device=dev).expand(P)
                * torch.tensor(rng.uniform(0.9, 1.1, size=P), dtype=F32,
                               device=dev) for v in lim))
        elif opts.get("gains") == "shared":
            # every limit a number, shared by every problem
            args["limits"] = type(args["limits"])(
                *(float(v[0]) for v in args["limits"]))
        return family, args
    return family, mpcc_build_args(dev, P, N, **opts)


# case: (family, problems, agents per fleet, N, options)
SQP_CASES = {
    "nl_eu": ("nl", 12, 3, 20, {}),
    "nl_hp_opt_edges": ("nl", 6, 3, 20, dict(coupling="hp_opt",
                                             edges=True)),
    "nl_eu_oval2_lanes_n40": ("nl", 6, 3, 40, dict(map_type="Oval2",
                                                    lanes=True)),
    "mpcc_edges": ("mpcc", 4, 0, 20, dict(edges=True)),
    # either side of each boundary of the batched matrix-vector order
    "nl_eu_p649": ("nl", 649, 3, 20, {}),
    "nl_eu_p650": ("nl", 650, 3, 20, {}),
    "nl_eu_p1864": ("nl", 1864, 3, 20, {}),
    "nl_eu_p1865": ("nl", 1865, 3, 20, {}),
    "mpcc_p9": ("mpcc", 9, 0, 20, {}),
    "mpcc_p10": ("mpcc", 10, 0, 20, {}),
    "mpcc_p66": ("mpcc", 66, 0, 20, {}),
    "mpcc_p67": ("mpcc", 67, 0, 20, {}),
    "mpcc_p142": ("mpcc", 142, 0, 20, {}),
    "mpcc_p143": ("mpcc", 143, 0, 20, {}),
    # hp_opt at 4, 5 and 9 agents (3, 4 and 8 neighbours)
    "nl_hp_opt_4_agents": ("nl", 64, 4, 20, dict(coupling="hp_opt")),
    "nl_hp_opt_5_agents": ("nl", 80, 5, 20, dict(coupling="hp_opt")),
    "nl_hp_opt_9_agents": ("nl", 36, 9, 20, dict(coupling="hp_opt")),
    "nl_hp": ("nl", 12, 3, 20, dict(coupling="hp")),
    "nl_eu_no_trust": ("nl", 12, 3, 20, dict(trust=False)),
    "nl_hp_opt_no_trust": ("nl", 12, 3, 20, dict(coupling="hp_opt",
                                                 trust=False)),
    "nl_eu_per_problem_gains": ("nl", 12, 3, 20, dict(gains="per_problem")),
    "nl_hp_opt_per_problem_gains": ("nl", 12, 3, 20, dict(
        coupling="hp_opt", gains="per_problem")),
    "nl_eu_shared_limits": ("nl", 12, 3, 20, dict(gains="shared")),
    # N not a multiple of the 8 stages of a block
    "nl_eu_ragged_n13": ("nl", 6, 3, 13, {}),
    "nl_hp_opt_ragged_n5": ("nl", 6, 3, 5, dict(coupling="hp_opt")),
    "mpcc_ragged_n13": ("mpcc", 3, 0, 13, {}),
    # a fitted track of more segments than the kernels stage in shared
    # memory: the lookups read the track's tables where they lie
    "nl_eu_3000_segments": ("nl", 12, 3, 20, dict(segments=3000)),
    "mpcc_3000_segments": ("mpcc", 4, 0, 20, dict(segments=3000)),
    # more neighbours: eu's price summed in torch.sum's order (4 agents:
    # 3 terms), past the former 8 neighbours (eu 10 and 32 agents, hp
    # 10, hp_opt 11 and 16), and fewer stages per block (hp_opt 32 agents)
    "nl_eu_4_agents": ("nl", 16, 4, 20, {}),
    "nl_eu_10_agents": ("nl", 20, 10, 20, {}),
    "nl_hp_10_agents": ("nl", 20, 10, 20, dict(coupling="hp")),
    "nl_eu_32_agents": ("nl", 64, 32, 20, {}),
    "nl_hp_opt_11_agents": ("nl", 22, 11, 20, dict(coupling="hp_opt")),
    "nl_hp_opt_16_agents": ("nl", 32, 16, 20, dict(coupling="hp_opt")),
    "nl_hp_opt_32_agents": ("nl", 64, 32, 20, dict(coupling="hp_opt")),
    # past one block's shared memory, the image in a global scratch:
    # hp_opt 72 and 100 agents; and eu 64 agents (63 terms in the sum)
    "nl_hp_opt_72_agents": ("nl", 72, 72, 20, dict(coupling="hp_opt")),
    "nl_hp_opt_100_agents": ("nl", 100, 100, 20, dict(coupling="hp_opt")),
    "nl_eu_64_agents": ("nl", 64, 64, 20, {}),
}


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
@pytest.mark.parametrize("case", sorted(SQP_CASES))
def test_cuda_build_kernels_match_plain_versions(cuda, case):
    """``build_nl_qp`` / ``build_mpcc_qp`` on the card (one launch of the
    build kernel) against their plain versions on the same CUDA tensors:
    no entry whose bits differ, every field within 1e-4 of its scale (as
    ``chip_smoke.py`` phase 3d), NaN and infinities in the same places."""
    from colaborativempc_tpu_torch.ops import cuda_sqp
    from colaborativempc_tpu_torch.planners import mpcc, nl
    family, args = sqp_build_case(cuda, case)
    if family == "nl":
        build, plain = nl.build_nl_qp, nl.build_nl_qp_plain
        wrapper = cuda_sqp.nl_qp_batched
    else:
        build, plain = mpcc.build_mpcc_qp, mpcc.build_mpcc_qp_plain
        wrapper = cuda_sqp.mpcc_qp_batched
    before = wrapper.launches
    got = build(**args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref = plain(**args)
    assert bits_differing(qp_leaves(got), qp_leaves(ref)) == 0
    qp_close_to_scale(got, ref, 1e-4)


def qp_leaves(qp):
    return [*qp.dyn, *qp.cost, qp.D, qp.E, qp.lo, qp.hi, qp.soft_lo,
            qp.soft_hi]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nl_eu", "nl_hp_opt_edges", "mpcc_edges",
                                  "nl_hp_opt_9_agents"])
def test_cuda_clocked_sqp_build_matches_default_build(cuda, case):
    """The clock-stamped build of the SQP kernels (``-DCMPC_SQP_QP_CLOCKS``,
    a library of its own) gives the default build's outputs bit for bit
    and counts no launch; every block stamps its start, barriers and end in
    order, the last warp never before thread 0, and its last row holds its
    SM and its start and end on the global timer."""
    from colaborativempc_tpu_torch.ops import cuda_sqp
    from colaborativempc_tpu_torch.planners import mpcc, nl
    family, args = sqp_build_case(cuda, case)
    wrapper = (cuda_sqp.nl_qp_batched if family == "nl"
               else cuda_sqp.mpcc_qp_batched)
    before = wrapper.launches
    got, stamps, names = cuda_sqp.sqp_qp_clocked(family, **args)
    assert wrapper.launches == before
    ref = (nl.build_nl_qp if family == "nl" else mpcc.build_mpcc_qp)(**args)
    torch.cuda.synchronize()
    assert bits_differing(qp_leaves(got), qp_leaves(ref)) == 0
    P, N = args["x_bar"].shape[0], args["N"]
    assert stamps.shape[0] == P * -(-N // cuda_sqp.STAGES_PER_BLOCK)
    st, block = stamps[:, :-1].cpu(), stamps[:, -1].cpu()
    used = st[0, :, 0] >= 0
    st = st[:, used]
    assert bool((st[..., 0] < len(names)).all())
    assert bool((st[..., 2] >= st[..., 1]).all())
    assert bool((st[:, 1:, 2] > st[:, :-1, 2]).all())
    assert bool((block[:, 0] <= -2).all())
    assert bool((block[:, 2] > block[:, 1]).all())


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
def test_cuda_nl_build_past_63_neighbours_as_near_float64(cuda):
    """NL eu 66 agents (65 neighbours, 1,320 outputs of the price sum),
    where torch.sum splits the terms over four warps, an order the kernel
    does not follow: every field within 1e-4 of its scale of the float32
    plain version, the entries off the price sum bit for bit, and the
    kernel no farther from the float64 plain version than 1.5 times it
    is."""
    from colaborativempc_tpu_torch.planners import nl
    from colaborativempc_tpu_torch.scripts.sqp_qp_split import (
        nl_build_args,
    )
    args = nl_build_args(cuda, 66, 66, 20, "eu")
    got = nl.build_nl_qp(**args)
    ref = nl.build_nl_qp_plain(**args)
    qp_close_to_scale(got, ref, 1e-4)
    g, r = qp_leaves(got), qp_leaves(ref)
    assert bits_differing(g[:4] + g[5:], r[:4] + r[5:]) == 0   # q aside
    a64 = {k: (v.double() if isinstance(v, torch.Tensor)
               and v.is_floating_point() and k in ("x_bar", "u_bar",
                                                   "lambdas", "neigh_xy",
                                                   "master_mask") else v)
           for k, v in args.items()}
    share = share_from_f64(g, r, qp_leaves(nl.build_nl_qp_plain(**a64)))
    assert share["kernel"] <= 1.5 * share["plain"], share


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nl_eu_10_agents", "nl_hp_opt_9_agents",
                                  "nl_eu_3000_segments"])
def test_cuda_spilled_nl_build_keeps_the_bits(cuda, case, monkeypatch):
    """The NL build with its image and neighbour arrays spilled to a global
    scratch (pinned) gives the bits of the launch from shared memory, on
    a staged track and on one searched where it lies."""
    from colaborativempc_tpu_torch.ops import cuda_sqp
    from colaborativempc_tpu_torch.planners import nl
    args = sqp_build_case(cuda, case)[1]
    shared = nl.build_nl_qp(**args)
    plain_plan = cuda_sqp.sqp_qp_plan
    monkeypatch.setattr(cuda_sqp, "sqp_qp_plan", lambda *a: plain_plan(
        *a, spill=True))
    before = cuda_sqp.nl_qp_batched.launches
    spilled = nl.build_nl_qp(**args)
    torch.cuda.synchronize()
    assert cuda_sqp.nl_qp_batched.launches == before + 1
    assert bits_differing(qp_leaves(spilled), qp_leaves(shared)) == 0


@pytest.mark.cuda
def test_cuda_build_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    """float64, a transposed (non-contiguous) input and a track left on
    the CPU each raise before any launch; nothing falls back to the plain
    version."""
    from colaborativempc_tpu_torch.geometry import make_track
    from colaborativempc_tpu_torch.ops import cuda_sqp
    from colaborativempc_tpu_torch.scripts.sqp_qp_split import (
        nl_build_args,
    )
    args = nl_build_args(cuda, 3, 3, 8, "eu")
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
