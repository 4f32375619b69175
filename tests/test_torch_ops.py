"""Parity of the PyTorch port's QP engine with the JAX package: the
Riccati factorisation and affine solve, the plain twins of the two CUDA
kernels against the Pallas kernels in interpret mode, and ``admm_solve``
including its per-problem freeze.

Tolerances: float64 Riccati parity 1e-8 (the same recursion, rounding
only); the float32 kernel twins use the tolerances the JAX package holds
its Pallas kernels to (tests/test_ops.py: 5e-5 for the affine solve, 1e-3 on
z/c/w/y and 1e-4 on the residuals for the epoch, 1e-4 on the multi-epoch
solution). The kernels themselves are compared with their twins on a card
by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colaborativempc_tpu.ops import admm as jadmm
from colaborativempc_tpu.ops import lqr as jlqr
from colaborativempc_tpu.ops.pallas_lqr import (
    admm_epoch_batched as j_epoch, lqr_affine_solve_batched as j_affine,
)
from colaborativempc_tpu.utils.precision import x64_island

from test_ops import _constrained_problem, random_problem

from colaborativempc_tpu_torch import interop
from colaborativempc_tpu_torch.ops import admm as tadmm
from colaborativempc_tpu_torch.ops import cuda_lqr
from colaborativempc_tpu_torch.ops import lqr as tlqr

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol)


def constrained_problem(rng, N=6, nz=3, nc=2, m=3):
    """tests/test_ops.py's feasible banded stage QP as a dict, row 0 soft on
    both sides (weight 50), the other rows hard."""
    names = "F G d Q R S q r z0 D E lo hi".split()
    p = dict(zip(names, _constrained_problem(rng, N=N, nz=nz, nc=nc, m=m)))
    p["soft"] = np.full((N, m), np.inf)
    p["soft"][:, 0] = 50.0
    return p


def stack(problems):
    return {k: np.stack([p[k] for p in problems]) for k in problems[0]}


def jax_qp(p, dtype):
    a = lambda x: jnp.asarray(x, dtype)  # noqa: E731
    return jadmm.StageQP(
        dyn=jlqr.LQRDynamics(a(p["F"]), a(p["G"]), a(p["d"])),
        cost=jlqr.LQRCost(a(p["Q"]), a(p["q"]), a(p["R"]), a(p["r"]),
                          a(p["S"])),
        D=a(p["D"]), E=a(p["E"]), lo=a(p["lo"]), hi=a(p["hi"]),
        soft_lo=a(p["soft"]), soft_hi=a(p["soft"]))


def port_qp(p, dtype):
    """The same batched problem through interop (dict of numpy arrays)."""
    return interop.stage_qp_from_numpy(dict(
        dyn=dict(F=p["F"], G=p["G"], d=p["d"]),
        cost=dict(Q=p["Q"], q=p["q"], R=p["R"], r=p["r"], S=p["S"]),
        D=p["D"], E=p["E"], lo=p["lo"], hi=p["hi"],
        soft_lo=p["soft"], soft_hi=p["soft"]), dtype=dtype, device="cpu")


def test_lqr_factorize_and_affine_solve_match_jax():
    rng = np.random.default_rng(11)
    pb = stack([dict(zip("F G d Q R S q r z0".split(),
                         random_problem(rng, N=9, nz=11, nc=2)))
                for _ in range(3)])
    with x64_island():
        a = {k: jnp.asarray(v) for k, v in pb.items()}
        dyn = jlqr.LQRDynamics(a["F"], a["G"], a["d"])
        cost = jlqr.LQRCost(a["Q"], a["q"], a["R"], a["r"], a["S"])
        fac = jax.vmap(jlqr.lqr_factorize)(dyn, cost)
        z, c = jax.vmap(jlqr.lqr_affine_solve)(dyn, fac, a["q"], a["r"],
                                               a["z0"])
        zs, cs = jax.vmap(jlqr.lqr_solve)(dyn, cost, a["z0"])
    t = {k: torch.tensor(v) for k, v in pb.items()}
    tdyn = tlqr.LQRDynamics(t["F"], t["G"], t["d"])
    tcost = tlqr.LQRCost(t["Q"], t["q"], t["R"], t["r"], t["S"])
    tfac = tlqr.lqr_factorize(tdyn, tcost)
    for f in tlqr.LQRFactors._fields:
        close(getattr(tfac, f), getattr(fac, f), 1e-8)
    tz, tc = tlqr.lqr_affine_solve(tdyn, tfac, t["q"], t["r"], t["z0"])
    close(tz, z, 1e-8)
    close(tc, c, 1e-8)
    tzs, tcs = tlqr.lqr_solve(tdyn, tcost, t["z0"])
    close(tzs, zs, 1e-8)
    close(tcs, cs, 1e-8)
    with x64_island():
        za, ca = jax.vmap(lambda d_, c_, z0: jlqr.lqr_solve(
            d_, c_, z0, assoc=True))(dyn, cost, a["z0"])
    tza, tca = tlqr.lqr_solve(tdyn, tcost, t["z0"], assoc=True)
    close(tza, za, 1e-8)
    close(tca, ca, 1e-8)


def test_plain_affine_twin_matches_pallas_interpret():
    """tests/test_ops.py:317 setup: B=4, N=10, nz=11 in float32."""
    rng = np.random.default_rng(11)
    B, N = 4, 10
    packs = []
    for _ in range(B):
        F, G, d, Q, R, S, q, r, z0 = random_problem(rng, N=N, nz=11, nc=2)
        f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
        dyn = jlqr.LQRDynamics(f32(F), f32(G), f32(d))
        fac = jlqr.lqr_factorize(dyn, jlqr.LQRCost(f32(Q), f32(q), f32(R),
                                                   f32(r), f32(S)))
        L = np.asarray(fac.Quu_chol)
        Quu_inv = np.stack([np.linalg.inv(L[k] @ L[k].T) for k in range(N)])
        packs.append((F, G, d, np.asarray(fac.K), Quu_inv,
                      np.asarray(fac.Qxu), np.asarray(fac.m), q, r, z0))
    arrays = [np.stack([p[i] for p in packs]).astype(np.float32)
              for i in range(10)]
    z, c = j_affine(*[jnp.asarray(a) for a in arrays], interpret=True)
    before = cuda_lqr.lqr_affine_solve_batched.launches
    tz, tc = cuda_lqr.lqr_affine_solve_batched(
        *[torch.tensor(a) for a in arrays])
    close(tz, z, 5e-5)
    close(tc, c, 5e-5)
    # CPU tensors take the plain twin: no kernel launch is counted
    assert cuda_lqr.lqr_affine_solve_batched.launches == before
    pz, pc = cuda_lqr.lqr_affine_solve_batched_plain(
        *[torch.tensor(a) for a in arrays])
    assert torch.equal(pz, tz) and torch.equal(pc, tc)


def _epoch_batch(seed=23, B=4, N=10, nz=5, nc=2, m=3):
    rng = np.random.default_rng(seed)
    probs, w0s, y0s = [], [], []
    for _ in range(B):
        p = constrained_problem(rng, N=N, nz=nz, nc=nc, m=m)
        probs.append(p)
        w0s.append(np.clip(rng.normal(size=(N, m)) * 0.1, p["lo"], p["hi"]))
        y0s.append(rng.normal(size=(N, m)) * 0.05)
    return stack(probs), np.stack(w0s), np.stack(y0s)


def test_epoch_inputs_match_jax():
    """``admm_epoch_inputs`` in float64, with per-problem rho multipliers,
    one-sided rows and unbounded rows."""
    pb, _, _ = _epoch_batch(seed=24)
    pb["hi"][:, :, 1] = np.inf
    pb["lo"][:, 2, 2] = -np.inf
    pb["hi"][:, 2, 2] = np.inf
    scale = np.random.default_rng(1).uniform(0.5, 2.0, size=(4, 3))
    with x64_island():
        ref = jax.vmap(lambda qp, s: jadmm.admm_epoch_inputs(
            qp, rho=7.0, rho_scale=s))(jax_qp(pb, jnp.float64),
                                      jnp.asarray(scale))
        ref_cost = jax.vmap(lambda qp: jadmm.build_admm_cost(qp, 3.0))(
            jax_qp(pb, jnp.float64))
    got = tadmm.admm_epoch_inputs(port_qp(pb, F64), rho=7.0,
                                  rho_scale=torch.tensor(scale))
    for f in tadmm.ADMMEpochData._fields:
        close(getattr(got, f), getattr(ref, f), 1e-8)
    cost = tadmm.build_admm_cost(port_qp(pb, F64), 3.0)
    for f in tlqr.LQRCost._fields:
        close(getattr(cost, f), getattr(ref_cost, f), 1e-8)
    back = interop.epoch_data_from_numpy(interop.epoch_data_to_numpy(got),
                                         dtype=F64, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, got))


def test_plain_epoch_twin_matches_pallas_interpret():
    """tests/test_ops.py:352 setup: B=4, N=10, nz=5, m=3, epoch_len=25,
    rho=10, alpha=1.6 in float32; the epoch data is carried across."""
    EL, RHO, ALPHA = 25, 10.0, 1.6
    pb, w0, y0 = _epoch_batch()
    data = jax.vmap(lambda qp: jadmm.admm_epoch_inputs(qp, rho=RHO))(
        jax_qp(pb, jnp.float32))
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    ref = j_epoch(data, f32(pb["z0"]), f32(w0), f32(y0), epoch_len=EL,
                  alpha=ALPHA, interpret=True)
    tdata = interop.epoch_data_from_numpy(data, dtype=F32, device="cpu")
    t32 = lambda a: torch.tensor(a, dtype=F32)  # noqa: E731
    before = cuda_lqr.admm_epoch_batched.launches
    got = cuda_lqr.admm_epoch_batched(tdata, t32(pb["z0"]), t32(w0),
                                      t32(y0), epoch_len=EL, alpha=ALPHA)
    assert cuda_lqr.admm_epoch_batched.launches == before
    for g, r in zip(got[:4], ref[:4]):
        close(g, r, 1e-3)
    for g, r in zip(got[4:], ref[4:]):
        close(g, r, 1e-4)


def test_wrappers_raise_on_a_device_without_kernel():
    """No fallback: a tensor that is neither on the CPU nor on a CUDA
    device is refused, not routed to the plain twin."""
    pb, w0, y0 = _epoch_batch(B=2)
    data = tadmm.admm_epoch_inputs(port_qp(pb, F32))
    meta = lambda t: t.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cuda_lqr.admm_epoch_batched(
            tadmm.ADMMEpochData(*map(meta, data)),
            meta(torch.zeros(2, 5)), meta(torch.tensor(w0, dtype=F32)),
            meta(torch.tensor(y0, dtype=F32)), epoch_len=5)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cuda_lqr.lqr_affine_solve_batched(
            *map(meta, (data.F, data.G, data.d, data.K, data.Quu_inv,
                        data.Qxu, data.m, data.q, data.r)),
            meta(torch.zeros(2, 5)))


def test_admm_solve_matches_jax_across_epochs():
    """tests/test_ops.py:411 setup (iters=150, rho=5, eps=1e-6,
    epoch_len=25), batched over 3 problems against the vmapped JAX solve:
    solution and convergence certificate, not epoch counts (near-zero
    residuals make the adaptive-rho path float-noise-sensitive)."""
    rng = np.random.default_rng(31)
    pb = stack([constrained_problem(rng, N=8, nz=5, nc=2, m=3)
                for _ in range(3)])
    kw = dict(iters=150, rho=5.0, eps=1e-6, epoch_len=25)
    ref = jax.vmap(lambda qp, z0: jadmm.admm_solve(qp, z0, **kw))(
        jax_qp(pb, jnp.float32), jnp.asarray(pb["z0"], jnp.float32))
    got = tadmm.admm_solve(port_qp(pb, F32),
                           torch.tensor(pb["z0"], dtype=F32), **kw)
    close(got.z, ref.z, 1e-4)
    close(got.c, ref.c, 1e-4)
    assert bool((got.r_prim < 1e-6).all()) and bool(got.feasible.all())
    assert np.array_equal(got.feasible.numpy(), np.asarray(ref.feasible))


def test_admm_per_problem_freeze():
    """A batch mixing a problem that converges in its first epoch (all rows
    unbounded: zero residuals) with a hard one gives each the result and
    iteration count of its standalone solve, as the JAX while_loop under
    vmap does."""
    rng = np.random.default_rng(41)
    hard = constrained_problem(rng, N=8, nz=5, nc=2, m=3)
    easy = constrained_problem(rng, N=8, nz=5, nc=2, m=3)
    easy["lo"][:] = -np.inf
    easy["hi"][:] = np.inf
    pb = stack([easy, hard])
    kw = dict(iters=150, rho=5.0, eps=1e-6, epoch_len=25)
    z0 = torch.tensor(pb["z0"])
    both = tadmm.admm_solve(port_qp(pb, F64), z0, **kw)
    for i, prob in enumerate((easy, hard)):
        alone = tadmm.admm_solve(port_qp(stack([prob]), F64), z0[i:i + 1],
                                 **kw)
        for f in ("z", "c", "w", "y", "rho_scale", "r_prim", "r_dual"):
            close(getattr(both, f)[i], getattr(alone, f)[0], 1e-12)
        assert int(both.iterations[i]) == int(alone.iterations[0])
    assert int(both.iterations[0]) == 25 < int(both.iterations[1])
    with x64_island():
        ref = jax.vmap(lambda qp, z: jadmm.admm_solve(qp, z, **kw))(
            jax_qp(pb, jnp.float64), jnp.asarray(pb["z0"]))
    np.testing.assert_array_equal(both.iterations.numpy(),
                                  np.asarray(ref.iterations))
    close(both.z, ref.z, 1e-8)
