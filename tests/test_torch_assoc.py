"""Parity of the PyTorch port's associative (parallel-in-horizon) path
with the JAX package: the blocked affine scan, the associative affine LQR
solve, ``admm_solve(assoc=True)`` and its epoch, and ``scale_stage_qp``.

Seeded numpy problems go through the JAX functions (vmapped, float64
inside ``x64_island``) and the port's batched ones on the CPU. Tolerances:
1e-9 in float64 for the scan and the affine solves (the tree of
``lax.associative_scan`` and the port's log-step products round
differently, ~1e-12); 1e-8 for the ADMM solves, whose adaptive rho
amplifies that rounding, with equal iteration counts; 1e-3 in float32,
relative to the solution's scale, for the N=125 horizon held against the
port's own sequential solve (block 8, the conditioning rule of JAX
``ops/lqr.py:150-163``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colaborativempc_tpu.ops import admm as jadmm
from colaborativempc_tpu.ops import lqr as jlqr
from colaborativempc_tpu.utils.precision import x64_island

from test_ops import random_problem
from test_torch_ops import constrained_problem, jax_qp, port_qp, stack

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


def sequential(M, b, x0, reverse):
    """The recurrence written out, numpy float64."""
    N = M.shape[1]
    xs = [x0]
    ks = range(N - 1, -1, -1) if reverse else range(N)
    for k in ks:
        xs.append(np.einsum("pij,pj->pi", M[:, k], xs[-1]) + b[:, k])
    out = np.stack(xs, 1)
    return out[:, ::-1] if reverse else out


@pytest.mark.parametrize("N,reverse,block", [
    (16, False, 8), (13, False, 8), (16, True, 8), (13, True, 8),
    (13, False, None), (13, True, 3)])
def test_affine_scan_matches_jax(N, reverse, block):
    """Forward and reverse, N a multiple of the block and not (identity
    padding), full-span and odd blocks."""
    rng = np.random.default_rng(N + 10 * reverse)
    P, n = 3, 5
    M = np.eye(n) + 0.15 * rng.normal(size=(P, N, n, n))
    b = rng.normal(size=(P, N, n))
    x0 = rng.normal(size=(P, n))
    with x64_island():
        ref = jax.jit(jax.vmap(lambda M, b, x: jlqr._affine_scan(
            M, b, x, reverse=reverse, block=block)))(
            *(jnp.asarray(a) for a in (M, b, x0)))
    got = tlqr._affine_scan(*(torch.tensor(a) for a in (M, b, x0)),
                            reverse=reverse, block=block)
    assert tuple(got.shape) == (P, N + 1, n)
    close(got, ref, 1e-9)
    close(got, sequential(M, b, x0, reverse), 1e-9)


def lqr_batch(seed, N, P=3, nz=11, nc=2):
    rng = np.random.default_rng(seed)
    return stack([dict(zip("F G d Q R S q r z0".split(),
                           random_problem(rng, N=N, nz=nz, nc=nc)))
                  for _ in range(P)])


def port_lqr(pb, dtype):
    t = {k: torch.tensor(v, dtype=dtype) for k, v in pb.items()}
    return (tlqr.LQRDynamics(t["F"], t["G"], t["d"]),
            tlqr.LQRCost(t["Q"], t["q"], t["R"], t["r"], t["S"]), t["z0"])


@pytest.mark.parametrize("N", [9, 24])
def test_lqr_affine_solve_assoc_matches_jax_and_sequential(N):
    pb = lqr_batch(N, N)
    with x64_island():
        a = {k: jnp.asarray(v) for k, v in pb.items()}
        dyn = jlqr.LQRDynamics(a["F"], a["G"], a["d"])
        cost = jlqr.LQRCost(a["Q"], a["q"], a["R"], a["r"], a["S"])
        fac = jax.jit(jax.vmap(jlqr.lqr_factorize))(dyn, cost)
        z, c = jax.jit(jax.vmap(jlqr.lqr_affine_solve_assoc))(
            dyn, fac, a["q"], a["r"], a["z0"])
        zs, cs = jax.jit(jax.vmap(lambda d_, c_, z0: jlqr.lqr_solve(
            d_, c_, z0, assoc=True)))(dyn, cost, a["z0"])
    tdyn, tcost, z0 = port_lqr(pb, F64)
    tfac = tlqr.lqr_factorize(tdyn, tcost)
    tz, tc = tlqr.lqr_affine_solve_assoc(tdyn, tfac, tcost.q, tcost.r, z0)
    close(tz, z, 1e-9)
    close(tc, c, 1e-9)
    sz, sc = tlqr.lqr_affine_solve(tdyn, tfac, tcost.q, tcost.r, z0)
    close(tz, sz, 1e-9)
    close(tc, sc, 1e-9)
    tzs, tcs = tlqr.lqr_solve(tdyn, tcost, z0, assoc=True)
    close(tzs, zs, 1e-9)
    close(tcs, cs, 1e-9)


def test_assoc_float32_at_n125_holds_to_the_sequential_solve():
    """N=125 in float32 with a stiff rho-augmented cost (rho 1e4 on every
    state row): the blocked associative solve stays within 1e-3 of the
    port's sequential solve and of JAX's float32 associative solve,
    relative to the solution's scale."""
    N = 125
    pb = lqr_batch(125, N, P=2)
    pb["Q"] = pb["Q"] + 1e4 * np.eye(11)
    tdyn, tcost, z0 = port_lqr(pb, F32)
    fac = tlqr.lqr_factorize(tdyn, tcost)
    z, c = tlqr.lqr_affine_solve_assoc(tdyn, fac, tcost.q, tcost.r, z0)
    sz, sc = tlqr.lqr_affine_solve(tdyn, fac, tcost.q, tcost.r, z0)
    a = {k: jnp.asarray(v, jnp.float32) for k, v in pb.items()}
    dyn = jlqr.LQRDynamics(a["F"], a["G"], a["d"])
    jfac = jax.jit(jax.vmap(jlqr.lqr_factorize))(
        dyn, jlqr.LQRCost(a["Q"], a["q"], a["R"], a["r"], a["S"]))
    jz, jc = jax.jit(jax.vmap(jlqr.lqr_affine_solve_assoc))(
        dyn, jfac, a["q"], a["r"], a["z0"])
    for got, ref in ((z, sz), (c, sc), (z, jz), (c, jc)):
        scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
        close(got / scale, np.asarray(ref) / scale, 1e-3)
    assert bool(torch.isfinite(z).all())


@pytest.mark.parametrize("N", [12, 16])
def test_admm_solve_assoc_matches_jax(N):
    """``admm_solve(assoc=True)`` on CPU tensors runs the associative epoch
    (the JAX XLA epoch): float64 solutions within 1e-8 with equal
    iteration counts, per-row-class rho and feasibility; float32 within
    1e-3."""
    rng = np.random.default_rng(50 + N)
    pb = stack([constrained_problem(rng, N=N, nz=5, nc=2, m=3)
                for _ in range(3)])
    kw = dict(iters=150, rho=5.0, eps=1e-6, epoch_len=15, assoc=True)
    with x64_island():
        ref = jax.vmap(lambda qp, z0: jadmm.admm_solve(qp, z0, **kw))(
            jax_qp(pb, jnp.float64), jnp.asarray(pb["z0"]))
    before = cuda_lqr.admm_epoch_batched.launches
    got = tadmm.admm_solve(port_qp(pb, F64), torch.tensor(pb["z0"]), **kw)
    assert cuda_lqr.admm_epoch_batched.launches == before
    for f in ("z", "c", "w", "y"):
        close(getattr(got, f), getattr(ref, f), 1e-8)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.feasible.numpy(),
                                  np.asarray(ref.feasible))
    np.testing.assert_allclose(got.rho_scale.numpy(),
                               np.asarray(ref.rho_scale), rtol=1e-8)
    ref32 = jax.vmap(lambda qp, z0: jadmm.admm_solve(qp, z0, **kw))(
        jax_qp(pb, jnp.float32), jnp.asarray(pb["z0"], jnp.float32))
    got32 = tadmm.admm_solve(port_qp(pb, F32),
                             torch.tensor(pb["z0"], dtype=F32), **kw)
    close(got32.z, ref32.z, 1e-3)
    close(got32.c, ref32.c, 1e-3)


def test_assoc_epoch_equals_the_plain_epoch():
    """One associative epoch and one epoch of the kernel's plain twin from
    the same warm start agree to rounding in float64: the two affine
    solves differ only in association and in Cholesky vs explicit inverse."""
    rng = np.random.default_rng(61)
    pb = stack([constrained_problem(rng, N=13, nz=5, nc=2, m=3)
                for _ in range(2)])
    qp = port_qp(pb, F64)
    z0 = torch.tensor(pb["z0"])
    w0 = torch.clamp(torch.tensor(rng.normal(size=qp.lo.shape) * 0.1),
                     qp.lo, qp.hi)
    y0 = torch.tensor(rng.normal(size=qp.lo.shape) * 0.05)
    scale = torch.tensor(rng.uniform(0.5, 2.0, size=(2, 3)))
    a = tadmm.admm_epoch_assoc(qp, z0, w0, y0, 7.0, scale, epoch_len=9)
    b = cuda_lqr.admm_epoch_batched_plain(
        tadmm.admm_epoch_inputs(qp, 7.0, scale), z0, w0, y0, epoch_len=9)
    for x, y in zip(a, b):
        close(x, y, 1e-9)


def test_scale_stage_qp_matches_jax_and_keeps_the_solution():
    """The change of variables equals JAX's in float64; the scaled QP's
    solution, de-normalised, is the unscaled one, and its constraint
    values (the ADMM splitting space) are unchanged."""
    rng = np.random.default_rng(71)
    pb = stack([constrained_problem(rng, N=8, nz=5, nc=2, m=3)
                for _ in range(2)])
    tz = rng.uniform(0.2, 5.0, size=5)
    tc = rng.uniform(0.2, 5.0, size=2)
    with x64_island():
        ref = jax.vmap(lambda qp: jadmm.scale_stage_qp(
            qp, jnp.asarray(tz), jnp.asarray(tc)))(jax_qp(pb, jnp.float64))
    qp = port_qp(pb, F64)
    got = tadmm.scale_stage_qp(qp, torch.tensor(tz), torch.tensor(tc))
    for part in ("dyn", "cost"):
        for f, v in getattr(got, part)._asdict().items():
            np.testing.assert_allclose(
                v.numpy(), np.asarray(getattr(getattr(ref, part), f)),
                rtol=1e-13, atol=0)
    for f in ("D", "E", "lo", "hi", "soft_lo", "soft_hi"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-13)
    per_problem = tadmm.scale_stage_qp(
        qp, torch.tensor(np.stack([tz, tz])), torch.tensor(np.stack([tc, tc])))
    for x, y in zip(per_problem.dyn + per_problem.cost,
                    got.dyn + got.cost):
        assert torch.equal(x, y)
    z0 = torch.tensor(pb["z0"])
    kw = dict(iters=400, rho=5.0, eps=1e-9, epoch_len=25)
    raw = tadmm.admm_solve(qp, z0, **kw)
    scl = tadmm.admm_solve(got, z0 / torch.tensor(tz), **kw)
    close(scl.z * torch.tensor(tz), raw.z, 1e-6)
    close(scl.c * torch.tensor(tc), raw.c, 1e-6)
