"""CPU tests of the CUDA kernels' Python side and of their algebra.

- The port's entry points default to the card and raise without one.
- ``ops/cuda_lqr.py kernel_plan``: QPs per block, ring depth and
  shared-memory bytes at the shapes the planners hand the kernels.
- The closed-loop form of the sweeps (``A_cl = F + G K``,
  ``D_cl = D + E K``, the feedforward off the chain: one matvec per chain
  step), written here in float64 numpy, against the plain twins
  ``admm_epoch_batched_plain`` and ``lqr_affine_solve_batched_plain``
  within 1e-10, on random QPs with ``hi = +inf`` rows, hard rows
  (``fac = 0``) and unbounded rows (``rv = 0``). The form is exact; the
  kernels keep the explicit form all the same, because in float32 the
  closed-loop form moves rounding enough to take the NL hp_opt /
  Gauss-Seidel check of ``chip_smoke.py`` out of its tolerance (PERF.md).
"""

import inspect

import numpy as np
import pytest
import torch

from colaborativempc_tpu_torch import config as tcfg
from colaborativempc_tpu_torch.ops import (
    LQRCost, LQRDynamics, StageQP, admm_epoch_inputs, cuda_lqr,
)
from colaborativempc_tpu_torch.ops.cuda_lqr import (
    SMEM_PER_BLOCK, kernel_plan, qp_floats,
)
from colaborativempc_tpu_torch.runtime import battery, ocd, simulate
from colaborativempc_tpu_torch.scripts import monte_carlo, nl_main

F64 = torch.float64


# --- entry points default to the card ------------------------------------

def _cfg(gains):
    return tcfg.ExperimentConfig(n_agents=2, N=6, max_it=1, gains=gains)


ENTRY_POINTS = {
    "run_lpv_experiment": (simulate.run_lpv_experiment,
                           lambda: (_cfg(tcfg.lpv_gains()),), {}),
    "run_nl_experiment": (ocd.run_nl_experiment,
                          lambda: (_cfg(tcfg.nl_gains()),), {}),
    "run_lpv_battery": (battery.run_lpv_battery,
                        lambda: (_cfg(tcfg.lpv_gains()),
                                 [tcfg.lpv_gains()], 1), {}),
    "run_nl_battery": (battery.run_nl_battery,
                       lambda: (_cfg(tcfg.nl_gains()),
                                [tcfg.nl_gains()], 1), {}),
    "monte_carlo.setup": (monte_carlo.setup, lambda: ("nl",),
                          dict(scenarios=2, agents=2, N=6, steps=1)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_cuda_and_raises_without_a_card(
        name, monkeypatch):
    fn, args, kw = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(*args(), **kw)


@pytest.mark.parametrize("script,argv", [
    (monte_carlo, ["--pipeline", "nl", "--scenarios", "2", "--agents", "2",
                   "--N", "6", "--steps", "1"]),
    (nl_main, ["--agents", "2", "--N", "6", "--steps", "1", "--verb", "0"]),
])
def test_script_main_defaults_to_cuda_and_raises_without_a_card(
        script, argv, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if script is nl_main:
        argv = argv + ["--out", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main(argv)
    assert not (tmp_path / "out").exists()


# --- launch plans -----------------------------------------------------------

# (P, N, nz, nc, mr): the LPV headline epoch, the NL B=64 Monte-Carlo, the
# hp_opt rows, the long horizon, one QP, a batch that is no multiple of
# the QPs per block, the affine solve (mr = 0), and hp_opt at N=125, whose
# horizon does not fit in a block.
PLAN_SHAPES = {
    "lpv_headline": (768, 20, 11, 2, 6),
    "nl_b64": (192, 20, 11, 2, 6),
    "hp_opt": (768, 20, 11, 6, 10),
    "n125": (768, 125, 11, 2, 6),
    "p1": (1, 20, 11, 2, 6),
    "p7": (7, 20, 11, 2, 6),
    "affine_n125": (768, 125, 11, 2, 0),
    "hp_opt_n125": (768, 125, 11, 6, 10),
}


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_kernel_plan_fits_and_keeps_the_horizon_resident_when_it_can(name):
    """Under 227 KB per block; the ring equal to N where every QP's horizon
    fits on the card at once (one wave), else a ring shorter than N that
    needs no more waves than the resident horizon would."""
    P, N, nz, nc, mr = PLAN_SHAPES[name]
    plan = kernel_plan(P, N, nz, nc, mr)
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan.smem_bytes == (plan.qps_per_block * 4
                               * qp_floats(N, plan.ring, nz, nc, mr))
    assert 1 <= plan.qps_per_block <= 4 and plan.waves >= 1
    if 4 * qp_floats(N, N, nz, nc, mr) > SMEM_PER_BLOCK:
        assert plan.ring < N
    else:
        resident = kernel_plan(P, N, nz, nc, mr, ring=N)
        assert (plan.ring == N) == (resident.waves == 1)
        assert plan.waves <= resident.waves
    if name in ("lpv_headline", "nl_b64", "p1", "p7"):
        assert plan.ring == N and plan.waves == 1
    if name in ("n125", "affine_n125", "hp_opt_n125"):
        assert plan.ring < N and plan.waves == 1


def test_kernel_plan_pins_a_ring_and_a_ragged_block():
    """A pinned ring shorter than N streams in two slots; 4 QPs per block
    at P=7 leave the second block one warp short."""
    full = kernel_plan(768, 125, 11, 2, 6, ring=125)
    ring = kernel_plan(768, 125, 11, 2, 6, ring=8)
    assert full.ring == 125 and full.waves > 1 and ring.ring == 8
    assert ring.smem_bytes == ring.qps_per_block * 4 * qp_floats(
        125, 8, 11, 2, 6)
    rag = kernel_plan(7, 20, 11, 2, 6, qps_per_block=4)
    assert rag.qps_per_block == 4 and 7 % rag.qps_per_block != 0
    with pytest.raises(ValueError, match="no launch plan fits"):
        kernel_plan(4, 1000, 11, 2, 6, ring=1000)


# --- the closed-loop algebra in float64 --------------------------------------

def random_qps(seed, P, N, nz=11, nc=2, mr=6):
    """P stage QPs banded around a feasible rollout, float64: row 0 soft,
    row 1 one-sided (hi = +inf), row 2 unbounded (rv = 0), the rest hard
    (fac = 0)."""
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
    t = lambda a: torch.tensor(a, dtype=F64)  # noqa: E731
    qp = StageQP(
        dyn=LQRDynamics(t(F), t(G), t(d)),
        cost=LQRCost(t(0.1 * A @ np.swapaxes(A, -1, -2) + np.eye(nz)),
                     t(0.5 * rng.normal(size=(P, N + 1, nz))),
                     t(0.1 * Rm @ np.swapaxes(Rm, -1, -2) + np.eye(nc)),
                     t(0.5 * rng.normal(size=(P, N, nc))),
                     t(0.05 * rng.normal(size=(P, N, nz, nc)))),
        D=t(D), E=t(E), lo=t(lo), hi=t(hi), soft_lo=t(soft), soft_hi=t(soft))
    w0 = np.clip(0.1 * rng.normal(size=vt.shape), lo, hi)
    y0 = 0.05 * rng.normal(size=vt.shape)
    return qp, t(z0), t(w0), t(y0)


def _mv(A, x):
    return np.einsum("...ij,...j->...i", A, x)


def _mtv(A, x):
    return np.einsum("...ji,...j->...i", A, x)


def closed_loop(data, z0, w0, y0, epoch_len, alpha, rows=True):
    """The closed-loop sweeps, in float64 numpy: the chain of each sweep is
    one matvec with A_cl (or A_cl'); the feedforward kff, the affine terms
    and the rows are computed off it."""
    f = {k: v.numpy() for k, v in data._asdict().items()}
    F, G, K, Qi, E = f["F"], f["G"], f["K"], f["Quu_inv"], f["E"]
    N = F.shape[1]
    Acl = F + G @ K
    Dcl = f["D"] + E @ K
    cst = f["q"][:, :N] + _mtv(K, f["r"]) + _mtv(Acl, f["m"])
    rr = f["r"] + _mtv(G, f["m"])
    z0 = z0.numpy()
    if rows:
        w, y = w0.numpy(), y0.numpy()
        mask = (f["rv"] > 0).astype(float)
    for _ in range(epoch_len):
        t = f["rv"] * (y - w) if rows else None
        g = cst + _mtv(Dcl, t) if rows else cst
        p = f["q"][:, N]
        ps = [None] * (N + 1)
        ps[N] = p
        for k in range(N - 1, -1, -1):
            p = _mtv(Acl[:, k], p) + g[:, k]
            ps[k] = p
        pnext = np.stack(ps[1:], 1)
        qu = rr + _mtv(G, pnext)
        kff = -_mv(Qi, qu + _mtv(E, t) if rows else qu)
        e = f["d"] + _mv(G, kff)
        z = z0
        zs = [z]
        for k in range(N):
            z = _mv(Acl[:, k], z) + e[:, k]
            zs.append(z)
        z = np.stack(zs, 1)
        c = _mv(K, z[:, :N]) + kff
        if not rows:
            return z, c
        v = _mv(Dcl, z[:, :N]) + _mv(E, kff)
        vhat = alpha * v + (1.0 - alpha) * w
        wbar = vhat + y
        with np.errstate(invalid="ignore"):
            wn = np.where(wbar > f["hi"],
                          f["hi"] + f["fac_hi"] * (wbar - f["hi"]), wbar)
            wn = np.where(wbar < f["lo"],
                          f["lo"] + f["fac_lo"] * (wbar - f["lo"]), wn)
        y = y + vhat - wn
        rp = np.max(np.abs(mask * (v - wn)), axis=1)
        rd = np.max(np.abs(mask * (wn - w)), axis=1)
        w = wn
    return z, c, w, y, rp, rd


@pytest.mark.parametrize("nc,mr,epoch_len", [(2, 6, 1), (2, 6, 7),
                                             (6, 10, 5)])
def test_closed_loop_epoch_matches_plain_twin_f64(nc, mr, epoch_len):
    qp, z0, w0, y0 = random_qps(10 + nc + epoch_len, P=4, N=9, nc=nc, mr=mr)
    data = admm_epoch_inputs(qp, rho=10.0, rho_scale=torch.tensor(
        np.linspace(0.5, 2.0, mr), dtype=F64))
    assert bool((data.rv == 0).any()) and bool(torch.isinf(data.hi).any())
    assert bool((data.fac_lo == 0).any())
    ref = cuda_lqr.admm_epoch_batched_plain(data, z0, w0, y0,
                                            epoch_len=epoch_len, alpha=1.6)
    got = closed_loop(data, z0, w0, y0, epoch_len, 1.6)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r.numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("nc,N", [(2, 9), (6, 13)])
def test_closed_loop_affine_matches_plain_twin_f64(nc, N):
    qp, z0, _, _ = random_qps(30 + N, P=3, N=N, nc=nc)
    d = admm_epoch_inputs(qp)
    ref = cuda_lqr.lqr_affine_solve_batched_plain(
        d.F, d.G, d.d, d.K, d.Quu_inv, d.Qxu, d.m, d.q, d.r, z0)
    got = closed_loop(d, z0, None, None, 1, 0.0, rows=False)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r.numpy(), rtol=0, atol=1e-10)
