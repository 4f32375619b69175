"""The ADMM epoch's fixed data, ``ops/admm.py admm_epoch_inputs``: on CPU
tensors its plain version (``admm_epoch_inputs_plain``) against the JAX
package's ``admm_epoch_inputs``, a ``Quu`` that is not positive definite
on both packages, the CUDA kernel's (``csrc/epoch_data.cu``, ``ops/cuda_lqr.py
epoch_data_batched``) order of operations emulated entry by entry in
torch float32 against the plain version, its byte and operation count,
and the dispatch by device. The kernel's launch plan is held by
tests/test_torch_kernel_plan.py, the kernel against the plain version on a
card by tests/test_torch_cuda.py.

Tolerances: float64 parity with JAX within 1e-8, as tests/test_torch_ops.py
holds ``admm_epoch_inputs`` (the same formulas; rounding only); the
emulated kernel within 1e-5 of each field's scale of the plain version on
the CPU (float32, two orders of summation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colaborativempc_tpu.ops import admm as jadmm
from colaborativempc_tpu.ops import lqr as jlqr
from colaborativempc_tpu.utils.precision import x64_island

from colaborativempc_tpu_torch.ops import admm as tadmm
from colaborativempc_tpu_torch.ops import cuda_lqr
from colaborativempc_tpu_torch.ops import lqr as tlqr

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)

F64 = torch.float64


def random_qps(seed, P, N, nz, nc, mr):
    """P stage QPs as float64 numpy arrays, rows banded around a rollout:
    row 0 soft on both sides (weight 50), row 1 one-sided (hi = +inf, soft
    below, weight 20), row 2 unbounded (inactive), the rest hard."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(P, N + 1, nz, nz))
    Rm = rng.normal(size=(P, N, nc, nc))
    p = dict(F=np.eye(nz) + 0.05 * rng.normal(size=(P, N, nz, nz)),
             G=0.2 * rng.normal(size=(P, N, nz, nc)),
             d=0.01 * rng.normal(size=(P, N, nz)),
             Q=0.1 * A @ np.swapaxes(A, -1, -2) + np.eye(nz),
             q=0.5 * rng.normal(size=(P, N + 1, nz)),
             R=0.1 * Rm @ np.swapaxes(Rm, -1, -2) + np.eye(nc),
             r=0.5 * rng.normal(size=(P, N, nc)),
             S=0.05 * rng.normal(size=(P, N, nz, nc)),
             D=0.5 * rng.normal(size=(P, N, mr, nz)),
             E=0.5 * rng.normal(size=(P, N, mr, nc)))
    mid = rng.normal(size=(P, N, mr))
    p["lo"] = mid - rng.uniform(0.05, 0.5, size=mid.shape)
    p["hi"] = mid + rng.uniform(0.05, 0.5, size=mid.shape)
    p["hi"][:, :, 1] = np.inf
    p["lo"][:, :, 2], p["hi"][:, :, 2] = -np.inf, np.inf
    p["soft_lo"] = np.full(mid.shape, np.inf)
    p["soft_hi"] = np.full(mid.shape, np.inf)
    p["soft_lo"][:, :, :2] = (50.0, 20.0)
    p["soft_hi"][:, :, 0] = 50.0
    p["rho_scale"] = rng.uniform(0.5, 2.0, size=(P, mr))
    return p


def jax_qp(p, soft=True):
    a = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
    return jadmm.StageQP(
        dyn=jlqr.LQRDynamics(a(p["F"]), a(p["G"]), a(p["d"])),
        cost=jlqr.LQRCost(a(p["Q"]), a(p["q"]), a(p["R"]), a(p["r"]),
                          a(p["S"])),
        D=a(p["D"]), E=a(p["E"]), lo=a(p["lo"]), hi=a(p["hi"]),
        soft_lo=a(p["soft_lo"]) if soft else None,
        soft_hi=a(p["soft_hi"]) if soft else None)


def port_qp(p, soft=True, dtype=F64):
    t = lambda x: torch.tensor(x, dtype=dtype)  # noqa: E731
    return tadmm.StageQP(
        dyn=tlqr.LQRDynamics(t(p["F"]), t(p["G"]), t(p["d"])),
        cost=tlqr.LQRCost(t(p["Q"]), t(p["q"]), t(p["R"]), t(p["r"]),
                          t(p["S"])),
        D=t(p["D"]), E=t(p["E"]), lo=t(p["lo"]), hi=t(p["hi"]),
        soft_lo=t(p["soft_lo"]) if soft else None,
        soft_hi=t(p["soft_hi"]) if soft else None)


def jax_epoch_inputs(p, rho, scale, soft=True):
    """The vmapped JAX ``admm_epoch_inputs`` in float64; ``scale``:
    "per_problem" (P, mr), "per_row" (mr,) or "scalar"."""
    with x64_island():
        qp = jax_qp(p, soft)
        if scale == "per_problem":
            return jax.vmap(lambda q, s: jadmm.admm_epoch_inputs(
                q, rho=rho, rho_scale=s))(qp, jnp.asarray(p["rho_scale"]))
        s = p["rho_scale"][0] if scale == "per_row" else 1.7
        return jax.vmap(lambda q: jadmm.admm_epoch_inputs(
            q, rho=rho, rho_scale=jnp.asarray(s)))(qp)


def port_scale(p, scale):
    if scale == "per_problem":
        return torch.tensor(p["rho_scale"])
    return torch.tensor(p["rho_scale"][0]) if scale == "per_row" else 1.7


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol)


# (P, N, nz, nc, mr, rho_scale, soft weights): the LPV and NL eu QP
# (nc=2, mr=6), NL hp_opt (nc=6, mr=10), MPCC (mr=7), the long horizon,
# and rho_scale as one row vector or a scalar, hard rows only.
SHAPES = {
    "lpv_nc2_mr6": (3, 9, 11, 2, 6, "per_problem", True),
    "hp_opt_nc6_mr10": (2, 7, 11, 6, 10, "per_problem", True),
    "mpcc_mr7": (2, 8, 11, 2, 7, "per_problem", True),
    "n125": (2, 125, 11, 2, 6, "per_problem", True),
    "rho_scale_per_row": (2, 6, 11, 2, 6, "per_row", True),
    "rho_scale_scalar_hard_rows": (2, 6, 11, 2, 6, "scalar", False),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_epoch_inputs_match_jax(name):
    """Every field of ``ADMMEpochData`` from the plain version against JAX
    in float64, with unbounded rows (rv = 0, masked D and E), one-sided
    rows (hi = +inf) and soft rows on either side."""
    P, N, nz, nc, mr, scale, soft = SHAPES[name]
    p = random_qps(100 + N + nc + mr, P, N, nz, nc, mr)
    ref = jax_epoch_inputs(p, 7.0, scale, soft)
    before = cuda_lqr.epoch_data_batched.launches
    got = tadmm.admm_epoch_inputs(port_qp(p, soft), rho=7.0,
                                  rho_scale=port_scale(p, scale))
    assert cuda_lqr.epoch_data_batched.launches == before
    assert bool((got.rv == 0).any()) and bool(torch.isinf(got.hi).any())
    assert bool((got.D[:, :, 2] == 0).all())
    assert bool((got.fac_lo[:, :, 0] > 0).all()) == soft
    for f in tadmm.ADMMEpochData._fields:
        g = getattr(got, f)
        assert g.is_contiguous() and g.dtype == F64
        close(g, getattr(ref, f), 1e-8)


@pytest.mark.parametrize("stage", [0, 3, 7])
def test_quu_not_positive_definite_gives_nan_on_both_packages(stage):
    """A stage whose rho-augmented ``Quu`` is not positive definite: JAX's
    ``cholesky`` returns NaN there, so that stage's K and Quu_inv and every
    earlier stage's K, Quu_inv, Qxu and m are NaN, the later stages finite.
    The plain version gives the same NaN at the same places (and the same
    values elsewhere); so does ``lqr_factorize``'s factor."""
    P, N, nz, nc, mr = 2, 8, 11, 2, 6
    p = random_qps(77, P, N, nz, nc, mr)
    p["R"][:, stage] = -100.0 * np.eye(nc)
    ref = jax_epoch_inputs(p, 7.0, "per_problem")
    got = tadmm.admm_epoch_inputs(port_qp(p), rho=7.0,
                                  rho_scale=port_scale(p, "per_problem"))
    for f in ("K", "Quu_inv"):
        r = np.asarray(getattr(ref, f))
        assert np.isnan(r[:, :stage + 1]).all()
        assert np.isfinite(r[:, stage + 1:]).all()
    for f in ("Qxu", "m"):
        r = np.asarray(getattr(ref, f))
        assert np.isnan(r[:, :stage]).all()
        assert np.isfinite(r[:, stage:]).all()
    for f in tadmm.ADMMEpochData._fields:
        close(getattr(got, f), getattr(ref, f), 1e-8)
    with x64_island():
        a = {k: jnp.asarray(v) for k, v in p.items()}
        jfac = jax.vmap(jlqr.lqr_factorize)(
            jlqr.LQRDynamics(a["F"], a["G"], a["d"]),
            jlqr.LQRCost(a["Q"], a["q"], a["R"], a["r"], a["S"]))
    t = {k: torch.tensor(v) for k, v in p.items()}
    tfac = tlqr.lqr_factorize(
        tlqr.LQRDynamics(t["F"], t["G"], t["d"]),
        tlqr.LQRCost(t["Q"], t["q"], t["R"], t["r"], t["S"]))
    L = np.asarray(jfac.Quu_chol)[:, stage]
    lower = np.tril_indices(nc)
    assert np.isnan(L[:, lower[0], lower[1]]).all()
    assert (np.triu(L, 1) == 0).all()
    close(tfac.Quu_chol, jfac.Quu_chol, 1e-8)


def test_traffic_counts_every_array_the_kernel_reads_and_writes():
    """``epoch_data_traffic``'s bytes are the float32 bytes of the arrays
    the kernel reads (the QP's F, G, d, Q, R, S, D, E, lo, hi, both soft
    weights, rho_scale) and writes (K, Quu_inv, Qxu, m, masked D and E,
    rv, fac_lo, fac_hi), counted here from a real QP and its epoch data;
    at the LPV headline the bound is set by bytes."""
    P, N, nz, nc, mr = 3, 5, 11, 2, 6
    p = random_qps(5, P, N, nz, nc, mr)
    qp = port_qp(p)
    data = tadmm.admm_epoch_inputs(qp)
    read = [qp.dyn.F, qp.dyn.G, qp.dyn.d, qp.cost.Q, qp.cost.R, qp.cost.S,
            qp.D, qp.E, qp.lo, qp.hi, qp.soft_lo, qp.soft_hi,
            torch.zeros(P, mr)]
    written = [data.K, data.Quu_inv, data.Qxu, data.m, data.D, data.E,
               data.rv, data.fac_lo, data.fac_hi]
    nbytes, flops = cuda_lqr.epoch_data_traffic(P, N, nz, nc, mr)
    assert nbytes == 4 * sum(t.numel() for t in read + written)
    assert flops > 0
    nbytes, flops = cuda_lqr.epoch_data_traffic(768, 20, 11, 2, 6)
    assert 30e6 < nbytes < 40e6
    assert nbytes / 3.35e12 > flops / 67e12


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    p = random_qps(9, 2, 6, 11, 2, 6)
    qp = port_qp(p, dtype=torch.float32)
    before = cuda_lqr.epoch_data_batched.launches
    got = tadmm.admm_epoch_inputs(qp, 10.0, torch.tensor(p["rho_scale"]))
    ref = tadmm.admm_epoch_inputs_plain(qp, 10.0,
                                        torch.tensor(p["rho_scale"]))
    assert cuda_lqr.epoch_data_batched.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("route", ["wrapper_on_cpu", "dispatch_on_meta"])
def test_no_fallback_to_the_plain_version(route):
    """The kernel's wrapper refuses CPU tensors, and ``admm_epoch_inputs``
    hands a tensor that is on neither the CPU nor a card to the wrapper,
    which refuses it: nothing routes a non-CPU tensor to the plain
    version."""
    qp = port_qp(random_qps(3, 2, 5, 11, 2, 6), dtype=torch.float32)
    before = cuda_lqr.epoch_data_batched.launches
    if route == "wrapper_on_cpu":
        with pytest.raises(ValueError, match="no kernel for device cpu"):
            cuda_lqr.epoch_data_batched(qp)
    else:
        meta = qp._replace(
            dyn=tlqr.LQRDynamics(*(t.to("meta") for t in qp.dyn)),
            cost=tlqr.LQRCost(*(t.to("meta") for t in qp.cost)),
            **{f: getattr(qp, f).to("meta")
               for f in ("D", "E", "lo", "hi", "soft_lo", "soft_hi")})
        with pytest.raises(ValueError, match="no kernel for device meta"):
            tadmm.admm_epoch_inputs(meta)
    assert cuda_lqr.epoch_data_batched.launches == before


# --- the kernel's order of operations --------------------------------------
# The order of the card's batched library routines that the plain version
# calls, which ``csrc/epoch_data.cu`` reproduces, emulated in torch with
# fused multiply-adds through float64 (exact but where a sum sits within
# 2^-29 of a float32 rounding boundary).

def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def kernel_mm(A, B):
    """``A @ B``: one fused multiply-add per term, in index order."""
    acc = torch.zeros(torch.broadcast_shapes(A[..., :1].shape,
                                             B[..., :1, :].shape),
                      device=A.device)
    for l in range(A.shape[-1]):
        acc = _fma(A[..., :, l, None], B[..., None, l, :], acc)
    return acc


def kernel_mv(A, x):
    """``A @ x``: the two halves [0, ceil(n/2)) and the rest, each as
    :func:`kernel_mm`, then their sum."""
    h = (A.shape[-1] + 1) // 2
    lo = kernel_mm(A[..., :h], x[..., :h, None])[..., 0]
    hi = kernel_mm(A[..., h:], x[..., h:, None])[..., 0]
    return lo + hi


def kernel_cholesky(A):
    """Column by column: ``L_jj = sqrt(a_jj - ...)``, ``L_ij = (a_ij - ...)
    * (1 / L_jj)``, the updates as fused multiply-adds."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        for i in range(j, n):
            v = A[..., i, j]
            for l in range(j):
                v = _fma(-L[..., i, l], L[..., j, l], v)
            L[..., i, j] = (torch.sqrt(v.double()).float() if i == j else
                            v * (1.0 / L[..., j, j].double()).float())
    return L


def kernel_solve(L, B):
    """``(L L')^-1 B``: forward with the terms in index order, back with
    them in reverse, each row times ``1 / L_ii``."""
    n = L.shape[-1]
    rcp = (1.0 / torch.diagonal(L, dim1=-2, dim2=-1).double()).float()
    x = list(B.unbind(-2))
    for i in range(n):
        for j in range(i):
            x[i] = _fma(-L[..., i, j, None], x[j], x[i])
        x[i] = x[i] * rcp[..., i, None]
    for i in range(n - 1, -1, -1):
        for j in range(n - 1, i, -1):
            x[i] = _fma(-L[..., j, i, None], x[j], x[i])
        x[i] = x[i] * rcp[..., i, None]
    return torch.stack(x, -2)


def kernel_emulated(qp, rho, rho_scale, reg):
    """The fields ``epoch_data_kernel`` computes, stage by stage with its
    formulas, each product, matrix-vector product, Cholesky factor and
    solve in its order (the emulations above)."""
    N, nz, nc = qp.dyn.F.shape[1], qp.dyn.F.shape[-1], qp.dyn.G.shape[-1]
    mask = (torch.isfinite(qp.lo) | torch.isfinite(qp.hi)).float()
    rv = (rho * mask) * rho_scale[:, None, :]
    safe = torch.where(rv > 0, rv, torch.ones_like(rv))
    soft = [torch.full_like(rv, torch.inf) if w is None else w
            for w in (qp.soft_lo, qp.soft_hi)]
    fac = [torch.where(torch.isinf(w), torch.zeros_like(rv),
                       safe / (safe + 2.0 * w)) for w in soft]
    Dm, Em = qp.D * mask[..., None], qp.E * mask[..., None]
    Dw, Ew = Dm * rv[..., None], Em * rv[..., None]
    eye = torch.eye(nc).expand(qp.lo.shape[0], nc, nc)
    P = qp.cost.Q[:, N]
    out = {f: [None] * N for f in ("K", "Quu_inv", "Qxu", "m")}
    for k in range(N - 1, -1, -1):
        F, G = qp.dyn.F[:, k], qp.dyn.G[:, k]
        FT, GT = F.transpose(-1, -2), G.transpose(-1, -2)
        PF, PG = kernel_mm(P, F), kernel_mm(P, G)
        out["m"][k] = kernel_mv(P, qp.dyn.d[:, k])
        Qxx = ((qp.cost.Q[:, k]
                + kernel_mm(Dw[:, k].transpose(-1, -2), Dm[:, k]))
               + kernel_mm(FT, PF))
        Qxu = ((qp.cost.S[:, k]
                + kernel_mm(Dw[:, k].transpose(-1, -2), Em[:, k]))
               + kernel_mm(FT, PG))
        Quu = ((qp.cost.R[:, k]
                + kernel_mm(Ew[:, k].transpose(-1, -2), Em[:, k]))
               + kernel_mm(GT, PG))
        L = kernel_cholesky(0.5 * (Quu + Quu.transpose(-1, -2))
                                + reg * eye)
        X = kernel_solve(L, torch.cat([Qxu.transpose(-1, -2), eye], -1))
        K = -X[..., :nz]
        out["K"][k], out["Quu_inv"][k], out["Qxu"][k] = K, X[..., nz:], Qxu
        M = Qxx + kernel_mm(Qxu, K)
        P = 0.5 * (M + M.transpose(-1, -2))
    out = {f: torch.stack(v, 1) for f, v in out.items()}
    out.update(D=Dm, E=Em, rv=rv, fac_lo=fac[0], fac_hi=fac[1])
    return out


@pytest.mark.parametrize("nc,mr,soft", [(2, 6, True), (6, 10, True),
                                        (2, 7, False)])
def test_kernel_order_of_operations_matches_the_plain_version(nc, mr, soft):
    """The epoch-data kernel's formulas, each routine in its order, against
    the plain version on the CPU (the CPU library's order): within 1e-5 of
    each field's scale, float32 rounding on these well-conditioned QPs.
    That holds the kernel's formulas on the CPU; the bits on the card are
    held by tests/test_torch_cuda.py and chip_smoke.py phase 3c."""
    p = random_qps(40 + nc + mr, 2, 3, 11, nc, mr)
    qp = port_qp(p, soft, torch.float32)
    scale = torch.tensor(p["rho_scale"], dtype=torch.float32)
    got = tadmm.admm_epoch_inputs(qp, 10.0, scale)
    for f, ref in kernel_emulated(qp, 10.0, scale, 1e-8).items():
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        close(getattr(got, f), ref, tol)


@pytest.mark.parametrize("n", [2, 6])
def test_library_order_emulations_compute_the_right_values(n):
    """The emulations of the card libraries' order (fused multiply-adds
    through float64) compute the right values: on the CPU each gives the
    library's values to float32 rounding (1e-5 of scale): the products,
    the matrix-vector product in two halves, the Cholesky factor, the
    solve."""
    g = torch.Generator().manual_seed(n)
    A, B = torch.randn(5, 11, 11, generator=g), torch.randn(5, 11, n,
                                                            generator=g)
    x = torch.randn(5, 11, generator=g)
    M = torch.randn(5, n, n, generator=g)
    S = M @ M.transpose(-1, -2) + n * torch.eye(n)
    L = torch.linalg.cholesky(S)
    pairs = ((kernel_mm(A, B), A @ B),
             (kernel_mv(A, x), (A @ x[..., None])[..., 0]),
             (kernel_cholesky(S), L),
             (kernel_solve(L, B.transpose(-1, -2)),
              torch.cholesky_solve(B.transpose(-1, -2), L)))
    for got, ref in pairs:
        scale = max(1.0, float(ref.abs().max()))
        close(got, ref, 1e-5 * scale)


# --- the clock-stamped build and scripts/epoch_data_split.py ----------------

def test_split_script_imports_here_and_raises_without_a_card():
    """The split script imports on the CPU, names the shapes it reads (the
    LPV headline, P=7, N=125 at 768 QPs and at one fleet's 3, NL hp_opt,
    MPCC P=1/N=60 and P=18/N=20, and NL hp_opt's 5, 8 and 9 agents at the
    Monte-Carlo's 64 fleets) and raises without a card, before it
    builds."""
    from colaborativempc_tpu_torch.scripts import epoch_data_split
    assert epoch_data_split.SHAPES == {
        "headline": (768, 20, 11, 2, 6), "p7": (7, 20, 11, 2, 6),
        "n125": (768, 125, 11, 2, 6), "n125_fleet": (3, 125, 11, 2, 6),
        "nl_hp_opt": (192, 20, 11, 6, 10),
        "mpcc_p1_n60": (1, 60, 11, 2, 7), "mpcc_p18_n20": (18, 20, 11, 2, 7),
        "hp_opt_5_agents": (320, 20, 11, 10, 16),
        "hp_opt_8_agents": (512, 20, 11, 16, 25),
        "hp_opt_9_agents": (576, 20, 11, 18, 28)}
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        epoch_data_split.main([])


def test_split_reads_each_interval_from_the_stamps():
    """An interval's cycles are the last warp's arrival at its barrier less
    the last warp's at the barrier before; the first stamp of a block is
    the reference; stamps never written (label -1) are dropped."""
    from colaborativempc_tpu_torch.scripts import epoch_data_split
    names = ["-", "one", "two", "three", "arrival"]
    labels = [4, 1, 2, 3, 1, 2, 3, -1]
    last = np.array([100, 130, 190, 290, 320, 380, 480, 0])
    stamps = np.zeros((2, len(labels), 3), np.int64)
    stamps[..., 0] = labels
    stamps[..., 2] = last
    stamps[..., 1] = last - np.array([0, 5, 10, 0, 5, 10, 0, 0])
    stamps[1, :, 1:] += 1000
    out = epoch_data_split.split(stamps, names, N=2)
    assert out["span_cycles"] == 380 and out["cycles_per_stage"] == 190
    iv = out["intervals"]
    assert set(iv) == {"one", "two", "three"}
    assert iv["one"]["mean_cycles"] == 30 and iv["two"]["mean_cycles"] == 60
    assert iv["three"]["mean_cycles"] == 100
    assert iv["three"]["max_cycles"] == 100
    assert iv["two"]["thread0_early_cycles"] == 10
    assert iv["one"]["count_per_block"] == 2
    assert iv["one"]["cycles_per_block"] == 60


def test_clocked_wrapper_refuses_cpu_tensors_before_building(monkeypatch):
    """``epoch_data_clocked`` checks the device before it asks for the
    clock-stamped library, and counts no launch of the main path's
    kernel."""
    from colaborativempc_tpu_torch.ops import _build

    def no_build(*a, **k):
        raise AssertionError("built the clocked library for CPU tensors")
    monkeypatch.setattr(_build, "load_epoch_data_clocks", no_build)
    qp = port_qp(random_qps(3, 2, 5, 11, 2, 6), dtype=torch.float32)
    before = cuda_lqr.epoch_data_batched.launches
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        cuda_lqr.epoch_data_clocked(qp)
    assert cuda_lqr.epoch_data_batched.launches == before
