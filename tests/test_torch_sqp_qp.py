"""The SQP stage-QP builds of the NL and MPCC planners (``csrc/sqp_qp.cu``
on the card, ``ops/cuda_sqp.py``) on the CPU.

The kernels run only on a card (``tests/test_torch_cuda.py`` holds them
against their plain versions there, ``chip_smoke.py`` phase 3d at the main
paths' shapes). Here: the plain versions ``build_nl_qp_plain`` and
``build_mpcc_qp_plain``, which the kernels reproduce on the card, against
the JAX package at the branch edges the kernels mirror (the NL velocity
gate at vx = 0.2, the MPCC slip floor at vx = 0.3 with its halved tangent
at the tie, a NaN in the linearisation point, every coupling, no trust
region, per-problem lanes); the forward-mode rules the MPCC kernel follows
(tangent by tangent, with torch.func's float64 tangents) against
torch.func itself, bit for bit; the dispatch by device with no launch on
the CPU and no fallback off it; the wrappers' checks; the packing of
gains, limits and lanes; the kernels' constants against the source; the
traffic counts behind the bound.

Tolerance against JAX: 1e-9 in float64 (the same formulas; the NL
Jacobian is analytic where JAX differentiates, the MPCC one is forward
mode in both).
"""

import re
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colaborativempc_tpu import config as jcfg
from colaborativempc_tpu.dynamics import pacejka as jpac
from colaborativempc_tpu.geometry import make_track as j_make_track
from colaborativempc_tpu.planners import mpcc as jmpcc
from colaborativempc_tpu.planners import nl as jnl
from colaborativempc_tpu.runtime import ocd as jocd
from colaborativempc_tpu.runtime import simulate as jsim
from colaborativempc_tpu.utils.precision import x64_island

from colaborativempc_tpu_torch import config as tcfg
from colaborativempc_tpu_torch import interop
from colaborativempc_tpu_torch.dynamics import pacejka as tpac
from colaborativempc_tpu_torch.ops import cuda_sqp
from colaborativempc_tpu_torch.planners import mpcc as tmpcc
from colaborativempc_tpu_torch.planners import nl as tnl
from colaborativempc_tpu_torch.runtime import simulate as tsim
from colaborativempc_tpu_torch.scripts import library_order

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
SOURCE = (Path(cuda_sqp.__file__).resolve().parent.parent / "csrc"
          / "sqp_qp.cu")
FIELDS = ("F", "G", "d", "Q", "q", "R", "r", "S", "D", "E", "lo", "hi",
          "soft_lo", "soft_hi")


def fields(qp):
    """A StageQP (port or JAX) as numpy arrays by field name."""
    return dict(zip(FIELDS, (np.asarray(a) for a in (
        qp.dyn.F, qp.dyn.G, qp.dyn.d, qp.cost.Q, qp.cost.q, qp.cost.R,
        qp.cost.r, qp.cost.S, qp.D, qp.E, qp.lo, qp.hi, qp.soft_lo,
        qp.soft_hi))))


def assert_fields_equal(got, ref, atol=1e-9, nan_subset=(),
                        nan_superset=()):
    """Every field within ``atol`` where both are finite, with the same
    infinities; NaN in the same places, except in ``nan_subset``, where
    every NaN of ``got`` is a NaN of ``ref`` (``ref`` may have more), and
    in ``nan_superset``, where every NaN of ``ref`` is one of ``got``."""
    for f in FIELDS:
        g, r = got[f], ref[f]
        assert g.shape == r.shape, f
        gn, rn = np.isnan(g), np.isnan(r)
        if f in nan_subset:
            assert not (gn & ~rn).any(), f
        elif f in nan_superset:
            assert not (rn & ~gn).any(), f
        else:
            np.testing.assert_array_equal(gn, rn, err_msg=f)
        both = ~gn & ~rn
        np.testing.assert_array_equal(np.isinf(g[both]), np.isinf(r[both]),
                                      err_msg=f)
        fin = both & np.isfinite(g) & np.isfinite(r)
        np.testing.assert_allclose(g[fin], r[fin], rtol=0, atol=atol,
                                   err_msg=f)
        np.testing.assert_array_equal(g[both & ~fin], r[both & ~fin],
                                      err_msg=f)


# --- NL: the plain version against JAX at the edges --------------------------

def nl_inputs(map_type="Highway", N=8, seed=0):
    """Per-agent SQP inputs of a perturbed 3-agent fleet as numpy arrays,
    built with the JAX package (as tests/test_torch_nl.py), on ``map_type``;
    the linearisation point is pushed onto the velocity gate's edges: vx
    below 0.2 at some stages, exactly 0.2 (not gated) at others."""
    jc = jcfg.ExperimentConfig(n_agents=3, N=N, dt=0.02, map_type=map_type,
                               gains=jcfg.nl_gains(), dtype="float64")
    n = jc.n_agents
    rng = np.random.default_rng(seed)
    with x64_island():
        jt = j_make_track(map_type, dtype=jnp.float64)
        st = jocd.init_nl_fleet(jt, jc)
        x_bar = (np.asarray(st.x_pred)
                 + rng.normal(size=st.x_pred.shape) * 0.03)
        x_bar[:, 1:N:3, 0] = 0.1
        x_bar[:, 2:N:3, 0] = 0.2
        planes = np.asarray(jocd._bisector_planes(jnp.asarray(x_bar)))
    u_bar = rng.normal(size=st.u_pred.shape) * 0.05
    ns = jsim._neighbour_index(n)
    ids = np.arange(n)
    neigh = np.swapaxes(np.swapaxes(x_bar[:, :, 7:9], 0, 1)[:, ns], 0, 1)
    lambdas = rng.uniform(0.0, 2.0, size=(n, n, N))
    return jc, dict(
        track=jt, x_bar=x_bar, u_bar=u_bar, lam=lambdas[ids[:, None], ns],
        neigh=neigh, mmask=(ids[:, None] < ns).astype(np.float32),
        planes=planes[np.minimum(ids[:, None], ns),
                      np.maximum(ids[:, None], ns)])


def nl_both(jc, inp, coupling, u_trust=(0.06, 0.6), lanes=None):
    """The JAX build (vmapped over agents) and the port's plain build of
    the same inputs, float64, as numpy fields."""
    lane = np.zeros(3, np.int32) if lanes is None else np.asarray(lanes)
    with x64_island():
        lim = jsim._per_agent_limits(jc)
        ref = jax.jit(jax.vmap(
            lambda l, ln, xb, ub, lam, nb, mm, pl: jnl.build_nl_qp(
                inp["track"], jc.gains, l, jc.model, jc.N, jc.dt, xb, ub,
                lam, nb, mm, u_trust=u_trust, coupling=coupling, lane=ln,
                planes0=pl)))(
            lim, jnp.asarray(lane), *(jnp.asarray(inp[k]) for k in (
                "x_bar", "u_bar", "lam", "neigh", "mmask", "planes")))
    tc = tcfg.ExperimentConfig(n_agents=3, N=jc.N, dt=jc.dt,
                               map_type=jc.map_type, gains=tcfg.nl_gains(),
                               dtype="float64")
    tt = interop.track_from_numpy(inp["track"], dtype=F64, device="cpu")
    t = lambda k: torch.tensor(inp[k], dtype=F64)  # noqa: E731
    got = tnl.build_nl_qp_plain(
        tt, tc.gains, tsim._per_agent_limits(tc, "cpu"), tc.model, tc.N,
        tc.dt, t("x_bar"), t("u_bar"), t("lam"), t("neigh"),
        torch.tensor(inp["mmask"]), u_trust=u_trust, coupling=coupling,
        lane=0 if lanes is None else torch.tensor(lane),
        planes0=t("planes"))
    return fields(got), fields(ref)


@pytest.mark.parametrize("trust", ["trust", "no_trust"])
@pytest.mark.parametrize("coupling", ["eu", "hp", "hp_opt"])
def test_nl_plain_matches_jax_at_the_velocity_gate(coupling, trust):
    """Every coupling, with and without the SQP trust region, with stages
    below the gate (tyre terms and their derivatives zero) and on it."""
    jc, inp = nl_inputs(seed=2)
    got, ref = nl_both(jc, inp, coupling,
                       u_trust=(0.06, 0.6) if trust == "trust" else None)
    assert np.all(got["F"][:, 1::3, 0, 1] == 0.0)   # gated
    assert np.all(got["F"][:, 2::3, 0, 1] != 0.0)   # vx = 0.2: not gated
    if trust == "no_trust":
        lim = tcfg.SysLimits()
        assert np.all(got["lo"][..., 2] == np.float32(-lim.max_ls))
    assert_fields_equal(got, ref)


def test_nl_plain_nan_in_the_linearisation_point():
    """A NaN in x_bar reaches the same model rows, bounds and offsets on
    both packages; JAX's jacfwd also multiplies the zero tangents of the
    other entries by it, where the port's analytic Jacobian keeps them, so
    the port's NaN entries of F, G and D are a subset of JAX's."""
    jc, inp = nl_inputs(seed=5)
    inp["x_bar"][1, 3, 0] = np.nan
    got, ref = nl_both(jc, inp, "eu")
    assert np.isnan(got["d"][1, 3, :9]).all()
    assert np.isnan(got["F"][1, 3, 0, 0])
    assert_fields_equal(got, ref, nan_subset=("F", "G", "D", "E"))


def test_nl_plain_per_problem_lanes_match_jax():
    """A per-problem lane tensor (agents on both lanes of Oval2) looks up
    each problem's curvature (and half-width) on its own lane."""
    jc, inp = nl_inputs(map_type="Oval2", seed=3)
    # arc lengths on the first curve of the inner lane, where the lanes'
    # curvatures differ
    curv, s0 = np.asarray(inp["track"].curv), np.asarray(inp["track"].s0)
    seg = int(np.argmax(curv[1] != 0.0))
    inp["x_bar"][..., 6] = s0[1, seg] + np.linspace(0.05, 0.5, jc.N + 1)
    got, ref = nl_both(jc, inp, "eu", lanes=[0, 1, 0])
    assert_fields_equal(got, ref)
    _, ref0 = nl_both(jc, inp, "eu", lanes=[0, 0, 0])
    assert not np.array_equal(ref["F"][1], ref0["F"][1])
    assert np.array_equal(ref["F"][0], ref0["F"][0])


# --- MPCC: the plain version against JAX at the slip floor ------------------

def mpcc_inputs(N=8, seed=0, nan=False):
    """Two races' SQP inputs on oval_mt (numpy, float64): vx on the slip
    floor's edges (exactly 0.3: the tie, below it, above it), optionally
    a NaN in vx."""
    rng = np.random.default_rng(seed)
    B = 2
    x = np.zeros((B, N + 1, 9))
    x[..., 0] = rng.uniform(0.5, 1.5, size=(B, N + 1))
    x[:, 1:N:3, 0] = 0.3
    x[:, 2:N:3, 0] = 0.15
    x[..., 1:5] = rng.normal(size=(B, N + 1, 4)) * [0.1, 0.5, 0.05, 0.1]
    x[..., 5] = rng.uniform(-3, 3, size=(B, N + 1))
    x[..., 6] = np.cumsum(rng.uniform(0.0, 0.1, size=(B, N + 1)), 1) + 2.0
    x[..., 7:9] = rng.normal(size=(B, N + 1, 2))
    u = rng.normal(size=(B, N, 2)) * [0.1, 0.3]
    if nan:
        x[1, 4, 0] = np.nan
    return x, u


def mpcc_both(x, u, N=8, dt=0.05):
    with x64_island():
        jt = j_make_track("oval_mt", dtype=jnp.float64)
        ref = jax.jit(jax.vmap(lambda xb, ub: jmpcc.build_mpcc_qp(
            jt, jmpcc.MPCCGains(), jpac.PacejkaParams(), N, dt, xb, ub)))(
            jnp.asarray(x), jnp.asarray(u))
    tt = interop.track_from_numpy(jt, dtype=F64, device="cpu")
    # float64 gains: the port takes a Python-number gain through a float32
    # tensor (planners/mpcc.py _col)
    gains = tmpcc.MPCCGains(*(torch.tensor(v, dtype=F64)
                              for v in tmpcc.MPCCGains()))
    got = tmpcc.build_mpcc_qp_plain(tt, gains, tpac.PacejkaParams(), N, dt,
                                    torch.tensor(x), torch.tensor(u))
    return fields(got), fields(ref)


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
def test_mpcc_plain_matches_jax_at_the_slip_floor(nan):
    """The floor max(vx, 0.3) of the slip angles: at the tie both packages
    halve the tangent, below it the vx derivative of the slip rows is zero.
    A NaN vx reaches the same model offsets and bounds; torch.func also
    multiplies the zero tangents of the input columns by it where JAX's
    jacfwd does not, so JAX's NaN entries of F, G, D and E are a subset of
    the port's (the kernel follows torch.func)."""
    x, u = mpcc_inputs(nan=nan)
    got, ref = mpcc_both(x, u)
    assert_fields_equal(got, ref, nan_superset=("F", "G", "D", "E"))
    D = got["D"]
    # slip rows (4, 5) at a tie (stage 1) and below the floor (stage 2)
    assert np.all(D[0, 2, 4:6, 0] == 0.0)
    assert np.all(D[0, 1, 4:6, 0] != 0.0)
    if nan:
        assert np.isnan(got["d"][1, 4, :9]).all()


# --- the forward-mode rules the MPCC kernel follows --------------------------
# torch.func.jacfwd of the Pacejka model and tyre rows, tangent by tangent:
# a tangent that meets a Python number becomes float64 (the number's zero
# tangent is a 0-dim float64 tensor); everything else keeps float32. The
# kernel's pacejka() is this, op for op.

class Dual:
    def __init__(self, p, t):
        self.p, self.t = p, t     # t None: undefined (no tangent)


def _t_add(a, b):
    if a is None or b is None:
        return b if a is None else a
    d = F64 if F64 in (a.dtype, b.dtype) else F32
    return a.to(d) + b.to(d)


def _t_mul(t, p):
    return None if t is None else t * p.to(t.dtype)


def d_mul_s(a, s):
    return Dual(a.p * s, None if a.t is None else (a.t * s).double())


def d_div_s(a, s):
    return Dual(a.p / s, None if a.t is None else a.t.double() / s)


def d_sub_s(a, s):
    return Dual(a.p - s, None if a.t is None else a.t.double())


def d_rsub_s(s, a):
    return Dual(s - a.p, None if a.t is None else -a.t)


def d_neg(a):
    return Dual(-a.p, None if a.t is None else -a.t)


def d_add(a, b):
    return Dual(a.p + b.p, _t_add(a.t, b.t))


def d_sub(a, b):
    return Dual(a.p - b.p, _t_add(a.t, None if b.t is None else -b.t))


def d_mul(a, b):
    return Dual(a.p * b.p, _t_add(_t_mul(b.t, a.p), _t_mul(a.t, b.p)))


def d_div(a, b):   # (a' - b' r) / b
    r = a.p / b.p
    if a.t is None and b.t is None:
        return Dual(r, None)
    num = _t_add(a.t, None if b.t is None else -_t_mul(b.t, r))
    return Dual(r, num / b.p.to(num.dtype))


def d_sin(a):
    return Dual(torch.sin(a.p), _t_mul(a.t, torch.cos(a.p)))


def d_cos(a):
    return Dual(torch.cos(a.p), _t_mul(a.t, -torch.sin(a.p)))


def d_atan(a):
    return Dual(torch.atan(a.p), a.t / (a.p * a.p + 1).to(a.t.dtype))


def d_atan2(y, x):
    den = y.p * y.p + x.p * x.p
    num = _t_add(_t_mul(x.t, -y.p), _t_mul(y.t, x.p))
    return Dual(torch.atan2(y.p, x.p), num / den.to(num.dtype))


def d_max_c(a, c):   # the tangent halved at a tie
    fac = torch.where(a.p == c, torch.tensor(0.5), (a.p > c).to(F32))
    return Dual(torch.maximum(a.p, torch.full_like(a.p, c)), _t_mul(a.t, fac))


def d_pow2(a):
    return Dual(a.p * a.p, _t_mul(a.t, 2.0 * a.p))


def pacejka_duals(x, u, kappa, p):
    """f (9 duals) and the three tyre rows, as the kernel's pacejka()."""
    vx, vy, wz, ey = x[:4]
    delta = u[0]
    vxc = d_max_c(vx, 0.3)
    af = d_add(d_neg(d_atan2(d_add(vy, d_mul_s(wz, p.lf)), vxc)), delta)
    ar = d_neg(d_atan2(d_sub(vy, d_mul_s(wz, p.lr)), vxc))
    F_fy = d_mul_s(d_sin(d_mul_s(d_atan(d_mul_s(af, p.Bf)), p.Cf)), p.Df)
    F_ry = d_mul_s(d_sin(d_mul_s(d_atan(d_mul_s(ar, p.Br)), p.Cr)), p.Dr)
    F_rx = d_sub_s(d_sub(d_mul_s(u[1], p.Cm1),
                         d_mul(d_mul_s(u[1], p.Cm2), vx)), p.Cr0)
    F_rx = d_sub(F_rx, d_mul(d_mul_s(vx, p.Cr2), vx))
    f = [d_div_s(d_add(d_sub(F_rx, d_mul(F_fy, d_sin(delta))),
                       d_mul(d_mul_s(vy, p.m), wz)), p.m),
         d_div_s(d_sub(d_add(F_ry, d_mul(F_fy, d_cos(delta))),
                       d_mul(d_mul_s(vx, p.m), wz)), p.m),
         d_div_s(d_sub(d_mul(d_mul_s(F_fy, p.lf), d_cos(delta)),
                       d_mul_s(F_ry, p.lr)), p.I)]
    se, ce, st, ct = d_sin(x[4]), d_cos(x[4]), d_sin(x[5]), d_cos(x[5])
    den = d_rsub_s(1.0, d_mul(ey, kappa))
    f += [d_add(d_mul(se, vx), d_mul(ce, vy)),
          d_add(d_add(d_mul(d_div(d_mul(d_neg(ce), kappa), den), vx),
                      d_mul(d_div(d_mul(se, kappa), den), vy)), wz),
          wz,
          d_add(d_mul(d_div(ce, den), vx), d_mul(d_div(d_neg(se), den), vy)),
          d_sub(d_mul(ct, vx), d_mul(st, vy)),
          d_add(d_mul(st, vx), d_mul(ct, vy))]
    rows = [d_sub_s(d_add(d_pow2(d_mul_s(F_rx, p.p_long)), d_pow2(F_ry)),
                    (p.p_ell * p.Dr) ** 2),
            d_sub_s(af, p.max_alpha), d_rsub_s(-p.max_alpha, af)]
    return f, rows


def jacobians_by_rules(x, u, kappa, p, dt):
    """Ad, Bd of fd = x + dt f and the tyre rows' gx, gu, one Jacobian
    column (one basis tangent) at a time, each column's stacked tangents
    promoted to their common dtype and rounded to float32 at the end."""
    fcols, rcols = [], []
    for j in range(11):
        xs = [Dual(x[:, i], torch.full_like(x[:, i], float(i == j)))
              for i in range(9)]
        us = [Dual(u[:, i], torch.full_like(u[:, i], float(9 + i == j)))
              for i in range(2)]
        f, rows = pacejka_duals(xs, us, Dual(kappa, None), p)
        ft = torch.stack([t.t.double() for t in f], -1)
        if all(t.t.dtype == F32 for t in f):
            ft = ft.float()
        seed = torch.stack([t.t for t in xs], -1).to(ft.dtype)
        fcols.append((seed + ft * dt).float())
        rcols.append(torch.stack([r.t.double() for r in rows], -1).float())
    J, R = torch.stack(fcols, -1), torch.stack(rcols, -1)
    return J[..., :9], J[..., 9:], R[..., :9], R[..., 9:]


def test_forward_mode_rules_reproduce_torch_func():
    """The rules of the MPCC kernel's Jacobians (the kernel's pacejka())
    give torch.func's Jacobians bit for bit, in float32, at the slip
    floor's tie, below it, and with a NaN vx."""
    p = tpac.PacejkaParams()
    g = torch.Generator().manual_seed(3)
    S = 600
    x = (torch.randn(S, 9, generator=g)
         * torch.tensor([1.0, 0.3, 2.0, 0.2, 0.3, 3.0, 5.0, 2.0, 2.0])
         + torch.tensor([1.0, 0, 0, 0, 0, 0, 0, 0, 0]))
    x[:50, 0] = 0.3
    x[50:100, 0] = 0.1
    x[100:110, 0] = float("nan")
    u = torch.randn(S, 2, generator=g) * torch.tensor([0.2, 0.5])
    kappa = torch.randn(S, generator=g) * 0.5
    Ad, Bd, _ = tpac.linearize_pacejka(x, u, kappa, p, 0.05)
    _, gx, gu = tpac.tire_row_jacobians(x, u, p)
    got = jacobians_by_rules(x, u, kappa, p, 0.05)
    for a, b in zip(got, (Ad, Bd, gx, gu)):
        assert a.dtype == b.dtype == F32
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


# --- dispatch, checks and packing --------------------------------------------

def port_nl_args(dtype=F32, coupling="eu"):
    jc, inp = nl_inputs(seed=4)
    tc = tcfg.ExperimentConfig(n_agents=3, N=jc.N, dt=jc.dt,
                               gains=tcfg.nl_gains())
    t = lambda k: torch.tensor(inp[k], dtype=dtype)  # noqa: E731
    tt = interop.track_from_numpy(inp["track"], dtype=F32, device="cpu")
    return dict(track=tt, gains=tc.gains,
                limits=tsim._per_agent_limits(tc, "cpu"), model=tc.model,
                N=tc.N, dt=tc.dt, x_bar=t("x_bar"), u_bar=t("u_bar"),
                lambdas=t("lam"), neigh_xy=t("neigh"),
                master_mask=torch.tensor(inp["mmask"]), coupling=coupling,
                planes0=t("planes"))


def port_mpcc_args():
    x, u = mpcc_inputs()
    with x64_island():
        jt = j_make_track("oval_mt", dtype=jnp.float32)
    return dict(track=interop.track_from_numpy(jt, dtype=F32, device="cpu"),
                gains=tmpcc.MPCCGains(), p=tpac.PacejkaParams(), N=8,
                dt=0.05, x_bar=torch.tensor(x, dtype=F32),
                u_bar=torch.tensor(u, dtype=F32), bounds=tmpcc.MPCCBounds())


@pytest.mark.parametrize("family", ["nl", "mpcc"])
def test_cpu_tensors_take_the_plain_version_without_a_launch(family):
    if family == "nl":
        args, build, plain = port_nl_args(), tnl.build_nl_qp, \
            tnl.build_nl_qp_plain
        wrapper = cuda_sqp.nl_qp_batched
    else:
        args, build, plain = port_mpcc_args(), tmpcc.build_mpcc_qp, \
            tmpcc.build_mpcc_qp_plain
        wrapper = cuda_sqp.mpcc_qp_batched
    before = wrapper.launches
    got, ref = fields(build(**args)), fields(plain(**args))
    assert wrapper.launches == before
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


def _to_meta(args):
    return {k: v.to("meta") if isinstance(v, torch.Tensor)
            and k not in ("track", "limits") else v for k, v in args.items()}


@pytest.mark.parametrize("route", ["nl_wrapper_on_cpu", "mpcc_wrapper_on_cpu",
                                   "nl_dispatch_on_meta",
                                   "mpcc_dispatch_on_meta"])
def test_no_fallback_to_the_plain_version(route):
    """The wrappers refuse CPU tensors, and the builds hand a tensor that
    is on neither the CPU nor a card to the wrapper, which refuses it:
    nothing routes a non-CPU tensor to the plain version."""
    nl_route = route.startswith("nl")
    args = port_nl_args() if nl_route else port_mpcc_args()
    wrapper = cuda_sqp.nl_qp_batched if nl_route else cuda_sqp.mpcc_qp_batched
    before = wrapper.launches
    if route.endswith("on_cpu"):
        with pytest.raises(ValueError, match="no kernel for device cpu"):
            wrapper(**args)
    else:
        build = tnl.build_nl_qp if nl_route else tmpcc.build_mpcc_qp
        with pytest.raises(ValueError, match="no kernel for device meta"):
            build(**_to_meta(args))
    assert wrapper.launches == before


@pytest.mark.parametrize("case", ["float64", "non_contiguous", "shape",
                                  "device"])
def test_wrapper_checks_raise(case):
    """The wrappers' argument check refuses what the kernels do not take."""
    cpu = torch.device("cpu")
    t = torch.zeros((3, 9, 9))
    if case == "float64":
        with pytest.raises(TypeError, match="float32"):
            cuda_sqp._check("x_bar", t.double(), (3, 9, 9), cpu)
    elif case == "non_contiguous":
        with pytest.raises(ValueError, match="not contiguous"):
            cuda_sqp._check("x_bar", t.transpose(1, 2), (3, 9, 9), cpu)
    elif case == "shape":
        with pytest.raises(ValueError, match="shape"):
            cuda_sqp._check("x_bar", t, (3, 8, 9), cpu)
    else:
        with pytest.raises(ValueError, match="expected meta"):
            cuda_sqp._check("x_bar", t, (3, 9, 9), torch.device("meta"))


@pytest.mark.parametrize("nb,coupling,stages", [
    (8, "hp_opt", 8), (19, "hp_opt", 8), (20, "hp_opt", 7),
    (31, "hp_opt", 3), (63, "hp_opt", 1), (31, "eu", 8), (300, "eu", 5)])
def test_nl_build_plan_takes_fewer_stages_where_the_image_does_not_fit(
        nb, coupling, stages):
    """The NL build takes any neighbour count: 8 stages per block while the
    image, the neighbour arrays and the staged track fit in the block's
    shared memory, fewer past that (the most that fit), nothing spilled
    while one stage fits (the test below)."""
    nc, m = cuda_sqp.nl_shape(nb, coupling)
    hp_opt = coupling == "hp_opt"
    plan = cuda_sqp.sqp_qp_plan(4, 20, nc, m, 1000, nb, hp_opt)
    assert plan.stages == stages and plan.blocks == 4 * -(-20 // stages)
    assert plan.smem_bytes <= cuda_sqp.SQP_SMEM_LIMIT
    assert plan.spilled == "" and plan.scratch_bytes == 0
    if stages < 8:
        more = 4 * (cuda_sqp.image_floats(nc, m, stages + 1) + 3000
                    + cuda_sqp.neighbour_floats(nb, hp_opt, stages + 1))
        assert more > cuda_sqp.SQP_SMEM_LIMIT


@pytest.mark.parametrize("agents,coupling,nseg", [
    (71, "hp_opt", 1000),    # 70 neighbours: raised before the spill
    (72, "hp_opt", 1000), (100, "hp_opt", 1000),
    (100, "hp_opt", 3000),   # a track searched where it lies
    (1900, "eu", 1000)])
def test_nl_build_plan_spills_past_shared_memory(agents, coupling, nseg):
    """Where one stage's image and neighbour arrays do not fit, the image
    and the neighbour arrays of 8 stages per block go into a global
    scratch (one share per block) and only the lane's staged track rows
    stay in shared memory; pinned off, and for MPCC, it raises; and a
    plan raises on sizes below 1."""
    nb = agents - 1
    nc, m = cuda_sqp.nl_shape(nb, coupling)
    hp_opt = coupling == "hp_opt"
    one = 4 * (cuda_sqp.image_floats(nc, m, 1)
               + cuda_sqp.neighbour_floats(nb, hp_opt, 1)
               + (3 * nseg if nseg <= 2048 else 0))
    assert one > cuda_sqp.SQP_SMEM_LIMIT
    plan = cuda_sqp.sqp_qp_plan(agents, 20, nc, m, nseg, nb, hp_opt)
    assert plan.spilled == "image" and plan.stages == 8
    assert plan.blocks == agents * 3
    assert plan.smem_bytes == (4 * 3 * nseg if nseg <= 2048 else 0)
    assert plan.scratch_bytes == 4 * plan.blocks * (
        cuda_sqp.image_floats(nc, m, 8)
        + cuda_sqp.neighbour_floats(nb, hp_opt, 8))
    with pytest.raises(ValueError, match="pinned off"):
        cuda_sqp.sqp_qp_plan(agents, 20, nc, m, nseg, nb, hp_opt,
                             spill=False)
    with pytest.raises(ValueError, match="MPCC has none"):
        cuda_sqp.sqp_qp_plan(4, 20, 2, 7, nseg, spill=True)
    with pytest.raises(ValueError, match="P, N >= 1"):
        cuda_sqp.sqp_qp_plan(0, 20, nc, m, nseg, nb, hp_opt)


def test_pack_slots_numbers_and_tensors():
    """Gains and limits given as numbers go to the kernel as their float32
    values (no pointer); a tensor as pointers into it, one per entry, with
    the stride from one problem to the next (0 when shared); per-problem
    and shared fields mix; nothing is packed into a new tensor."""
    g, lim = tcfg.nl_gains(), tcfg.SysLimits()
    ptrs, strides, vals, alive = cuda_sqp.pack_slots(
        cuda_sqp.nl_fields(g, lim), 3, "cpu")
    assert len(ptrs) == len(strides) == len(vals) == cuda_sqp.NL_SLOTS
    assert ptrs == [None] * cuda_sqp.NL_SLOTS and alive == []
    np.testing.assert_array_equal(vals[:9], np.float32(g.q))
    np.testing.assert_array_equal(vals[9:11], np.float32(g.r))
    np.testing.assert_array_equal(vals[11:13], np.float32(g.dr))
    # qs as given: the kernel caps it at SOFT_WEIGHT_CAP
    np.testing.assert_array_equal(vals[13:16], np.float32(g.qs))
    np.testing.assert_array_equal(vals[16:], np.float32(list(lim)))
    q = torch.tensor(np.stack([g.q, 2 * g.q, 3 * g.q]), dtype=F32)
    md = torch.tensor([0.2, 0.3, 0.4])
    ptrs, strides, vals, alive = cuda_sqp.pack_slots(cuda_sqp.nl_fields(
        g._replace(q=q, r=torch.tensor(g.r, dtype=F32)),
        lim._replace(min_dist=md)), 3, "cpu")
    assert alive[0] is q                    # float32 and contiguous: as is
    assert ptrs[:9] == [q.data_ptr() + 4 * j for j in range(9)]
    assert strides[:9] == [9] * 9           # one row per problem
    assert strides[9:11] == [0, 0] and ptrs[9] is not None   # shared row
    assert ptrs[11:16] == [None] * 5
    assert ptrs[17] == md.data_ptr() and strides[17] == 1
    assert ptrs[16] is None and vals[16] == np.float32(lim.vx_ref)
    with pytest.raises(ValueError, match="problems"):
        cuda_sqp.pack_slots(cuda_sqp.nl_fields(g._replace(q=q), lim), 4,
                            "cpu")
    m = tmpcc.MPCCGains()
    ptrs, _, vals, _ = cuda_sqp.pack_slots(cuda_sqp.mpcc_fields(m), 2, "cpu")
    assert len(ptrs) == cuda_sqp.MPCC_SLOTS and vals == [
        float(np.float32(v)) for v in m]
    qc = torch.tensor([20.0, 50.0], dtype=torch.float64)
    ptrs, strides, _, alive = cuda_sqp.pack_slots(
        cuda_sqp.mpcc_fields(m._replace(q_contour=qc)), 2, "cpu")
    assert alive[0].dtype == F32 and alive[0].tolist() == [20.0, 50.0]
    assert ptrs[1] == alive[0].data_ptr() and strides[1] == 1


def test_pack_lane():
    assert cuda_sqp.pack_lane(1, 4, "cpu") == 1
    lanes = cuda_sqp.pack_lane(torch.tensor([0, 1, 1, 0]), 4, "cpu")
    assert lanes.dtype == torch.int32 and lanes.tolist() == [0, 1, 1, 0]
    assert cuda_sqp.pack_lane(torch.tensor([1]), 3, "cpu").tolist() == [1] * 3
    with pytest.raises(ValueError, match="lane"):
        cuda_sqp.pack_lane(torch.tensor([0, 1]), 4, "cpu")


def test_outputs_have_the_stage_qp_shapes():
    outs = cuda_sqp._outputs(3, 5, 6, 10, "cpu")
    assert [tuple(t.shape) for t in outs] == [
        (3, 5, 11, 11), (3, 5, 11, 6), (3, 5, 11), (3, 6, 11, 11), (3, 6, 11),
        (3, 5, 6, 6), (3, 5, 6), (3, 5, 11, 6), (3, 5, 10, 11),
        (3, 5, 10, 6)] + [(3, 5, 10)] * 4
    assert all(t.is_contiguous() and t.dtype == F32 for t in outs)


def _enum(name):
    body = re.search(r"enum " + name + r" \{(.*?)\};", SOURCE.read_text(),
                     re.S).group(1)
    return [w.strip() for w in body.split(",") if w.strip()]


def test_kernel_constants_match_the_source():
    """The constants arrays carry one entry per constant of the source's
    enums, before the count."""
    nl = _enum("NLConst")
    assert nl[-1] == "kNLConsts"
    assert len(cuda_sqp.nl_consts(tcfg.ModelParams(), 0.02, "eu",
                                  (0.06, 0.6))) == len(nl) - 1
    mp = _enum("MPCCConst")
    assert mp[-1] == "kMPCCConsts"
    assert len(cuda_sqp.mpcc_consts(tpac.PacejkaParams(), 0.05,
                                    tmpcc.MPCCBounds())) == len(mp) - 1
    assert len(_enum("MG")) == len(tmpcc.MPCCGains._fields)
    assert len(_enum("Lim")) == len(tcfg.SysLimits._fields)
    slots = re.search(r"kNLSlots = 16 \+ 9, kMPCCSlots = (\d+);",
                      SOURCE.read_text())
    assert cuda_sqp.NL_SLOTS == 25 and int(slots.group(1)) == \
        cuda_sqp.MPCC_SLOTS
    consts = cuda_sqp.nl_consts(tcfg.ModelParams(), 0.02, "hp", None)
    assert consts[nl.index("kPriceScale")] == 0.5
    assert consts[nl.index("kUt0")] == consts[nl.index("kUt1")] == 0.0


@pytest.mark.parametrize("layout,batch,order", [
    ("row", 60, "HALVES"), ("row", 3840, "HALVES"), ("row", 12_997, "HALVES"),
    ("row", 12_998, "EVEN_ODD"), ("row", 15_360, "EVEN_ODD"),
    ("row", 37_293, "HALVES"), ("col", 40, "QUARTERS"),
    ("col", 189, "QUARTERS"), ("col", 190, "HALVES"), ("col", 360, "HALVES"),
    ("col", 1_336, "EVEN_ODD"), ("col", 2_853, "HALVES"),
    ("row", 10 ** 6, "HALVES")])
def test_matvec_order_by_layout_and_batch(layout, batch, order):
    """The order read off the card for each build: the NL build's
    row-major products at the Monte-Carlo's 3,840 take the halves, hp_opt
    at 256 fleets (15,360) the even and odd terms; the MPCC race's
    column-major Jacobians (60 per race) the quarters, the battery's 360
    the halves; an unread batch the halves."""
    assert cuda_sqp.matvec_order(batch, layout) == getattr(cuda_sqp, order)


@pytest.mark.parametrize("family", ["nl_eu", "nl_hp_opt", "mpcc"])
def test_traffic_counts_every_field(family):
    """The bound's bytes: every output field of the build written once,
    the inputs read once; at the main paths' shapes the bytes outweigh the
    operations' time."""
    if family == "mpcc":
        args = port_mpcc_args()
        qp = tmpcc.build_mpcc_qp_plain(**args)
        P, N = args["x_bar"].shape[0], args["N"]
        nbytes, flops = cuda_sqp.mpcc_traffic(P, N, *args["track"].s0.shape)
        inputs = [args["x_bar"], args["u_bar"], torch.zeros(P, 10)]
        big = cuda_sqp.mpcc_traffic(18, 20)
    else:
        coupling = family[3:]
        args = port_nl_args(coupling=coupling)
        qp = tnl.build_nl_qp_plain(**args)
        P, N = args["x_bar"].shape[0], args["N"]
        nb = args["neigh_xy"].shape[-2]
        nbytes, flops = cuda_sqp.nl_traffic(P, N, nb, coupling,
                                            *args["track"].s0.shape)
        per_problem = torch.zeros(P, 16 + 9 + 1 + nb)
        inputs = [args["x_bar"], args["u_bar"], args["lambdas"],
                  args["neigh_xy"][:, 1:], per_problem]
        if coupling == "hp_opt":
            inputs.append(args["planes0"])
        big = cuda_sqp.nl_traffic(192, 20, 2, coupling)
    tr = args["track"]
    shared = tr.s0.numel() * 3 + tr.track_length.numel() + 1
    written = sum(np.asarray(v).size for v in fields(qp).values())
    read = sum(t.numel() for t in inputs) + shared
    assert nbytes == 4 * (written + read)
    assert flops == cuda_sqp.OPS_PER_STAGE * P * N
    assert big[0] / 3.35e12 > big[1] / 67e12


@pytest.mark.parametrize("k", [2, 9])
def test_matvec_order_candidates_compute_the_product(k):
    """The orders ``scripts/library_order.py --parts matvec`` tells apart
    on the card (and the build kernel's ``mv`` follows) each compute
    ``A @ x`` to float32 rounding."""
    g = torch.Generator().manual_seed(k)
    A, x = torch.randn(64, 1, 3, k, generator=g), torch.randn(64, 1, k,
                                                              generator=g)
    ref = (A.double() @ x.double()[..., None])[..., 0]
    for name, f in library_order.matvec_candidates(k).items():
        np.testing.assert_allclose(f(A, x), ref, rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("P,N,nc,m", [(3, 5, 6, 10), (1, 60, 2, 7),
                                      (192, 20, 2, 6), (2, 13, 18, 28)])
def test_outputs_are_views_of_one_allocation(P, N, nc, m):
    """The wrapper allocates the 14 output fields at once: views of one
    tensor, each contiguous with the StageQP field's shape, back to back in
    the kernel's field order, none overlapping another and all of it
    used."""
    outs = cuda_sqp._outputs(P, N, nc, m, "cpu")
    storage = outs[0].untyped_storage()
    assert all(t.untyped_storage().data_ptr() == storage.data_ptr()
               for t in outs)
    assert all(t.is_contiguous() and t.dtype == F32 for t in outs)
    expect = [(P, N, 11, 11), (P, N, 11, nc), (P, N, 11), (P, N + 1, 11, 11),
              (P, N + 1, 11), (P, N, nc, nc), (P, N, nc), (P, N, 11, nc),
              (P, N, m, 11), (P, N, m, nc)] + [(P, N, m)] * 4
    assert [tuple(t.shape) for t in outs] == expect
    at = 0
    for t in outs:
        assert (t.data_ptr() - storage.data_ptr()) // 4 == at
        at += t.numel()
    assert at * 4 == storage.nbytes()
    # a returned QP belongs to its caller: every call allocates anew
    again = cuda_sqp._outputs(P, N, nc, m, "cpu")
    assert again[0].untyped_storage().data_ptr() != storage.data_ptr()


def test_mpcc_reciprocals_are_the_divisions_the_plain_version_makes():
    """MPCC's 1 / m and 1 / I reach the kernel from the host: in float64
    the correctly rounded quotient, in float32 the float32 division of 1
    by the float32 number (the card's ``t / number`` multiplies by it)."""
    p = tpac.PacejkaParams()
    consts = cuda_sqp.mpcc_consts(p, 0.05, tmpcc.MPCCBounds())
    rm, ri, rm32, ri32 = consts[-4:]
    assert rm == 1.0 / p.m and ri == 1.0 / p.I
    for r32, v in ((rm32, p.m), (ri32, p.I)):
        want = torch.tensor(1.0, dtype=F32) / torch.tensor(v, dtype=F32)
        assert r32 == float(want)


def test_kept_arrays_keep_the_sign_of_zero():
    """The arrays of numbers the kernels take are kept per value by the
    values' bits: a -0.0 limit, ``u_trust`` entry or bound after a 0.0 one
    (equal in Python, with one hash) reaches the kernel as -0.0, and 0.0
    after -0.0 as 0.0; each kept array holds the bits of the numbers it
    was asked for."""
    def bits(values):
        return struct.pack(f"{len(values)}d", *values)
    g, lim = tcfg.nl_gains(), tcfg.SysLimits()
    model, p = tcfg.ModelParams(), tpac.PacejkaParams()
    for order in ((0.0, -0.0), (-0.0, 0.0)):
        for z in order:
            _, _, vals, _ = cuda_sqp.pack_slots(cuda_sqp.nl_fields(
                g, lim._replace(max_ls=z)), 3, "cpu")
            kept = cuda_sqp._doubles(tuple(vals))
            assert bits(kept) == bits(vals)
            assert bits([kept[16 + lim._fields.index("max_ls")]]) == bits(
                [z])
            ut = (z, 0.6)
            kept = cuda_sqp._nl_consts_array(model, 0.1, "eu", ut)
            assert bits(kept) == bits(cuda_sqp.nl_consts(model, 0.1, "eu",
                                                         ut))
            b = tmpcc.MPCCBounds(vx_min=z)
            kept = cuda_sqp._mpcc_consts_array(p, 0.05, b)
            assert bits(kept) == bits(cuda_sqp.mpcc_consts(p, 0.05, b))
    assert cuda_sqp._nl_consts_array(model, 0.1, "eu", None)[17] == 0.0


def test_sqp_split_script_imports_here_and_raises_without_a_card():
    """The SQP split script imports on the CPU and raises without a card,
    before it builds. Its shapes are phase 3d's: each pair on either side
    of a boundary of the batched matrix-vector order takes the two orders,
    hp_opt reaches 3, 4 and 8 neighbours, and each family has a track of
    more segments than the kernels stage."""
    from colaborativempc_tpu_torch.scripts import sqp_qp_split
    shapes = sqp_qp_split.SHAPES

    def order(name):
        family, P, _, N, _ = shapes[name]
        return cuda_sqp.matvec_order(P * N, "row" if family == "nl"
                                     else "col")
    for a, b in (("nl_eu_p649", "nl_eu_p650"), ("nl_eu_p1864", "nl_eu_p1865"),
                 ("mpcc_p9", "mpcc_p10"), ("mpcc_p66", "mpcc_p67"),
                 ("mpcc_p142", "mpcc_p143")):
        assert order(a) != order(b), (a, b)
    assert {shapes[f"nl_hp_opt_{n}_agents"][2] - 1 for n in (4, 5, 9)} == {
        3, 4, 8}
    for name in ("nl_eu_3000_segments", "mpcc_3000_segments"):
        assert shapes[name][4]["segments"] > cuda_sqp.MAX_STAGED_SEGMENTS
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        sqp_qp_split.main([])


def test_clocked_sqp_wrapper_refuses_cpu_tensors_before_building(
        monkeypatch):
    """``sqp_qp_clocked`` checks the device before it asks for the
    clock-stamped library, and counts no launch of the main path's
    kernels."""
    from colaborativempc_tpu_torch.ops import _build

    def no_build(*a, **k):
        raise AssertionError("built the clocked library for CPU tensors")
    monkeypatch.setattr(_build, "load_sqp_qp_clocks", no_build)
    before = (cuda_sqp.nl_qp_batched.launches,
              cuda_sqp.mpcc_qp_batched.launches)
    for family, args in (("nl", port_nl_args()), ("mpcc", port_mpcc_args())):
        with pytest.raises(ValueError, match="no kernel for device cpu"):
            cuda_sqp.sqp_qp_clocked(family, **args)
    assert (cuda_sqp.nl_qp_batched.launches,
            cuda_sqp.mpcc_qp_batched.launches) == before
