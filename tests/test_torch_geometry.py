"""Parity of the PyTorch port's geometry, dynamics and warm start with the
JAX package, plus the port's import hygiene.

Inputs are made with numpy from a seed and carried into both packages
(into the port through ``colaborativempc_tpu_torch.interop``). Everything
runs in float64, the JAX side inside ``x64_island``; tolerance 1e-9 (the
two sides evaluate the same formulas, so they agree to rounding).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colaborativempc_tpu.config import ModelParams as JModelParams
from colaborativempc_tpu.dynamics import bicycle as jbicycle
from colaborativempc_tpu.geometry import frenet as jfrenet
from colaborativempc_tpu.geometry import planes as jplanes
from colaborativempc_tpu.geometry import tracks as jtracks
from colaborativempc_tpu.utils import warmstart as jwarm
from colaborativempc_tpu.utils.precision import x64_island

from colaborativempc_tpu_torch import interop
from colaborativempc_tpu_torch.config import ModelParams
from colaborativempc_tpu_torch.dynamics import bicycle as tbicycle
from colaborativempc_tpu_torch.geometry import frenet as tfrenet
from colaborativempc_tpu_torch.geometry import planes as tplanes
from colaborativempc_tpu_torch.geometry import tracks as ttracks
from colaborativempc_tpu_torch.utils import warmstart as twarm
from colaborativempc_tpu_torch.utils.device import resolve_device

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)

ATOL = 1e-9
F64 = torch.float64
REPO = Path(__file__).resolve().parent.parent
TRACKS = ["Highway", "oval", "Oval2", "TestOpenMap", "L_shape", "SL", "3110"]


def close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol)


def jax_track(name):
    with x64_island():
        return jtracks.make_track(name, dtype=jnp.float64)


@pytest.mark.parametrize("name", TRACKS)
def test_make_track_matches_jax(name):
    jt = jax_track(name)
    tt = ttracks.make_track(name, device="cpu", dtype=F64)
    carried = interop.track_from_numpy(jt, dtype=F64, device="cpu")
    for f in ttracks.Track._fields:
        close(getattr(tt, f), getattr(jt, f), atol=0)
        close(getattr(carried, f), getattr(jt, f), atol=0)
    assert tt.n_lanes == jt.n_lanes and tt.n_segments == jt.n_segments
    back = interop.track_to_numpy(tt)
    close(back["s0"], jt.s0, atol=0)


@pytest.mark.parametrize("name", TRACKS)
def test_track_lookups_match_jax(name):
    jt = jax_track(name)
    tt = interop.track_from_numpy(jt, dtype=F64, device="cpu")
    rng = np.random.default_rng(5)
    for lane in range(jt.n_lanes):
        L = float(jt.track_length[lane])
        s = rng.uniform(-2.0, 2.0 * L + 3.0, size=64)
        s[:4] = [0.0, L, float(jt.s0[lane, 1]), -1e-3]   # edges
        ey = rng.uniform(-0.5, 0.5, size=64)
        st, eyt = torch.tensor(s, dtype=F64), torch.tensor(ey, dtype=F64)
        with x64_island():
            sj, eyj = jnp.asarray(s), jnp.asarray(ey)
            ref_wrap = jfrenet.wrap_s(jt, sj, lane)
            ref_idx, _ = jfrenet.segment_index(jt, sj, lane)
            ref_k = jfrenet.curvature(jt, sj, lane)
            ref_hw = jfrenet.halfwidth(jt, sj, lane, sm=0.9)
            ref_xyt = jfrenet.frenet_to_cartesian(jt, sj, eyj, lane)
            ref_pi = jfrenet.wrap_to_pi(sj)
        close(tfrenet.wrap_s(tt, st, lane), ref_wrap)
        idx, _ = tfrenet.segment_index(tt, st, lane)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        close(tfrenet.curvature(tt, st, lane), ref_k)
        close(tfrenet.halfwidth(tt, st, lane, sm=0.9), ref_hw)
        for got, ref in zip(tfrenet.frenet_to_cartesian(tt, st, eyt, lane),
                            ref_xyt):
            close(got, ref)
        close(tfrenet.wrap_to_pi(st), ref_pi)


def test_per_agent_lane_tensor_matches_jax():
    """A lane tensor gathers one lane row per agent (the fleet step's
    per-agent lanes); padded +inf s0 rows of the shorter lane are never
    selected."""
    jt = jax_track("Oval2")
    tt = interop.track_from_numpy(jt, dtype=F64, device="cpu")
    rng = np.random.default_rng(6)
    lanes = np.array([0, 1, 1, 0, 1])
    s = rng.uniform(-1.0, 60.0, size=(5, 7))
    ey = rng.uniform(-0.4, 0.4, size=(5, 7))
    got = tfrenet.frenet_to_cartesian(
        tt, torch.tensor(s, dtype=F64), torch.tensor(ey, dtype=F64),
        torch.tensor(lanes, dtype=torch.int32))
    hw = tfrenet.halfwidth(tt, torch.tensor(s, dtype=F64),
                           torch.tensor(lanes), sm=0.9)
    with x64_island():
        for i, ln in enumerate(lanes):
            ref = jfrenet.frenet_to_cartesian(jt, jnp.asarray(s[i]),
                                              jnp.asarray(ey[i]), int(ln))
            for g, r in zip(got, ref):
                close(g[i], r)
            close(hw[i], jfrenet.halfwidth(jt, jnp.asarray(s[i]), int(ln),
                                           sm=0.9))


def oval2_poses(rng, n=48):
    """Poses on and around both lanes of Oval2 (two concentric lanes 1 m
    apart, 26.0 m and 19.7 m long), a few far off the track, with Frenet
    rows that carry up to three laps on a random lane."""
    jt = jax_track("Oval2")
    src = rng.integers(0, 2, size=n)
    L = np.asarray(jt.track_length)[src]
    s = rng.uniform(0.0, 1.0, size=n) * L
    ey = rng.uniform(-0.7, 0.7, size=n)
    with x64_island():
        X, Y, th = (np.array(a) for a in jax.vmap(
            lambda a, b, ln: jfrenet.frenet_to_cartesian(jt, a, b, ln))(
            jnp.asarray(s), jnp.asarray(ey), jnp.asarray(src)))
    X[:3] += 40.0                                     # off every lane
    x = np.zeros((n, 9))
    x[:, 5] = th + rng.normal(size=n) * 0.2
    x[:, 6] = s + rng.integers(0, 3, size=n) * L
    x[:, 7], x[:, 8] = X, Y
    x[:, 3:5] = rng.normal(size=(n, 2))
    return jt, x, src


@pytest.mark.parametrize("lane", [0, 1])
def test_cartesian_to_frenet_matches_jax(lane):
    """Every segment scored at once, nearest valid |ey| wins, the
    (1e4, 1e4, 1e4, False) sentinel off the lane; float64 within 1e-9."""
    jt, x, _ = oval2_poses(np.random.default_rng(10 + lane))
    tt = interop.track_from_numpy(jt, dtype=F64, device="cpu")
    with x64_island():
        ref = jax.vmap(lambda a, b, c: jfrenet.cartesian_to_frenet(
            jt, a, b, c, lane=lane))(*(jnp.asarray(x[:, i]) for i in (7, 8, 5)))
    got = tfrenet.cartesian_to_frenet(
        tt, *(torch.tensor(x[:, i]) for i in (7, 8, 5)), lane=lane)
    for g, r in zip(got[:3], ref[:3]):
        close(g, r)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert not bool(got[3][:3].any()) and bool(got[3].any())
    assert float(got[0][0]) == 1e4


def test_lane_selection_and_relocalisation_match_jax():
    """``check_lane`` (min |ey| over lanes), ``relocalize`` onto a lane
    tensor with the lap count taken against the old lane's length, and
    ``select_lane``, elementwise; float64 within 1e-9, lanes equal."""
    rng = np.random.default_rng(12)
    jt, x, src = oval2_poses(rng)
    tt = interop.track_from_numpy(jt, dtype=F64, device="cpu")
    new = rng.integers(0, 2, size=len(src)).astype(np.int32)
    with x64_island():
        a = {i: jnp.asarray(x[:, i]) for i in (5, 7, 8)}
        ref_cl = jax.vmap(lambda p, q, r: jfrenet.check_lane(jt, p, q, r))(
            a[7], a[8], a[5])
        ref_rel = jax.vmap(lambda xx, ln, ol: jfrenet.relocalize(
            jt, xx, ln, old_lane=ol))(jnp.asarray(x), jnp.asarray(new),
                                      jnp.asarray(src))
        ref_same = jax.vmap(lambda xx: jfrenet.relocalize(jt, xx, 1))(
            jnp.asarray(x))
        ref_sel = jax.vmap(lambda xx, ol: jfrenet.select_lane(
            jt, xx, prev_lane=ol))(jnp.asarray(x), jnp.asarray(src))
    xt = torch.tensor(x)
    got_cl = tfrenet.check_lane(tt, xt[:, 7], xt[:, 8], xt[:, 5])
    for g, r in zip(got_cl[:3], ref_cl[:3]):
        close(g, r)
    for g, r in zip(got_cl[3:], ref_cl[3:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got_cl[4].dtype == torch.int32 and set(got_cl[4].tolist()) == {0, 1}
    close(tfrenet.relocalize(tt, xt, torch.tensor(new),
                             old_lane=torch.tensor(src)), ref_rel)
    close(tfrenet.relocalize(tt, xt, 1), ref_same)
    lanes, xs = tfrenet.select_lane(tt, xt, prev_lane=torch.tensor(src))
    np.testing.assert_array_equal(lanes.numpy(), np.asarray(ref_sel[0]))
    close(xs, ref_sel[1])
    # laps survive a switch between lanes of different lengths
    kept = got_cl[3].numpy()
    laps = np.round((xs[:, 6].numpy() - got_cl[0].numpy())
                    / jt.track_length[lanes.numpy()])
    np.testing.assert_array_equal(
        laps[kept], np.floor(x[kept, 6] / jt.track_length[src[kept]]))


def test_planes_and_weights_match_jax():
    rng = np.random.default_rng(7)
    P, H, n = 4, 9, 2
    ego = rng.normal(size=(P, H, 2))
    neigh = ego[:, :, None, :] + rng.normal(size=(P, H, n, 2)) * 0.4
    neigh[0, 0, 0] = ego[0, 0]                      # coincident: eps guard
    with x64_island():
        ref_pl = jax.vmap(lambda e, q: jplanes.compute_hyperplanes(
            e, q, keep_sign=True))(jnp.asarray(ego), jnp.asarray(neigh))
        ref_w, ref_d = jax.vmap(lambda e, q: jplanes.separation_weights(
            e, q, 0.25))(jnp.asarray(ego), jnp.asarray(neigh))
    te, tq = torch.tensor(ego), torch.tensor(neigh)
    close(tplanes.compute_hyperplanes(te, tq), ref_pl)
    w, d = tplanes.separation_weights(te, tq, 0.25)
    close(w, ref_w)
    close(d, ref_d)


def _lpv_inputs(rng, P, N):
    x = rng.normal(size=(P, N, 9)) * 0.3
    x[..., 0] = rng.uniform(0.0, 3.0, size=(P, N))
    x[0, :3, 0] = [0.0, 0.1, 0.19999]               # low-velocity switch
    u = rng.normal(size=(P, N, 2)) * 0.2
    kappa = rng.normal(size=(P, N)) * 0.3
    return x, u, kappa


def test_lpv_dynamics_match_jax():
    rng = np.random.default_rng(8)
    P, N, dt = 3, 6, 0.02
    x, u, kappa = _lpv_inputs(rng, P, N)
    jp, tp = JModelParams(), ModelParams()
    with x64_island():
        xj, uj, kj = jnp.asarray(x), jnp.asarray(u), jnp.asarray(kappa)
        ref_A, ref_B = jax.vmap(jax.vmap(
            lambda a, b, k: jbicycle.lpv_matrices(a, b, k, jp)))(xj, uj, kj)
        ref_f = jax.vmap(jax.vmap(
            lambda a, b, k: jbicycle.f_continuous(a, b, k, jp)))(xj, uj, kj)
        ref_Ad, ref_Bd = jax.vmap(
            lambda a, b, k: jbicycle.lpv_discrete_horizon(a, b, k, dt, jp))(
                xj, uj, kj)
        ref_c = jax.vmap(jax.vmap(
            lambda a, b, k: jbicycle.lpv_coeffs(a, b, k, jp)))(xj, uj, kj)
    xt, ut, kt = (torch.tensor(a) for a in (x, u, kappa))
    A, B = tbicycle.lpv_matrices(xt, ut, kt, tp)
    close(A, ref_A)
    close(B, ref_B)
    close(tbicycle.f_continuous(xt, ut, kt, tp), ref_f)
    Ad, Bd = tbicycle.lpv_discrete_horizon(xt, ut, kt, dt, tp)
    close(Ad, ref_Ad)
    close(Bd, ref_Bd)
    coeffs = tbicycle.lpv_coeffs(xt, ut, kt, tp)
    for k, v in ref_c.items():
        close(coeffs[k], v)
    # the switch zeroes the tire terms below vx = 0.2
    assert float(A[0, 0, 0, 1]) == 0.0 and float(A[0, 2, 1, 1]) == 0.0


@pytest.mark.parametrize("name", ["Highway", "oval"])
def test_warmstart_matches_jax(name):
    jt = jax_track(name)
    tt = interop.track_from_numpy(jt, dtype=F64, device="cpu")
    rng = np.random.default_rng(9)
    x0s = np.array([[1.3, -0.16, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0],
                    [1.3, -0.16, 0.0, -0.25, 0.0, 0.0, 0.0, 0.0, 1.0],
                    [1.3, -0.16, 0.0, 0.45, 0.0, 0.0, 0.5, 0.0, 1.45]])
    x0s = x0s + rng.normal(size=x0s.shape) * 0.02
    N, dt = 12, 0.02
    with x64_island():
        ref_xy, ref_x, ref_u = jwarm.initialise_agents(
            jt, jnp.asarray(x0s), N, dt)
        ref_ws = jwarm.warmstart_trajectory(jt, jnp.asarray(x0s[2]), N, dt,
                                            accel=0.5, accel_rate=0.1)
    xy, xp, up = twarm.initialise_agents(tt, torch.tensor(x0s), N, dt)
    close(xy, ref_xy)
    close(xp, ref_x)
    close(up, ref_u)
    ws = twarm.warmstart_trajectory(tt, torch.tensor(x0s[2]), N, dt,
                                    accel=0.5, accel_rate=0.1)
    close(ws[0], ref_ws[0])
    close(ws[1], ref_ws[1])


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttracks.make_track("Highway", device="cuda")


SCRIPTS = ["nl_main", "mpcc_main", "monte_carlo", "lpv_main",
           "experiment_battery", "stress_study", "eval_lpv_model",
           "compare_reference", "eval_exp", "paper_figs", "show_maps",
           "test_planes", "epoch_data_split", "sqp_qp_split", "clock_split",
           "admm_epoch_split", "epoch_turns"]
# the scripts that compute (and so run on the card): they must import
# where matplotlib is missing, as on the card's machine
COMPUTE_SCRIPTS = ["nl_main", "mpcc_main", "monte_carlo", "lpv_main",
                   "experiment_battery", "stress_study",
                   "eval_lpv_model", "compare_reference", "epoch_data_split",
                   "sqp_qp_split", "clock_split", "admm_epoch_split",
                   "epoch_turns"]


def _import_blocked(blocked, modules, checks=""):
    code = (
        "import sys\n"
        + "".join(f"sys.modules[{b!r}] = None\n" for b in blocked)
        + "import colaborativempc_tpu_torch as p\n"
        + "".join(f"import {m}\n" for m in modules)
        + "assert not any(m == 'colaborativempc_tpu' or "
        "m.startswith('colaborativempc_tpu.') for m in sys.modules)\n"
        + checks + "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_imports_without_jax():
    """The port never imports JAX or the JAX package: with ``jax`` blocked
    in ``sys.modules`` every port module still imports."""
    _import_blocked(
        ["jax"],
        ["colaborativempc_tpu_torch.runtime",
         "colaborativempc_tpu_torch.runtime.plotting",
         "colaborativempc_tpu_torch.parallel",
         "colaborativempc_tpu_torch.parallel.multihost",
         "colaborativempc_tpu_torch.parallel.fleet",
         "colaborativempc_tpu_torch.parallel.ocd",
         "colaborativempc_tpu_torch.interop",
         "colaborativempc_tpu_torch.native",
         "colaborativempc_tpu_torch.ops._build",
         "colaborativempc_tpu_torch.utils.rollout"]
        + [f"colaborativempc_tpu_torch.scripts.{s}" for s in SCRIPTS],
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n")


def test_runtime_and_compute_scripts_import_without_matplotlib():
    """The card's machine has no matplotlib: the runtime (plotting module
    included) and every compute script import without it, and asking
    for plots fails before a run with a message naming ``--no-plot``."""
    _import_blocked(
        ["jax", "matplotlib"],
        ["colaborativempc_tpu_torch.runtime",
         "colaborativempc_tpu_torch.runtime.plotting"]
        + [f"colaborativempc_tpu_torch.scripts.{s}" for s in COMPUTE_SCRIPTS],
        "assert sys.modules['matplotlib'] is None\n"
        "from colaborativempc_tpu_torch.runtime import plotting\n"
        "try:\n"
        "    plotting.require_matplotlib('pass --no-plot')\n"
        "except RuntimeError as e:\n"
        "    assert '--no-plot' in str(e)\n"
        "else:\n"
        "    raise AssertionError('no error without matplotlib')\n")


def test_port_sources_never_import_jax():
    pkg = REPO / "colaborativempc_tpu_torch"
    for path in pkg.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")
                        or "colaborativempc_tpu." in s and "import" in s
                        and not s.startswith("#")), (path, line)
