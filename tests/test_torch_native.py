"""The port's bindings to the C++ float64 twin (``colaborativempc_tpu_torch/
native``) against the JAX package's bindings, and the port's planners,
runners and RK4 rollout against the twin.

- ``track_table`` and ``export_track_csv`` of the port's tracks equal the
  JAX binding's on the JAX tracks, bit for bit and byte for byte.
- The port's library (built by the port with the compiler and the CMake
  Release flags) and the JAX binding's (built by cmake) return identical
  bits for the same LPV, NL, MPCC, race, RK4 and safety-filter inputs.
- Each case of tests/test_native.py, mirrored on the port's planners on
  the CPU, at that file's tolerances: LPV 3e-3 (one agent) and 5e-3
  (three agents, a fitted track), RK4 2e-3, NL 1e-2, MPCC 5e-3, the
  race's progress within 2%, the filter 2e-3.
- The build: two processes building at once into one empty directory
  both load a working library; ``native/`` is only read; a failed
  compile raises with the compiler's output.

Inputs are made from seeds with numpy (``default_rng``), as in
tests/test_native.py.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colaborativempc_tpu import native as jnative
from colaborativempc_tpu.config import (
    lpv_gains as j_lpv_gains, nl_gains as j_nl_gains,
    ModelParams as JModelParams, SysLimits as JSysLimits,
    x0_database as j_x0_database,
)
from colaborativempc_tpu.dynamics import PacejkaParams as JPacejkaParams
from colaborativempc_tpu.geometry import make_track as j_make_track
from colaborativempc_tpu.geometry.spline import (
    fit_centerline as j_fit_centerline,
)
from colaborativempc_tpu.planners.mpcc import (
    MPCCBounds as JMPCCBounds, MPCCGains as JMPCCGains,
)
from colaborativempc_tpu.utils import (
    initialise_agents as j_initialise_agents,
)

from colaborativempc_tpu_torch import native
from colaborativempc_tpu_torch.config import (
    lpv_gains, nl_gains, ModelParams, SysLimits, x0_database,
)
from colaborativempc_tpu_torch.dynamics.pacejka import PacejkaParams
from colaborativempc_tpu_torch.geometry import (
    frenet_to_cartesian, make_track,
)
from colaborativempc_tpu_torch.geometry.spline import fit_centerline
from colaborativempc_tpu_torch.geometry.tracks import _specs
from colaborativempc_tpu_torch.planners.lpv import lpv_solve
from colaborativempc_tpu_torch.planners.mpcc import (
    MPCCBounds, MPCCConfig, MPCCGains, mpcc_solve,
)
from colaborativempc_tpu_torch.planners.nl import nl_solve
from colaborativempc_tpu_torch.runtime.racing import run_mpcc_experiment
from colaborativempc_tpu_torch.runtime.simulate import _sep_filter_beta
from colaborativempc_tpu_torch.utils.rollout import rollout_rk4
from colaborativempc_tpu_torch.utils.warmstart import initialise_agents

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
F32 = torch.float32
TRACKS = tuple(_specs())


@pytest.fixture(autouse=True, scope="module")
def _native_available():
    if not native.available():
        pytest.skip("native toolchain unavailable")


def centerline():
    """tests/test_native.py's recorded drive: 160 points of the oval's
    centerline (from the port's float64 table) with noise (seed 7)."""
    ref = make_track("oval", device="cpu", dtype=torch.float64)
    s = np.linspace(0.0, float(ref.track_length[0]) - 1e-3, 160)
    xs, ys, _ = frenet_to_cartesian(ref, torch.tensor(s),
                                    torch.zeros(len(s), dtype=torch.float64))
    rng = np.random.default_rng(7)
    return (xs.numpy() + rng.normal(size=len(s)) * 0.003,
            ys.numpy() + rng.normal(size=len(s)) * 0.003)


def tracks(name):
    """(JAX track, port track) of a named track or ``"fitted"``."""
    if name == "fitted":
        xs, ys = centerline()
        kw = dict(halfwidth=0.5, closed=True, n_segments=400)
        return (j_fit_centerline(xs, ys, **kw),
                fit_centerline(xs, ys, device="cpu", **kw))
    return j_make_track(name), make_track(name, device="cpu")


def warm_start(track, n_agents, N, dt):
    """The port's warm start of ``x0_database(n_agents)`` in float32:
    ``agents_xy (N+1, n, 2)``, ``x_pred (n, N+1, 9)``, ``u_pred``."""
    x0s = torch.tensor(x0_database(n_agents), dtype=F32)
    return initialise_agents(track, x0s, N, dt)


def lpv_case(name):
    """(track, N, dt, x0 (9,), x_lin, u_lin, neighbours (N+1, n_nb, 2) or
    None, tolerance on x, tolerance on u or None) of each LPV case of
    tests/test_native.py, on the port's CPU tensors."""
    n_agents, track_name, N, tol_x, tol_u = {
        "single": (1, "oval", 15, 3e-3, 3e-3),
        "multi": (3, "Highway", 12, 5e-3, None),
        "fitted": (1, "fitted", 12, 5e-3, None)}[name]
    track = tracks(track_name)[1]
    dt = 0.025
    agents_xy, x_pred, u_pred = warm_start(track, n_agents, N, dt)
    neigh = agents_xy[:, 1:].double() if n_agents > 1 else None
    return track, N, dt, x_pred[0, 0], x_pred[0], u_pred[0], neigh, \
        tol_x, tol_u


def mpcc_inputs(N=16, dt=0.05):
    """tests/test_native.py's MPCC solve inputs: standing at 0.6 m/s on
    oval_mt, the guess advancing at that speed with 0.25 duty."""
    x = np.zeros(9, np.float32)
    x[0] = 0.6
    x_bar = np.stack([x] * (N + 1))
    x_bar[:, 6] = np.arange(N + 1, dtype=np.float32) * np.float32(0.6 * dt)
    u_bar = np.zeros((N, 2), np.float32)
    u_bar[:, 1] = 0.25
    return x, x_bar, u_bar, np.zeros(2, np.float32)


def sep_fleets(n_fleets=100, seed=11):
    """tests/test_native.py's random fleets: (p0, p1, prio) of 2-5
    agents each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_fleets):
        n = int(rng.integers(2, 6))
        p0 = rng.uniform(-2.0, 2.0, (n, 2))
        p1 = p0 + rng.uniform(-0.2, 0.2, (n, 2))
        out.append((p0, p1, rng.uniform(0.0, 30.0, n)))
    return out


def rk4_native(binding, track, x, u, dt, steps, mp):
    lib = binding.load()
    seg, length, open_flag = binding.track_table(track)
    x = np.asarray(x, np.float64).copy()
    m = np.asarray([mp.lf, mp.lr, mp.m, mp.I, mp.Cf, mp.Cr, mp.mu])
    for _ in range(steps):
        lib.cmpc_step_rk4(seg.shape[0], binding._cptr(seg), length,
                          open_flag, binding._cptr(x), binding._cptr(u), dt,
                          binding._cptr(m))
    return x


# ---------------------------------------------------------------------------
# the bindings: the port's against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TRACKS + ("fitted",))
def test_track_table_and_csv_match_jax(name, tmp_path):
    jt, tt = tracks(name)
    for lane in range(tt.n_lanes):
        jseg, jlen, jopen = jnative.track_table(jt, lane)
        seg, length, open_flag = native.track_table(tt, lane)
        assert seg.dtype == np.float64 and seg.flags.c_contiguous
        np.testing.assert_array_equal(seg, jseg)
        assert (length, open_flag) == (jlen, jopen)
        jnative.export_track_csv(jt, str(tmp_path / "j.csv"), lane)
        native.export_track_csv(tt, str(tmp_path / "t.csv"), lane)
        assert ((tmp_path / "t.csv").read_bytes()
                == (tmp_path / "j.csv").read_bytes())


def _same(a, b):
    """Every output of one binding's call equal in its bits to the
    other's."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def _jax_warm_start(track, n_agents, N, dt):
    x0s = jnp.asarray(j_x0_database(n_agents), jnp.float32)
    return [np.asarray(a) for a in j_initialise_agents(track, x0s, N, dt)]


def _lib_lpv():
    jt, tt = tracks("Highway")
    N, dt = 12, 0.025
    agents_xy, x_pred, u_pred = _jax_warm_start(jt, 3, N, dt)
    neigh = np.asarray(agents_xy[:, [1, 2], :], np.float64)
    args = (N, dt, x_pred[0][0], x_pred[0], u_pred[0], np.zeros(2))
    ref = jnative.lpv_solve_native(jt, j_lpv_gains(), JSysLimits(),
                                   JModelParams(), *args,
                                   neighbours_xy=neigh)
    got = native.lpv_solve_native(
        tt, lpv_gains(), SysLimits(), ModelParams(), N, dt,
        *(torch.from_numpy(a) for a in args[2:]),
        neighbours_xy=torch.from_numpy(neigh))
    return got, ref


def _lib_nl():
    jt, tt = tracks("Highway")
    N, dt = 12, 0.02
    agents_xy, x_pred, u_pred = _jax_warm_start(jt, 3, N, dt)
    neigh = np.asarray(agents_xy[1:, [0, 2], :], np.float64)
    lam = np.full((2, N), 0.3)
    master = np.array([0, 1], np.int32)
    args = (N, dt, x_pred[1][0], x_pred[1], u_pred[1], np.zeros(2), lam,
            neigh, master)
    kw = dict(sqp_iters=2, mix=0.7, admm_iters=400)
    ref = jnative.nl_solve_native(jt, j_nl_gains(), JSysLimits(),
                                  JModelParams(), *args, **kw)
    got = native.nl_solve_native(
        tt, nl_gains(), SysLimits(), ModelParams(), N, dt,
        *(torch.from_numpy(a) for a in args[2:]), **kw)
    return got, ref


def _lib_mpcc():
    jt, tt = tracks("oval_mt")
    args = (16, 0.05) + mpcc_inputs()
    kw = dict(sqp_iters=3, mix=0.7, admm_iters=300)
    ref = jnative.mpcc_solve_native(jt, JMPCCGains(), JMPCCBounds(),
                                    JPacejkaParams(), *args, **kw)
    got = native.mpcc_solve_native(
        tt, MPCCGains(), MPCCBounds(), PacejkaParams(), *args[:2],
        *(torch.from_numpy(a) for a in args[2:]), **kw)
    return got, ref


def _lib_race():
    jt, tt = tracks("oval_mt")
    kw = dict(N=16, dt=0.05, steps=30, v0=0.5, n_sqp=3, mix=0.7,
              admm_iters=300)
    ref = jnative.mpcc_race_native(jt, JMPCCGains(), JMPCCBounds(),
                                   JPacejkaParams(), **kw)
    got = native.mpcc_race_native(tt, MPCCGains(), MPCCBounds(),
                                  PacejkaParams(), **kw)
    return got, ref


def _lib_rk4():
    jt, tt = tracks("oval")
    x0 = _jax_warm_start(jt, 1, 10, 0.02)[1][0][0]
    u = np.asarray([0.05, 1.0])
    ref = rk4_native(jnative, jt, x0, u, 0.02, 20, JModelParams())
    got = rk4_native(native, tt, x0, u, 0.02, 20, ModelParams())
    return (got,), (ref,)


def _lib_sep():
    got, ref = [], []
    for p0, p1, prio in sep_fleets():
        ref.append(jnative.sep_filter_native(p0, p1, prio, 0.175))
        got.append(native.sep_filter_native(
            torch.from_numpy(p0), torch.from_numpy(p1),
            torch.from_numpy(prio), 0.175))
    return got, ref


@pytest.mark.parametrize("case", ["lpv", "nl", "mpcc", "race", "rk4",
                                  "sep_filter"])
def test_library_matches_jax_binding_bits(case):
    """The port's library and the JAX binding's, each through its own
    binding (the port's fed torch tensors), return identical bits."""
    if not jnative.available():
        pytest.skip("the JAX binding's cmake build is unavailable")
    got, ref = {"lpv": _lib_lpv, "nl": _lib_nl, "mpcc": _lib_mpcc,
                "race": _lib_race, "rk4": _lib_rk4,
                "sep_filter": _lib_sep}[case]()
    _same(got, ref)


# ---------------------------------------------------------------------------
# the port's planners against the oracle (tests/test_native.py mirrored)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["single", "multi", "fitted"])
def test_port_lpv_matches_native(name):
    track, N, dt, x0, x_lin, u_lin, neigh, tol_x, tol_u = lpv_case(name)
    sol = lpv_solve(track, lpv_gains(), SysLimits(), ModelParams(), N, dt,
                    x0[None], x_lin[None], u_lin[None], torch.zeros(1, 2),
                    None if neigh is None else neigh[None].to(F32),
                    admm_iters=600, eps=1e-6)
    ok, x_nat, u_nat, _ = native.lpv_solve_native(
        track, lpv_gains(), SysLimits(), ModelParams(), N, dt, x0, x_lin,
        u_lin, np.zeros(2), neighbours_xy=neigh)
    assert ok and bool(sol.feasible[0])
    err_x = np.abs(x_nat - sol.x_pred[0].double().numpy()).max()
    assert err_x < tol_x, err_x
    if tol_u is not None:
        err_u = np.abs(u_nat - sol.u_pred[0].double().numpy()).max()
        assert err_u < tol_u, err_u


def test_port_rk4_matches_native():
    track = make_track("oval", device="cpu")
    x0 = warm_start(track, 1, 10, 0.02)[1][0, 0]
    u = np.asarray([0.05, 1.0])
    x = rk4_native(native, track, x0.double().numpy(), u, 0.02, 20,
                   ModelParams())
    xt = rollout_rk4(track, x0, torch.tensor(u, dtype=F32).repeat(20, 1),
                     0.02)[-1]
    err = np.abs(x - xt.double().numpy()).max()
    assert err < 2e-3, err


def test_port_nl_matches_native():
    """Euclidean coupling, mixed roles: ego = agent 1, master towards 2,
    slave towards 0."""
    track = make_track("Highway", device="cpu")
    N, dt = 12, 0.02
    agents_xy, x_pred, u_pred = warm_start(track, 3, N, dt)
    neigh = agents_xy[:, [0, 2], :]
    master = np.array([0, 1], np.int32)
    lam = np.full((2, N), 0.3)
    sol = nl_solve(track, nl_gains(), SysLimits(), ModelParams(), N, dt,
                   x_pred[1:2, 0], x_pred[1:2], u_pred[1:2],
                   torch.zeros(1, 2), torch.tensor(lam, dtype=F32)[None],
                   neigh[None], torch.tensor(master, dtype=F32)[None],
                   sqp_iters=2, sqp_mix=0.7, admm_iters=400, eps=1e-6)
    ok, x_nat, u_nat, _ = native.nl_solve_native(
        track, nl_gains(), SysLimits(), ModelParams(), N, dt, x_pred[1, 0],
        x_pred[1], u_pred[1], np.zeros(2), lam, neigh[1:], master,
        sqp_iters=2, mix=0.7, admm_iters=400)
    assert ok and bool(sol.feasible[0])
    err_x = np.abs(x_nat - sol.x_pred[0].double().numpy()).max()
    err_u = np.abs(u_nat - sol.u_pred[0].double().numpy()).max()
    assert err_x < 1e-2, err_x
    assert err_u < 1e-2, err_u


def test_port_mpcc_solve_matches_native():
    track = make_track("oval_mt", device="cpu")
    N, dt = 16, 0.05
    x, x_bar, u_bar, u_old = mpcc_inputs(N, dt)
    sol = mpcc_solve(track, MPCCGains(), PacejkaParams(), N, dt,
                     *(torch.from_numpy(a)[None]
                       for a in (x, x_bar, u_bar, u_old)),
                     sqp_iters=3, sqp_mix=0.7, admm_iters=300,
                     bounds=MPCCBounds(), norm=None)
    ok, x_nat, u_nat, _ = native.mpcc_solve_native(
        track, MPCCGains(), MPCCBounds(), PacejkaParams(), N, dt, x, x_bar,
        u_bar, u_old, sqp_iters=3, mix=0.7, admm_iters=300)
    assert ok and bool(sol.feasible[0])
    err_x = np.abs(sol.x_pred[0].double().numpy() - x_nat).max()
    err_u = np.abs(sol.u_pred[0].double().numpy() - u_nat).max()
    assert err_x <= 5e-3, err_x
    assert err_u <= 5e-3, err_u


def test_port_mpcc_race_matches_native():
    """The native closed-loop race and the port's ``run_mpcc_experiment``
    on the CPU: the same steps, both feasible throughout, progress within
    2%, the corridor held."""
    track = make_track("oval_mt", device="cpu")
    N, dt, steps = 16, 0.05, 50
    cfg = MPCCConfig(N=N, dt=dt, n_sim=steps, map_type="oval_mt",
                     initial_velocity=0.5, verb=0)
    res = run_mpcc_experiment(cfg, track=track, device="cpu")
    t, xs, _, feas = native.mpcc_race_native(
        track, MPCCGains(), MPCCBounds(), PacejkaParams(), N=N, dt=dt,
        steps=steps, v0=0.5, n_sqp=cfg.n_sqp, mix=cfg.sqp_mixing,
        admm_iters=300)
    assert t == steps == res.steps
    assert feas.all() and res.feasible.all()
    s_port, s_nat = float(res.states[-1, 6]), float(xs[-1, 6])
    assert abs(s_port - s_nat) < 0.02 * max(s_port, 1.0), (s_port, s_nat)
    assert np.abs(xs[:, 3]).max() < 0.25


def test_port_sep_filter_matches_native():
    """The native betas equal the port's ``_sep_filter_beta`` (float32,
    CPU) on random fleets, and both honour the non-worsening floor."""
    floor = 0.175
    for p0, p1, prio in sep_fleets():
        n = p0.shape[0]
        b_nat = native.sep_filter_native(p0, p1, prio, floor)
        b_port = _sep_filter_beta(
            torch.tensor(p0, dtype=F32), torch.tensor(p1, dtype=F32),
            torch.tensor(floor, dtype=F32),
            prio=torch.tensor(prio, dtype=F32)).double().numpy()
        assert np.allclose(b_nat, b_port, atol=2e-3), (b_nat, b_port)
        for b in (b_nat, b_port):
            p = p0 + b[:, None] * (p1 - p0)
            d = np.linalg.norm(p[:, None] - p[None, :], axis=-1) \
                + np.eye(n) * 1e9
            d0 = np.linalg.norm(p0[:, None] - p0[None, :], axis=-1) \
                + np.eye(n) * 1e9
            assert (d >= np.minimum(floor, d0) - 1e-6).all()


SIM_RUNS = {
    # mode: (track, argv after the CSV, expected lines)
    "lpv": ("Highway", ["3", "15", "30", "0.025"],
            ["feasible=1", "solve time"]),
    "nl": ("Highway", ["3", "15", "25", "0.02", "400", "nl"],
           ["feasible=1", "mean_ocd_it="]),
    "mpcc": ("oval_mt", ["1", "12", "30", "0.05", "300", "mpcc"],
             ["mpcc: steps=30", "feasible=30/30"]),
}


@pytest.mark.parametrize("mode", list(SIM_RUNS))
def test_port_sim_binary(mode, tmp_path):
    """The port's ``cmpc_sim`` on the port's exported track CSV: the
    three modes of tests/test_native.py's binary runs, with their
    checks (the NL-OCD loop's final separation above 0.2 m and its mean
    coordination depth below 15)."""
    name, argv, expect = SIM_RUNS[mode]
    csv = str(tmp_path / "track.csv")
    native.export_track_csv(make_track(name, device="cpu"), csv)
    out = subprocess.run([native.sim_binary(), csv, *argv],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    for line in expect:
        assert line in out.stdout, out.stdout
    if mode == "nl":
        dist = float(out.stdout.split("final_min_dist=")[1].split()[0])
        ocd = float(out.stdout.split("mean_ocd_it=")[1].split()[0])
        assert dist > 0.2 and ocd < 15, out.stdout


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

_BUILD_AND_SOLVE = """
import sys
sys.modules['jax'] = None
sys.modules['colaborativempc_tpu'] = None
from pathlib import Path
import numpy as np
from colaborativempc_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
p0 = np.array([[0.0, 0.0], [0.3, 0.0], [0.0, 0.4]])
p1 = p0 + np.array([[0.1, 0.0], [-0.1, 0.0], [0.0, -0.2]])
beta = native.sep_filter_native(p0, p1, np.array([1.0, 2.0, 3.0]), 0.175)
assert not any(v is not None and (m in ('jax', 'colaborativempc_tpu') or
               m.startswith(('jax.', 'colaborativempc_tpu.')))
               for m, v in sys.modules.items())
print(native.build(), ' '.join(repr(float(b)) for b in beta))
"""


def test_concurrent_builds_load_a_working_library(tmp_path):
    """Two processes (JAX and the JAX package blocked) build into one
    empty directory at once: both load the library and get the same
    betas as this process; the directory then holds the library and the
    binary only."""
    out_dir = tmp_path / "_build"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_SOLVE,
                               str(out_dir)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se
    p0 = np.array([[0.0, 0.0], [0.3, 0.0], [0.0, 0.4]])
    p1 = p0 + np.array([[0.1, 0.0], [-0.1, 0.0], [0.0, -0.2]])
    want = native.sep_filter_native(p0, p1, np.array([1.0, 2.0, 3.0]),
                                    0.175)
    lib_path = {so.split()[0] for so, _ in outs}
    assert len(lib_path) == 1
    for so, _ in outs:
        assert [float(b) for b in so.split()[1:]] == want.tolist()
    lib, sim = native._outputs(out_dir)
    assert lib_path == {str(lib)}
    assert sorted(p.name for p in out_dir.iterdir()) == sorted(
        [lib.name, sim.name])


def _copy_native(tmp_path):
    src = tmp_path / "native"
    for sub in ("src", "include"):
        shutil.copytree(REPO / "native" / sub, src / sub)
    return src


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_build_only_reads_native_tree(tmp_path, monkeypatch):
    """Built from a copy of ``native/src`` and ``native/include``, the
    library and the binary land in the build directory, with the CMake
    Release flags; the copy is left as it was (no ``build/`` beside it).
    The default build directory is the port's own ``_build/``."""
    assert native.BUILD_DIR == REPO / "colaborativempc_tpu_torch" / "_build"
    assert native.CXX_FLAGS == ("-O3", "-march=native", "-fno-math-errno",
                                "-std=c++17", "-fPIC")
    src = _copy_native(tmp_path)
    before = _tree(src)
    out_dir = tmp_path / "out"
    monkeypatch.setattr(native, "NATIVE_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", out_dir)
    lib = native.build(force=True)
    assert _tree(src) == before
    assert not (src / "build").exists()
    assert Path(lib) == native._outputs(out_dir)[0]
    assert sorted(p.name for p in out_dir.iterdir()) == sorted(
        p.name for p in native._outputs(out_dir))


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    src = _copy_native(tmp_path)
    capi = src / "src" / "capi.cpp"
    capi.write_text(capi.read_text() + "\nthis is not C++;\n")
    out_dir = tmp_path / "out"
    monkeypatch.setattr(native, "NATIVE_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", out_dir)
    with pytest.raises(RuntimeError, match=r"capi\.cpp[\s\S]*error"):
        native.build(force=True)
    assert list(out_dir.iterdir()) == []
