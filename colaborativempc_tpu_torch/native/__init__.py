"""ctypes bindings to the repository's float64 C++ twin of the engine
(``native/``), for the PyTorch port.

The native library is the float64 host twin of the on-device engine — the
same stage-QP layout and the same Riccati+ADMM algorithm (``native/src``),
sharing no code with either Python package. The port uses it as an
independent float64 oracle: its planners' solutions on the card or the CPU
are held against it. It also drives the ``cmpc_sim`` closed-loop binary.

The functions have the names, argument order and return types of the JAX
package's bindings (``colaborativempc_tpu/native``): they take the port's
records (``Track``, ``Gains``, ``SysLimits``, ``ModelParams``,
``MPCCGains``, ``MPCCBounds``, ``PacejkaParams``), states as torch
tensors on any device or as numpy arrays, and return float64 numpy arrays.

Build: the C++ compiler (``$CXX``, else ``g++``) is called directly, with
the Release flags of ``native/CMakeLists.txt``, no cmake: each of the six
sources compiles to an object, all at once (one process each); five link
into ``libcmpc.so`` and ``main.cpp`` with the four planner and solver
sources into ``cmpc_sim``. Both go under ``colaborativempc_tpu_torch/
_build/``, named by a hash of the compiler, the flags, the sources and
the headers, and each is written under a temporary name and moved into
place with ``os.replace``, so processes building at once never load a
half-written file. Nothing is built at import: the first :func:`load`
builds. ``native/`` itself is only read. A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG.parent / "native"
BUILD_DIR = _PKG / "_build"
# CMAKE_CXX_FLAGS_RELEASE of native/CMakeLists.txt, its C++ standard and
# the position-independent code of its shared library
CXX_FLAGS = ("-O3", "-march=native", "-fno-math-errno", "-std=c++17",
             "-fPIC")
LIB_SOURCES = ("solver.cpp", "planner.cpp", "nl_planner.cpp",
               "mpcc_planner.cpp", "capi.cpp")
SIM_SOURCES = ("main.cpp", "solver.cpp", "planner.cpp", "nl_planner.cpp",
               "mpcc_planner.cpp")

_lib = None


def compiler() -> str:
    """The C++ compiler: ``$CXX``, else ``g++``."""
    return os.environ.get("CXX") or "g++"


def _outputs(build_dir: Path) -> tuple[Path, Path]:
    """The library's and the binary's paths: a hash of the compiler, the
    flags and every source and header names them."""
    h = hashlib.sha256(" ".join((compiler(),) + CXX_FLAGS).encode())
    files = sorted((NATIVE_DIR / "src").glob("*.cpp")) + sorted(
        (NATIVE_DIR / "include" / "cmpc").glob("*.h"))
    for f in files:
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    tag = h.hexdigest()[:16]
    return build_dir / f"libcmpc_{tag}.so", build_dir / f"cmpc_sim_{tag}"


def build(force: bool = False) -> str:
    """Build the native library and the sim binary into :data:`BUILD_DIR`
    if needed; returns the .so path."""
    lib, sim = _outputs(BUILD_DIR)
    if not force and lib.exists() and sim.exists():
        return str(lib)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    sources = dict.fromkeys(SIM_SOURCES + LIB_SOURCES)
    objs = {src: BUILD_DIR / f"{tag}.{Path(src).stem}.o" for src in sources}
    tmp_lib = BUILD_DIR / f"{tag}.tmp.so"
    tmp_sim = BUILD_DIR / f"{tag}.tmp.sim"
    cxx = compiler()
    include = str(NATIVE_DIR / "include")
    try:
        procs = {src: subprocess.Popen(
            [cxx, *CXX_FLAGS, "-I", include, "-c", "-o", str(obj),
             str(NATIVE_DIR / "src" / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in objs.items()}
        logs = {src: proc.communicate()[0] for src, proc in procs.items()}
        failed = [src for src, proc in procs.items() if proc.returncode]
        if not failed:
            for name, out, srcs, extra in (
                    ("libcmpc.so", tmp_lib, LIB_SOURCES, ("-shared",)),
                    ("cmpc_sim", tmp_sim, SIM_SOURCES, ())):
                link = subprocess.run(
                    [cxx, *CXX_FLAGS, *extra, "-o", str(out),
                     *(str(objs[s]) for s in srcs)],
                    capture_output=True, text=True)
                logs[name] = link.stdout + link.stderr
                if link.returncode:
                    failed = [name]
                    break
        if failed:
            log = "".join(f"== {k}\n{v}" for k, v in logs.items())
            raise RuntimeError(
                f"{cxx} failed ({', '.join(failed)}):\n{log}")
        # the binary first: a library in place means both are
        os.replace(tmp_sim, sim)
        os.replace(tmp_lib, lib)
    finally:
        for p in (*objs.values(), tmp_lib, tmp_sim):
            p.unlink(missing_ok=True)
    return str(lib)


def sim_binary() -> str:
    """The ``cmpc_sim`` closed-loop binary's path (built if needed)."""
    build()
    return str(_outputs(BUILD_DIR)[1])


def available() -> bool:
    try:
        load()
        return True
    except Exception:  # noqa: BLE001
        return False


def load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.cmpc_lpv_solve_dt.restype = ctypes.c_int
        lib.cmpc_lpv_solve_dt.argtypes = [
            ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            dp, ctypes.c_double, ctypes.c_int,
            dp, dp, dp, dp, dp, dp, dp, dp,
            ctypes.c_int, ctypes.c_double, ctypes.c_double,
            dp, dp, dp,
        ]
        lib.cmpc_nl_solve_dt.restype = ctypes.c_int
        lib.cmpc_nl_solve_dt.argtypes = [
            ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            dp, ctypes.c_double, ctypes.c_int,
            dp, dp, dp, dp, dp, dp, ip, dp, dp, dp,
            ctypes.c_int, ctypes.c_double, ctypes.c_int, dp,
        ]
        lib.cmpc_mpcc_solve_dt.restype = ctypes.c_int
        lib.cmpc_mpcc_solve_dt.argtypes = [
            ctypes.c_int, ctypes.c_double, ctypes.c_int,
            dp, ctypes.c_double, ctypes.c_int,
            dp, dp, dp, dp, dp, dp, dp,
            ctypes.c_int, ctypes.c_double, ctypes.c_int, dp,
        ]
        lib.cmpc_mpcc_race.restype = ctypes.c_int
        lib.cmpc_mpcc_race.argtypes = [
            ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            dp, ctypes.c_double, ctypes.c_int,
            dp, dp, dp,
            ctypes.c_double, ctypes.c_int, ctypes.c_double, ctypes.c_int,
            dp, dp, ip,
        ]
        lib.cmpc_step_rk4.restype = None
        lib.cmpc_step_rk4.argtypes = [
            ctypes.c_int, dp, ctypes.c_double, ctypes.c_int,
            dp, dp, ctypes.c_double, dp,
        ]
        lib.cmpc_sep_filter.restype = None
        lib.cmpc_sep_filter.argtypes = [
            ctypes.c_int, dp, dp, dp, ctypes.c_double, dp,
        ]
        _lib = lib
    return _lib


def _host(a, dtype=np.float64) -> np.ndarray:
    """A tensor on any device (``.detach().cpu()``, floats through
    ``.double()``) or an array-like, as a contiguous numpy array of
    ``dtype``."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        a = (a.double() if a.is_floating_point() else a).numpy()
    return np.ascontiguousarray(np.asarray(a, dtype))


def track_table(track, lane: int = 0) -> tuple[np.ndarray, float, int]:
    """Flatten a port ``Track`` into the (n_seg, 7) native table."""
    seg = np.stack([
        _host(track.x0[lane]), _host(track.y0[lane]),
        _host(track.psi0[lane]),
        np.nan_to_num(_host(track.s0[lane]), posinf=1e12),
        _host(track.length[lane]), _host(track.curv[lane]),
        _host(track.halfwidth[lane]),
    ], axis=-1)
    return (np.ascontiguousarray(seg), float(track.track_length[lane]),
            int(bool(track.open_flag)))


def export_track_csv(track, path: str, lane: int = 0):
    """Write the native sim binary's track CSV."""
    seg, length, open_flag = track_table(track, lane)
    with open(path, "w") as f:
        f.write("# x0 y0 psi0 s0 len curv hw\n")
        for row in seg:
            f.write(" ".join(f"{v:.12g}" for v in row) + "\n")
        f.write(f"length {length:.12g} {open_flag}\n")


def _cptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _packs(gains, limits, model):
    """The native gains (17), limits (9) and model (7) vectors."""
    g = np.concatenate([_host(gains.q), _host(gains.qs), _host(gains.r),
                        _host(gains.dr), [float(gains.wq)]])
    lim = np.asarray([float(v) for v in (
        limits.vx_ref, limits.min_dist, limits.max_vel, limits.min_vel,
        limits.max_rs, limits.max_ls, limits.max_ac, limits.max_dc,
        limits.sm)], np.float64)
    mp = np.asarray([float(v) for v in (
        model.lf, model.lr, model.m, model.I, model.Cf, model.Cr,
        model.mu)], np.float64)
    return g, lim, mp


def nl_solve_native(track, gains, limits, model, N: int, dt: float,
                    x0, x_bar, u_bar, u_old, lambdas, neigh_xy, master,
                    sqp_iters: int = 2, mix: float = 0.7,
                    admm_iters: int = 300):
    """Native counterpart of planners.nl.nl_solve (coupling='eu') for one
    problem.

    lambdas: (n_nb, N); neigh_xy: (N, n_nb, 2) stage-aligned (stages 1..N);
    master: (n_nb,) ints. Returns (feasible, x_pred, u_pred, residuals)."""
    lib = load()
    seg, length, open_flag = track_table(track)
    n_nb = int(neigh_xy.shape[1])
    x_bar = _host(x_bar).copy()
    u_bar = _host(u_bar).copy()
    x0, u_old = _host(x0), _host(u_old)
    neigh, lam = _host(neigh_xy), _host(lambdas)
    mast = _host(master, np.int32)
    g, lim, mp = _packs(gains, limits, model)
    resid = np.zeros(3)
    ok = lib.cmpc_nl_solve_dt(
        N, dt, n_nb, seg.shape[0], _cptr(seg), length, open_flag,
        _cptr(x_bar), _cptr(u_bar), _cptr(x0), _cptr(u_old), _cptr(neigh),
        _cptr(lam), mast.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        _cptr(g), _cptr(lim), _cptr(mp),
        sqp_iters, mix, admm_iters, _cptr(resid))
    return bool(ok), x_bar, u_bar, resid


def lpv_solve_native(track, gains, limits, model, N: int, dt: float,
                     x0, x_lin, u_lin, u_old,
                     neighbours_xy: Optional[np.ndarray] = None,
                     iters: int = 600, rho: float = 10.0,
                     eps: float = 1e-6):
    """Native counterpart of planners.lpv.lpv_solve for one problem
    (float64): x0 (9,), x_lin (N+1, 9), u_lin (N, 2), u_old (2,),
    neighbours_xy (N+1, n_nb, 2) or None.

    Returns (feasible, x_pred (N+1, 9), u_pred (N, 2), residuals[3])."""
    lib = load()
    seg, length, open_flag = track_table(track)
    n_nb = 0 if neighbours_xy is None else int(neighbours_xy.shape[1])
    # native expects N+1 stage rows (planes from 0..N-1, weights from 1..N)
    neigh = (np.zeros((N + 1, 1, 2)) if neighbours_xy is None
             else np.ascontiguousarray(_host(neighbours_xy)[:N + 1]))
    g, lim, mp = _packs(gains, limits, model)
    x_lin, u_lin = _host(x_lin), _host(u_lin)
    x0, u_old = _host(x0), _host(u_old)
    x_out = np.zeros((N + 1, 9))
    u_out = np.zeros((N, 2))
    resid = np.zeros(3)
    ok = lib.cmpc_lpv_solve_dt(
        N, dt, n_nb, seg.shape[0], _cptr(seg), length, open_flag,
        _cptr(x_lin), _cptr(u_lin), _cptr(x0), _cptr(u_old), _cptr(neigh),
        _cptr(g), _cptr(lim), _cptr(mp), iters, rho, eps,
        _cptr(x_out), _cptr(u_out), _cptr(resid))
    return bool(ok), x_out, u_out, resid


def _mpcc_packs(gains, bounds, model):
    g = np.asarray([float(v) for v in (
        gains.q_progress, gains.q_contour, gains.q_heading, gains.q_vy,
        gains.q_wz, gains.r_delta, gains.r_drive, gains.dr_delta,
        gains.dr_drive, gains.w_soft)], np.float64)
    b = np.asarray([float(v) for v in (
        bounds.delta_max, bounds.drive_min, bounds.drive_max,
        bounds.trust_delta, bounds.trust_drive, bounds.vx_min)], np.float64)
    mp = np.asarray([float(v) for v in (
        model.m, model.I, model.lf, model.lr, model.Bf, model.Cf, model.Df,
        model.Br, model.Cr, model.Dr, model.Cm1, model.Cm2, model.Cr0,
        model.Cr2, model.p_long, model.p_ell, model.max_alpha)], np.float64)
    return g, b, mp


def mpcc_solve_native(track, gains, bounds, model, N: int, dt: float,
                      x0, x_bar, u_bar, u_old,
                      sqp_iters: int = 3, mix: float = 0.7,
                      admm_iters: int = 300):
    """Native counterpart of planners.mpcc.mpcc_solve for one race
    (float64, raw variables — no normalisation needed). Returns (feasible,
    x_pred, u_pred, residuals[3])."""
    lib = load()
    seg, length, open_flag = track_table(track)
    x_bar = _host(x_bar).copy()
    u_bar = _host(u_bar).copy()
    x0, u_old = _host(x0), _host(u_old)
    g, b, mp = _mpcc_packs(gains, bounds, model)
    resid = np.zeros(3)
    ok = lib.cmpc_mpcc_solve_dt(
        N, dt, seg.shape[0], _cptr(seg), length, open_flag,
        _cptr(x_bar), _cptr(u_bar), _cptr(x0), _cptr(u_old),
        _cptr(g), _cptr(b), _cptr(mp), sqp_iters, mix, admm_iters,
        _cptr(resid))
    return bool(ok), x_bar, u_bar, resid


def mpcc_race_native(track, gains, bounds, model, N: int, dt: float,
                     steps: int, v0: float = 0.5, n_sqp: int = 3,
                     mix: float = 0.7, admm_iters: int = 300):
    """Native closed-loop race (runtime/racing.py run_mpcc_experiment twin;
    reference main.cpp:30-86). Returns (steps_done, states (T, 9),
    inputs (T, 2), feasible (T,))."""
    lib = load()
    seg, length, open_flag = track_table(track)
    g, b, mp = _mpcc_packs(gains, bounds, model)
    x_hist = np.zeros((steps, 9))
    u_hist = np.zeros((steps, 2))
    feas = np.zeros(steps, np.int32)
    t = lib.cmpc_mpcc_race(
        N, dt, steps, seg.shape[0], _cptr(seg), length, open_flag,
        _cptr(g), _cptr(b), _cptr(mp), v0, n_sqp, mix, admm_iters,
        _cptr(x_hist), _cptr(u_hist),
        feas.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return int(t), x_hist[:t], u_hist[:t], feas[:t].astype(bool)


def sep_filter_native(p0, p1, prio, floor: float) -> np.ndarray:
    """Executed-separation safety-filter betas (native/include/cmpc/
    safety.h) — float64 twin of runtime/simulate.py _sep_filter_beta.
    ``p0``/``p1``: (n, 2) current/candidate positions; ``prio``: (n,)
    arc progress. Returns (n,) advance fractions."""
    lib = load()
    p0, p1, prio = _host(p0), _host(p1), _host(prio)
    beta = np.zeros(p0.shape[0])
    lib.cmpc_sep_filter(p0.shape[0], _cptr(p0), _cptr(p1), _cptr(prio),
                        float(floor), _cptr(beta))
    return beta
