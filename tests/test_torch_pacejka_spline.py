"""Parity of the PyTorch port's racing model with the JAX package: the
Pacejka tire model, its Jacobians (``torch.func.jacfwd`` against
``jax.jacfwd``), the host-side spline fit of a measured centerline into a
``Track`` table, and the batched Newton projection onto it.

Seeded numpy inputs go through both packages on the CPU, the JAX side in
float64 inside ``x64_island``. Tolerances: 1e-9 in float64 (relative to
each array's scale where the yaw row's 1/I = 3.6e4 enters), 1e-3 in
float32; the host fit is the same float64 numpy/scipy code on both sides,
1e-12.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colaborativempc_tpu.dynamics import pacejka as jpac
from colaborativempc_tpu.geometry import frenet_to_cartesian as j_f2c
from colaborativempc_tpu.geometry import make_track as j_make_track
from colaborativempc_tpu.geometry import spline as jspl
from colaborativempc_tpu.utils.precision import x64_island

from colaborativempc_tpu_torch import interop
from colaborativempc_tpu_torch.dynamics import pacejka as tpac
from colaborativempc_tpu_torch.geometry import spline as tspl

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
JP, TP = jpac.PacejkaParams(), tpac.PacejkaParams()


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol)


def jdtype(dtype):
    return jnp.float64 if dtype == F64 else jnp.float32


def random_xu(rng, shape=(3, 6)):
    """Random states and inputs in the racing range (vx around the 0.3
    guard, one point exactly on it)."""
    x = rng.normal(size=shape + (9,)) * 0.3
    x[..., 0] = np.abs(x[..., 0]) * 3.0 + 0.05
    x.reshape(-1, 9)[0, 0] = 0.3
    u = np.stack([rng.uniform(-0.35, 0.35, shape),
                  rng.uniform(-0.1, 1.0, shape)], -1)
    return x, u, rng.normal(size=shape) * 0.4


def vmap2(f):
    return jax.vmap(jax.vmap(f))


def tracks(name="oval_mt", dtype=F64):
    with x64_island():
        jt = j_make_track(name, dtype=jdtype(dtype))
    return jt, interop.track_from_numpy(jt, dtype=dtype, device="cpu")


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-9), (F32, 1e-3)])
def test_pacejka_functions_match_jax(dtype, tol):
    x, u, k = random_xu(np.random.default_rng(0))
    with x64_island():
        a = [jnp.asarray(v, jdtype(dtype)) for v in (x, u, k)]
        ref = dict(
            slip=vmap2(lambda x, u: jnp.stack(jpac.slip_angles(x, u, JP)))(
                *a[:2]),
            forces=vmap2(lambda x, u: jnp.stack(jpac.tire_forces(x, u, JP)))(
                *a[:2]),
            f=vmap2(lambda x, u, k: jpac.f_continuous_pacejka(x, u, k, JP))(
                *a),
            fe=vmap2(lambda x, u: jpac.friction_ellipse_residual(x, u, JP))(
                *a[:2]),
            sa=vmap2(lambda x, u: jpac.slip_angle_residuals(x, u, JP))(
                *a[:2]))
    t = [torch.tensor(v, dtype=dtype) for v in (x, u, k)]
    got = dict(
        slip=torch.stack(tpac.slip_angles(*t[:2], TP), -1),
        forces=torch.stack(tpac.tire_forces(*t[:2], TP), -1),
        f=tpac.f_continuous_pacejka(*t, TP),
        fe=tpac.friction_ellipse_residual(*t[:2], TP),
        sa=tpac.slip_angle_residuals(*t[:2], TP))
    for name in ref:
        scale = max(1.0, float(np.abs(np.asarray(ref[name])).max()))
        close(got[name] / scale, np.asarray(ref[name]) / scale, tol)


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-9), (F32, 1e-3)])
def test_linearize_pacejka_and_tire_rows_match_jax(dtype, tol):
    """The Jacobians equal ``jax.jacfwd`` (relative to each array's scale:
    the yaw row carries 1/I = 3.6e4), the vx guard point included."""
    x, u, k = random_xu(np.random.default_rng(1))
    with x64_island():
        a = [jnp.asarray(v, jdtype(dtype)) for v in (x, u, k)]
        Ad, Bd, rd = vmap2(
            lambda x, u, k: jpac.linearize_pacejka(x, u, k, JP, 0.05))(*a)
        fe = lambda x, u: jpac.friction_ellipse_residual(x, u, JP)  # noqa
        sa = lambda x, u: jpac.slip_angle_residuals(x, u, JP)       # noqa
        gx = vmap2(lambda x, u: jnp.concatenate(
            [jax.jacfwd(fe, 0)(x, u)[None], jax.jacfwd(sa, 0)(x, u)]))(*a[:2])
        gu = vmap2(lambda x, u: jnp.concatenate(
            [jax.jacfwd(fe, 1)(x, u)[None], jax.jacfwd(sa, 1)(x, u)]))(*a[:2])
    t = [torch.tensor(v, dtype=dtype) for v in (x, u, k)]
    got = tpac.linearize_pacejka(*t, TP, 0.05)
    _, tgx, tgu = tpac.tire_row_jacobians(*t[:2], TP)
    for g, r in zip(got + (tgx, tgu), (Ad, Bd, rd, gx, gu)):
        assert g.dtype == dtype
        scale = max(1.0, float(np.abs(np.asarray(r)).max()))
        close(g / scale, np.asarray(r) / scale, tol)


def _circle(R=2.0, n=300, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return (R * np.cos(th) + noise * rng.standard_normal(n),
            R * np.sin(th) + noise * rng.standard_normal(n))


def _track_json(tmp_path):
    x, y = _circle(R=2.0, n=240, noise=5e-4, seed=4)
    xi, yi = _circle(R=1.7, n=200)
    xo, yo = _circle(R=2.45, n=260)
    path = tmp_path / "track.json"
    path.write_text(json.dumps(dict(X=x.tolist(), Y=y.tolist(),
                                    X_i=xi.tolist(), Y_i=yi.tolist(),
                                    X_o=xo.tolist(), Y_o=yo.tolist())))
    return str(path)


def test_fit_centerline_and_track_json_tables_match_jax(tmp_path):
    """The host fit (outliers, two spline passes, per-segment poses and
    curvature, measured half-widths) builds the JAX package's tables: the
    same float64 numpy/scipy code on both sides."""
    path = _track_json(tmp_path)
    x, y = np.linspace(0.0, 6.0, 120), 0.8 * np.sin(np.linspace(0.0, 6.0, 120))
    with x64_island():
        refs = [jspl.track_from_json(path, n_segments=300, dtype=jnp.float64),
                jspl.fit_centerline(x, y, n_segments=200, dtype=jnp.float64)]
    gots = [tspl.track_from_json(path, n_segments=300, dtype=F64,
                                 device="cpu"),
            tspl.fit_centerline(x, y, n_segments=200, dtype=F64,
                                device="cpu")]
    for got, ref in zip(gots, refs):
        for f in got._fields:
            close(getattr(got, f), getattr(ref, f), 1e-12)
    assert not bool(gots[0].open_flag) and bool(gots[1].open_flag)
    assert np.allclose(gots[0].halfwidth.numpy(), 0.3, atol=0.03)
    xo, yo = np.array([0.0, 1.0, 1.01, 2.0, 3.0]), np.zeros(5)
    for a, b in zip(tspl.remove_outliers(xo, yo), jspl.remove_outliers(xo, yo)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype,tol", [(F64, 1e-9), (F32, 1e-3)])
def test_project_on_spline_matches_jax(dtype, tol):
    """Newton projection from near guesses, from far guesses (the global
    re-seed), across the lap seam, and on an open analytic track."""
    rng = np.random.default_rng(5)
    x, y = _circle(R=2.0, n=300)
    with x64_island():
        jt = jspl.fit_centerline(x, y, halfwidth=0.4, n_segments=600,
                                 dtype=jdtype(dtype))
    tt = interop.track_from_numpy(jt, dtype=dtype, device="cpu")
    L = float(jt.track_length[0])
    th = rng.uniform(0, 2 * np.pi, 24)
    r = 2.0 + rng.uniform(-0.3, 0.3, 24)
    s_true = 2.0 * th
    guess = np.concatenate([(s_true[:8] + 0.2) % L,             # near
                            (s_true[8:16] + 0.45 * L) % L,      # far
                            np.full(8, L - 0.01)])               # seam
    th[16:] = rng.uniform(-0.05, 0.05, 8) % (2 * np.pi)
    px, py = r * np.cos(th), r * np.sin(th)
    with x64_island():
        ref = jax.vmap(lambda a, b, c: jspl.project_on_spline(jt, a, b, c))(
            *(jnp.asarray(v, jdtype(dtype)) for v in (px, py, guess)))
    got = tspl.project_on_spline(tt, *(torch.tensor(v, dtype=dtype)
                                       for v in (px, py, guess)))
    close(got, ref, tol * L)
    err = np.abs(got.numpy() - np.mod(2.0 * th, L))
    err = np.minimum(err, L - err)[:16]     # on the circle s = R theta
    assert np.median(err) < 1e-3 and err.max() < 2e-2

    jh, th_ = tracks("Highway", dtype)
    s = rng.uniform(0.5, 30.0, 16)
    with x64_island():
        hx, hy, _ = j_f2c(jh, jnp.asarray(s, jdtype(dtype)), 0.2)
        ref = jax.vmap(lambda a, b, c: jspl.project_on_spline(jh, a, b, c))(
            hx, hy, jnp.asarray(s + 0.4, jdtype(dtype)))
    got = tspl.project_on_spline(
        th_, torch.tensor(np.asarray(hx)), torch.tensor(np.asarray(hy)),
        torch.tensor(s + 0.4, dtype=dtype))
    close(got, ref, tol * 40)
