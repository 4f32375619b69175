"""The PyTorch port's host-side runtime against the JAX package: lap
termination (``check_end``), the single-fleet solver schedule and the
long-horizon runners on it, the checkpoint round trip, the
IO file schema, and the two entry-point scripts.
"""

import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colaborativempc_tpu import config as jcfg
from colaborativempc_tpu.geometry import check_end as j_check_end
from colaborativempc_tpu.geometry import check_lap as j_check_lap
from colaborativempc_tpu.geometry import make_track as j_make_track
from colaborativempc_tpu.runtime import io as jio
from colaborativempc_tpu.runtime import simulate as jsim
from colaborativempc_tpu.runtime.ocd import OCDStepMetrics as JMetrics

from colaborativempc_tpu_torch import config as tcfg
from colaborativempc_tpu_torch import interop
from colaborativempc_tpu_torch.geometry import check_end, check_lap
from colaborativempc_tpu_torch.geometry import make_track
from colaborativempc_tpu_torch.parallel import batch_fleet_state
from colaborativempc_tpu_torch.runtime import checkpoint as tck
from colaborativempc_tpu_torch.runtime import io as tio
from colaborativempc_tpu_torch.runtime import ocd as tocd
from colaborativempc_tpu_torch.runtime import simulate as tsim

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("track_name,laps", [("Highway", 1), ("oval", 1),
                                              ("oval", 2)])
def test_check_end_matches_jax(track_name, laps):
    jt = j_make_track(track_name)
    L = float(jt.track_length[0])
    s = np.array([0.0, L - 0.2, L - 0.1, L, L + 0.05, 1.5 * L, 2 * L - 0.1,
                  2 * L + 0.1, 3.2 * L], np.float32)
    tt = interop.track_from_numpy(jt, device="cpu")
    np.testing.assert_array_equal(
        check_end(tt, torch.tensor(s), laps=laps).numpy(),
        np.asarray(j_check_end(jt, jnp.asarray(s), laps=laps)))
    np.testing.assert_array_equal(check_lap(tt, torch.tensor(s)).numpy(),
                                  np.asarray(j_check_lap(jt, jnp.asarray(s))))
    assert bool(check_end(tt, torch.tensor(s), laps=laps).any())


@pytest.mark.parametrize("N,solver", [
    (20, {}), (48, {}), (125, dict(admm_iters=300, assoc=False)),
    (60, dict(epoch_len=30))])
def test_resolve_single_fleet_schedule_matches_jax(N, solver):
    ref = jsim.resolve_single_fleet_schedule(jcfg.ExperimentConfig(
        N=N, solver=jcfg.SolverConfig(**solver)))
    got = tsim.resolve_single_fleet_schedule(tcfg.ExperimentConfig(
        N=N, solver=tcfg.SolverConfig(**solver)))
    for f in ("epoch_len", "assoc", "admm_iters"):
        assert getattr(got.solver, f) == getattr(ref.solver, f), f


def test_long_horizon_runners_refuse_the_unported_assoc_path():
    """At N >= 48 the single-fleet schedule resolves assoc=True with epoch
    15, a path the port once refused. Both runners now run it with their
    default settings (only ``admm_iters`` pinned small, so assoc and the
    epoch length still resolve) and equal the JAX runners in float64:
    states within 1e-6, equal ADMM and OCD iteration counts."""
    from colaborativempc_tpu.runtime import ocd as jocd
    base = dict(N=48, dt=0.02, map_type="Highway", max_it=2,
                dtype="float64")
    ref = jsim.run_lpv_experiment(jcfg.ExperimentConfig(
        n_agents=2, gains=jcfg.lpv_gains(),
        solver=jcfg.SolverConfig(admm_iters=60), **base))
    got = tsim.run_lpv_experiment(tcfg.ExperimentConfig(
        n_agents=2, gains=tcfg.lpv_gains(),
        solver=tcfg.SolverConfig(admm_iters=60), **base), device="cpu")
    assert got.steps == ref.steps == 2
    np.testing.assert_allclose(got.states, ref.states, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.iterations, ref.iterations)
    assert (got.iterations % 15 == 0).all() and got.iterations.max() == 60
    sv = dict(admm_iters=60, sqp_iters=2)
    ref = jocd.run_nl_experiment(jcfg.ExperimentConfig(
        n_agents=1, gains=jcfg.nl_gains(), ocd=jcfg.OCDConfig(max_it_ocd=3),
        solver=jcfg.SolverConfig(**sv), **base))
    got = tocd.run_nl_experiment(tcfg.ExperimentConfig(
        n_agents=1, gains=tcfg.nl_gains(), ocd=tcfg.OCDConfig(max_it_ocd=3),
        solver=tcfg.SolverConfig(**sv), **base), device="cpu")
    np.testing.assert_allclose(got.states, ref.states, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.ocd_iterations, ref.ocd_iterations)


def test_checkpoint_round_trip_keeps_every_field(tmp_path):
    cfg = tcfg.ExperimentConfig(n_agents=3, N=6, coupling="hp_opt")
    tt = make_track("Highway", device="cpu")
    st = batch_fleet_state(tocd.init_nl_fleet(tt, cfg, device="cpu"), 2,
                           device="cpu")
    st = st._replace(lambdas=torch.rand(st.lambdas.shape),
                     jam_count=torch.tensor([[1, 2, 3], [4, 5, 6]],
                                            dtype=torch.int32))
    path = str(tmp_path / "sub" / "ck.npz")
    tck.save_checkpoint(path, st, 17, meta={"note": "x"})
    got, step = tck.load_checkpoint(path, st)
    assert step == 17 and isinstance(got, tocd.OCDFleetState)
    for a, b in zip(got, st):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not os.path.exists(path + ".tmp.npz")


def test_checkpoint_field_mismatch_raises_a_clear_error(tmp_path):
    """A checkpoint of another record names the fields that differ, where
    the JAX package fails on the leaf count alone."""
    cfg = tcfg.ExperimentConfig(n_agents=2, N=6)
    tt = make_track("Highway", device="cpu")
    lpv = tsim.init_lpv_fleet(tt, cfg, device="cpu")
    path = str(tmp_path / "ck.npz")
    tck.save_checkpoint(path, lpv, 3)
    with pytest.raises(ValueError, match=r"missing fields \['lambdas'\]"):
        tck.load_checkpoint(path, tocd.init_nl_fleet(tt, cfg, device="cpu"))


def _fake_run(n_ag=2, N=4, T=3, seed=0):
    """Per-step fleet states and metrics of a short run, as numpy."""
    rng = np.random.default_rng(seed)
    steps = []
    for t in range(T):
        st = dict(x0=rng.normal(size=(n_ag, 9)),
                  u_old=rng.normal(size=(n_ag, 2)),
                  x_pred=rng.normal(size=(n_ag, N + 1, 9)),
                  u_pred=rng.normal(size=(n_ag, N, 2)))
        m = dict(ocd_iterations=np.asarray(3 + t), feasible=np.ones(n_ag, bool),
                 min_dist=np.asarray(0.3), min_dist_exec=np.asarray(0.3),
                 lambda_max=np.asarray(0.1), exec_beta=np.ones(n_ag),
                 wall_clip=np.zeros(n_ag, bool))
        steps.append((st, m, 0.01 * (t + 1)))
    return steps


class _Rec:
    def __init__(self, d):
        self.__dict__.update(d)


@pytest.mark.parametrize("timed", [False, True])
def test_experiment_io_writes_the_jax_schema(tmp_path, timed):
    """Fed the same run, the port's ExperimentIO writes the same files with
    the same contents as the JAX package's, and its loaders read them."""
    kw = dict(n_agents=2, N=4, verb=0)
    outs = {}
    for name, mod, cfg in (("jax", jio, jcfg.ExperimentConfig(**kw)),
                           ("torch", tio, tcfg.ExperimentConfig(**kw))):
        io = mod.ExperimentIO(cfg, path=str(tmp_path / name))
        for it, (st, m, secs) in enumerate(_fake_run()):
            metrics = JMetrics(**m) if name == "jax" else \
                tocd.OCDStepMetrics(**m)
            io.update(it, _Rec(st), metrics, secs)
        if timed:
            io.ocd_iter_times.extend([[0.1] * 3, [0.2] * 4, [0.3] * 5])
        io.save_all(lambdas=np.arange(2 * 2 * 4.0).reshape(2, 2, 4))
        outs[name] = tmp_path / name
    files = {n: sorted(str(p.relative_to(d)) for p in d.rglob("*")
                       if p.is_file()) for n, d in outs.items()}
    assert files["torch"] == files["jax"]
    assert ("csv/0/time_OCD.dat" in files["torch"]) == timed
    for rel in files["jax"]:
        a, b = outs["jax"] / rel, outs["torch"] / rel
        if rel.endswith(".dat"):
            np.testing.assert_array_equal(np.loadtxt(b), np.loadtxt(a))
        elif rel.endswith(".pkl"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                np.testing.assert_array_equal(np.asarray(pickle.load(fb)),
                                              np.asarray(pickle.load(fa)))
    lam = tio.load_lambdas(str(outs["jax"] / "pck" / "ini_lambdas.pkl"), 2, 4)
    assert lam.shape == (2, 2, 4) and lam[1, 1, 3] == 15.0
    with pytest.warns(UserWarning, match="defaulting to 0s"):
        assert not tio.load_lambdas(str(tmp_path / "none.pkl"), 2, 4).any()
    states, u = tio.load_experiment(str(outs["jax"]), 1)
    assert len(states) == 3 and states[0].shape == (5, 9)


@pytest.mark.parametrize("script,args", [
    ("nl_main", ["--agents", "2", "--N", "6", "--steps", "2", "--verb", "0",
                 "--coupling", "hp"]),
    ("monte_carlo", ["--pipeline", "nl", "--scenarios", "2", "--agents",
                     "2", "--N", "6", "--steps", "2"]),
    ("monte_carlo", ["--pipeline", "lpv", "--scenarios", "2", "--N", "6",
                     "--steps", "2"])])
def test_entry_points_run_with_python_m(script, args, tmp_path):
    if script == "nl_main":
        args = args + ["--out", str(tmp_path / "out")]
    out = subprocess.run(
        [sys.executable, "-m", f"colaborativempc_tpu_torch.scripts.{script}",
         "--device", "cpu"] + args, cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    if script == "nl_main":
        assert "steps=2" in out.stdout and "feasible=True" in out.stdout
        assert (tmp_path / "out" / "pck" / "ini_lambdas.pkl").exists()
    else:
        assert "feasible scenarios: 2/2" in out.stdout
