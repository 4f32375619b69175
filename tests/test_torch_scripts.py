"""Script parity on the CPU: each of the port's scripts against the JAX
package's script of the same name, on the same tiny arguments, each
writing into its own directory (``--device cpu`` on the port's side).

- ``lpv_main`` (2 agents, N=8, 4 steps): the written ``states.dat`` and
  ``u.dat`` equal to 1e-3 (float32 closed loops);
- on the port's output: ``eval_exp --gif`` and ``paper_figs`` write their
  figures, and ``eval_lpv_model`` prints the same errors as the JAX script
  to 1e-4;
- ``compare_reference`` against a mock golden run;
- ``experiment_battery --pipeline mpcc`` (N=8): as many configuration
  lines as JAX's, ``progress=`` within one unit of the printed last digit;
- ``show_maps`` and ``test_planes`` write their figures.

The batteries' other pipelines and the stress studies are in
``test_torch_scripts_battery.py`` and ``test_torch_scripts_stress.py``
(split by cost: each file runs in well under a minute alone).
"""

import importlib
import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from colaborativempc_tpu_torch.config import lpv_gains
from colaborativempc_tpu_torch.scripts import (
    compare_reference, eval_exp, eval_lpv_model, experiment_battery,
    lpv_main, nl_main, paper_figs, show_maps, test_planes,
)

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)

LPV_ARGS = ["--agents", "2", "--N", "8", "--steps", "4", "--dt", "0.025",
            "--admm-iters", "300", "--verb", "0"]


def run_jax(name, argv, monkeypatch):
    """The JAX package's script ``name`` with ``argv`` (it reads
    ``sys.argv``)."""
    mod = importlib.import_module(f"colaborativempc_tpu.scripts.{name}")
    monkeypatch.setattr(sys, "argv", ["x"] + argv)
    return mod.main()


def numbers(text, key):
    """Every number printed after ``key`` (e.g. ``progress=``)."""
    return [float(v) for v in re.findall(re.escape(key) + r"\s*([-+0-9.]+)",
                                         text)]


@pytest.fixture(scope="module")
def lpv_runs(tmp_path_factory):
    """The JAX and the port's lpv_main on the same arguments."""
    root = tmp_path_factory.mktemp("lpv")
    mp = pytest.MonkeyPatch()
    try:
        run_jax("lpv_main", LPV_ARGS + ["--out", str(root / "jax")], mp)
    finally:
        mp.undo()
    res = lpv_main.main(LPV_ARGS + ["--out", str(root / "port"),
                                    "--device", "cpu"])
    return root / "jax", root / "port", res


@pytest.mark.parametrize("table", ["states.dat", "u.dat"])
def test_lpv_main_writes_the_jax_tables(lpv_runs, table):
    jdir, tdir, res = lpv_runs
    assert res.steps == 4
    for a in range(2):
        ref = np.loadtxt(jdir / "csv" / str(a) / table)
        got = np.loadtxt(tdir / "csv" / str(a) / table)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    for f in ("settings.csv", "track.png", "perf.png", "pck/0/states.pkl",
              "pck/1/u.pkl", "csv/1/plan_dist.dat", "csv/0/time.dat"):
        assert (tdir / f).exists(), f


def test_replay_tools_on_the_port_output(lpv_runs, tmp_path, monkeypatch,
                                         capsys):
    _, tdir, _ = lpv_runs
    run = tmp_path / "run"
    shutil.copytree(tdir, run)
    eval_exp.main([str(run), "--gif", "--every", "2"])
    for f in ("replay.png", "replay_perf.png", "run.gif"):
        assert (run / f).stat().st_size > 0
    paper_figs.main([str(run), "--out", str(tmp_path / "figs")])
    assert (tmp_path / "figs" / "comparison.png").exists()

    capsys.readouterr()
    run_jax("eval_lpv_model", [str(run), "--dt", "0.025", "--steps", "3"],
            monkeypatch)
    ref = numbers(capsys.readouterr().out, "max err")
    sim, err = eval_lpv_model.main([str(run), "--dt", "0.025", "--steps",
                                    "3", "--device", "cpu"])
    got = numbers(capsys.readouterr().out, "max err")
    assert len(got) == len(ref) == 9 and sim.shape == (4, 9)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(err.max(axis=0), got, rtol=0, atol=5e-5)


def test_compare_reference_mock_golden(lpv_runs, tmp_path, monkeypatch,
                                       capsys):
    """The reference comparison replays a mock golden run (the reference's
    on-disk schema, made from the port's own tiny run) under the
    configuration its settings.csv records, gain matrices included."""
    _, tdir, _ = lpv_runs
    golden = tmp_path / "mock_golden"
    for a in range(2):
        (golden / "csv" / str(a)).mkdir(parents=True)
        shutil.copy(tdir / "csv" / str(a) / "states.dat",
                    golden / "csv" / str(a) / "states.dat")
    gains = lpv_gains()
    matrices = "".join(
        f'{k},"{np.array2string(np.diag(getattr(gains, f)), 999)}"\n'
        for k, f in (("Q", "q"), ("Qs", "qs"), ("R", "r"), ("dR", "dr")))
    (golden / "settings.csv").write_text(
        "n_agents,2\nN,8\ndt,0.025\nmap_type,Highway\nvx_ref,3.0\n"
        f"min_dist,0.25\nwq,{gains.wq}\n" + matrices)
    argv = ["--ref", str(golden), "--steps", "4", "--short", "3"]
    capsys.readouterr()
    run_jax("compare_reference", argv, monkeypatch)
    ref = capsys.readouterr().out
    out = compare_reference.main(argv + ["--device", "cpu"])
    text = capsys.readouterr().out
    assert "behavioural deltas" in text and "short-horizon" in text
    for label in ("reference:", "ours:"):
        def stat_line(t):
            return next(ln for ln in t.splitlines()
                        if ln.strip().startswith(label))
        for key in ("max_vx=", "rms_ey=", "progress_rate=",
                    "min_pair_dist="):
            np.testing.assert_allclose(numbers(stat_line(text), key),
                                       numbers(stat_line(ref), key),
                                       rtol=0, atol=1.1e-3)
    assert "planner=lpv N=8 dt=0.025 q=[10. 25. 10.]" in text
    assert compare_reference.load_settings(str(golden))["Qs"].shape == (3, 3)
    assert out["short_deviation"].shape == (9,)
    assert np.isfinite(out["short_deviation"]).all()
    assert set(out["ours"]) == set(out["reference"]) == {
        "mean_vx", "max_vx", "rms_ey", "progress_rate", "min_pair_dist"}


def test_parse_matrix_and_settings(tmp_path):
    m = compare_reference.parse_matrix("[[1.0 2.0]\n [3.0 4.0]]")
    np.testing.assert_array_equal(m, [[1.0, 2.0], [3.0, 4.0]])
    (tmp_path / "settings.csv").write_text(
        "N,20\ndt,0.02\nmap_type,Oval2\nQ,\"[[1. 0.]\n [0. 2.]]\"\n"
        "unknown,7\n")
    s = compare_reference.load_settings(str(tmp_path))
    assert s["N"] == 20 and s["dt"] == 0.02 and s["map_type"] == "Oval2"
    np.testing.assert_array_equal(np.diag(s["Q"]), [1.0, 2.0])
    assert "unknown" not in s
    assert compare_reference.load_settings(str(tmp_path / "none")) == {}


def test_battery_mpcc_prints_the_jax_lines(monkeypatch, capsys):
    argv = ["--pipeline", "mpcc", "--steps", "3", "--N", "8"]
    run_jax("experiment_battery", argv, monkeypatch)
    ref = capsys.readouterr().out
    res = experiment_battery.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    lines = [ln for ln in got.splitlines() if ln.startswith("cfg")]
    assert len(lines) == len([ln for ln in ref.splitlines()
                              if ln.startswith("cfg")]) == 18
    assert res.n_configs == 18
    assert re.sub(r"-> .*", "", lines[5]) == re.sub(
        r"-> .*", "", [ln for ln in ref.splitlines()
                       if ln.startswith("cfg")][5])
    np.testing.assert_allclose(numbers(got, "progress="),
                               numbers(ref, "progress="), rtol=0, atol=0.011)


@pytest.mark.parametrize("script,argv", [
    (lpv_main, ["--agents", "2", "--N", "6", "--steps", "1", "--verb", "0"]),
    (nl_main, ["--agents", "2", "--N", "6", "--steps", "1", "--verb", "0"]),
])
def test_plotting_without_matplotlib_fails_before_the_run(
        script, argv, tmp_path, monkeypatch):
    """Where matplotlib is missing, a run that would plot fails before it
    starts, naming --no-plot; with --no-plot it runs and writes its
    tables."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "out"
    argv = argv + ["--out", str(out), "--device", "cpu"]
    with pytest.raises(RuntimeError, match="--no-plot"):
        script.main(argv)
    assert not out.exists()
    script.main(argv + ["--no-plot"])
    assert (out / "csv" / "0" / "states.dat").exists()
    assert not (out / "track.png").exists()


def test_show_maps_and_planes(tmp_path, capsys):
    show_maps.main(["oval", "Oval2", "--out", str(tmp_path)])
    assert (tmp_path / "oval.png").exists()
    assert (tmp_path / "Oval2.png").exists()
    test_planes.main(["--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "planes separate correctly" in out
    assert (tmp_path / "planes.png").exists()
    assert len(numbers(out, "d(ego)=")) == 6
