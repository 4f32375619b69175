"""Script parity on the CPU: ``stress_study``, the JAX package's script
against the port's (``--device cpu``) on the same tiny arguments.

- ``full-course`` (LPV, N=8, 3 steps) and ``perturbed --batched`` (2
  starts, a chunk that does not divide the steps): the JSON keys are
  JAX's, and ``s_final``, ``bad_steps``, ``held_steps``, ``complete`` and
  ``min_dist_exec`` equal JAX's to 1e-3;
- ``perturbed`` (NL eu, the host loop): the JAX script's schema (its
  keys, listed here from ``colaborativempc_tpu/scripts/stress_study.py``),
  with ``backend`` the torch device type; its outcome against JAX's is
  held in ``test_torch_scripts_nl_stress.py``;
- ``latency --variant seq`` (LPV) and ``gs-tradeoff`` (one gain set shared
  over a batch of fleets, Jacobi and Gauss-Seidel): the schema, and the
  same outcome as JAX's: ``s_final``, ``bad_steps``, ``held_steps`` and
  ``min_dist_exec`` to 1e-3 for the run, ``ocd_iters_mean`` and
  ``feasible`` equal for each sweep.
"""

import argparse
import importlib
import json
import sys

import numpy as np
import pytest
import torch

from colaborativempc_tpu_torch.scripts import stress_study

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)

REPORT_KEYS = {"study", "backend", "steps", "finished", "complete_all",
               "s_final", "bad_steps", "held_steps", "min_dist_exec",
               "p50_ms", "p95_ms", "max_ms", "dispatch_floor_ms", "wall_s",
               "filter_steps", "min_beta", "wall_steps"}
GS_KEYS = {"study", "batch", "steps", "N", "ocd_iters_mean",
           "ms_per_fleet_step_batch", "fleet_steps_per_s", "feasible"}


def last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def run_jax(argv, monkeypatch, capsys, lines=False):
    mod = importlib.import_module("colaborativempc_tpu.scripts.stress_study")
    monkeypatch.setattr(sys, "argv", ["x"])
    capsys.readouterr()
    mod.main(argv)
    out = capsys.readouterr().out
    if lines:
        return [json.loads(ln) for ln in out.strip().splitlines()]
    return last_json(out)


def assert_same_run(got, ref):
    for k in ("s_final", "bad_steps", "held_steps", "min_dist_exec"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-3,
                                   err_msg=k)


@pytest.mark.parametrize("argv,keys", [
    (["full-course", "--family", "lpv", "--n", "8", "--steps", "3"],
     ("s_final", "bad_steps", "held_steps", "min_dist_exec")),
    (["perturbed", "--batched", "--family", "lpv", "--n", "8", "--steps",
      "5", "--starts", "2", "--chunk", "2"],
     ("complete", "held_steps", "min_dist_exec")),
])
def test_study_matches_jax(argv, keys, monkeypatch, capsys):
    ref = run_jax(argv, monkeypatch, capsys)
    got = stress_study.main(argv + ["--device", "cpu"])
    assert last_json(capsys.readouterr().out) == got
    assert set(got) == set(ref)
    assert got["study"] == ref["study"] and got["backend"] == "cpu"
    for k in keys:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-3)
    if argv[0] == "perturbed":
        assert got["steps"] == 5 and got["chunk"] == 2
        assert len(got["t_complete"]) == 2


def test_perturbed_host_loop_schema(capsys):
    rows = stress_study.main(["perturbed", "--family", "nl-eu", "--n", "6",
                              "--steps", "2", "--starts", "1", "--device",
                              "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(rows) == 1 and lines[0] == rows[0]
    # NLExperimentResult has no ADMM iteration history: no it_mean / it_max
    assert set(rows[0]) == REPORT_KEYS
    assert rows[0]["study"] == "perturbed[0]/nl-eu/auto"
    assert lines[-1] == {"study": "perturbed/nl-eu/auto",
                         "complete": int(rows[0]["complete_all"]),
                         "starts": 1, "held_steps": [rows[0]["held_steps"]]}


def test_latency_schema(monkeypatch, capsys):
    argv = ["latency", "--family", "lpv", "--n", "8", "--steps", "3",
            "--variant", "seq"]
    ref = run_jax(argv, monkeypatch, capsys)
    out = stress_study.main(argv + ["--device", "cpu"])
    assert set(out) == set(ref) == REPORT_KEYS | {"it_mean", "it_max"}
    assert out["study"] == "latency/lpv/N=8/seq" and out["steps"] == 3
    assert out["backend"] == "cpu" and out["dispatch_floor_ms"] >= 0.0
    assert_same_run(out, ref)
    assert out["it_max"] == ref["it_max"]


def test_gs_tradeoff_schema(monkeypatch, capsys):
    argv = ["gs-tradeoff", "--n", "6", "--batch", "2", "--steps", "2",
            "--reps", "1"]
    ref = run_jax(argv, monkeypatch, capsys, lines=True)
    rows = stress_study.main(argv + ["--device", "cpu"])
    assert [r["study"] for r in rows] == [r["study"] for r in ref] == [
        "gs-tradeoff/jacobi", "gs-tradeoff/gauss_seidel"]
    for r, j in zip(rows, ref):
        assert set(r) == set(j) == GS_KEYS
        assert r["batch"] == 2 and r["N"] == 6 and r["steps"] == 2
        assert r["ocd_iters_mean"] >= 2.0 and r["fleet_steps_per_s"] > 0
        assert r["ocd_iters_mean"] == j["ocd_iters_mean"]
        assert r["feasible"] == j["feasible"]


@pytest.mark.parametrize("no_filter", [False, True])
@pytest.mark.parametrize("family", ["lpv", "nl-eu"])
def test_no_filter_clears_only_the_separation_filter(family, no_filter):
    """``--no-filter`` clears ``exec_sep_frac`` only, in both packages
    (JAX ``stress_study.py:55,135``): the track-limits wall
    (``exec_ey_wall``) and the degraded-execution escape (``hold_exec_k``)
    stay armed. A reference defect, carried over and pinned here."""
    jmod = importlib.import_module("colaborativempc_tpu.scripts.stress_study")
    ref = jmod._mk_cfg(family, 8, 3, sep_filter=not no_filter)
    got = stress_study._variant_cfg(argparse.Namespace(
        family=family, n=8, steps=3, variant="auto", no_filter=no_filter,
        no_vxpass=False))
    for f in ("exec_sep_frac", "exec_ey_wall", "hold_exec_k"):
        assert getattr(got, f) == getattr(ref, f), f
    assert (got.exec_sep_frac is None) == no_filter
    assert got.exec_ey_wall is not None and got.hold_exec_k is not None
