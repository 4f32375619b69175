"""Script parity on the CPU: ``bench_suite``, the JAX package's script
against the port's (``--device cpu``).

- ``--tiny``: the same rows (``config`` names) with the JAX script's keys,
  ``feasible`` equal and ``ocd_it_mean`` equal;
- the rows each mode runs (default, ``--quick``, ``--saturation``): the
  row functions' arguments, recorded from both scripts' ``main``, are the
  same (the port's adds only the device and the reps);
- a small ``mxu_study`` (block-diagonal operands within 1e-6 of the
  batched products) and ``mxu_end_to_end`` (both settings, the float32
  pins restored after);
- a short ``mpcc_assoc_study``: the JAX script's row keys and variants.
"""

import importlib
import json
import sys

import numpy as np
import pytest
import torch

from colaborativempc_tpu_torch.scripts import bench_suite

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)


def jax_script():
    return importlib.import_module("colaborativempc_tpu.scripts.bench_suite")


def json_lines(text):
    return [json.loads(ln) for ln in text.strip().splitlines()]


def test_tiny_rows_match_jax(monkeypatch, capsys):
    """``--tiny`` on both packages: one LPV and one NL row each, the same
    configs and keys, every fleet feasible on both, the same mean OCD
    iterations; the port's rows are also returned by ``main``."""
    mod = jax_script()
    monkeypatch.setattr(sys, "argv", ["x", "--tiny"])
    capsys.readouterr()
    mod.main()
    ref = json_lines(capsys.readouterr().out)
    got = bench_suite.main(["--tiny", "--device", "cpu"])
    assert json_lines(capsys.readouterr().out) == got
    assert [r["config"] for r in got] == [r["config"] for r in ref]
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        assert g["protocol"] == r["protocol"] == "best-of-10"
        assert g["feasible"] == r["feasible"]
        assert (g["agents"], g["N"], g["batch"]) == (
            r["agents"], r["N"], r["batch"])
    assert got[1]["ocd_it_mean"] == ref[1]["ocd_it_mean"]
    assert all(r["feasible"] for r in got)


@pytest.mark.parametrize("argv", [[], ["--quick"],
                                  ["--saturation", "--batches", "64,1024"]])
def test_each_mode_runs_the_jax_scripts_rows(argv, monkeypatch):
    """Each mode calls the row functions with the JAX script's arguments,
    row for row (recorded with the functions replaced; nothing runs)."""
    def recorder(calls, kind):
        def record(*a, **kw):
            kw.pop("device", None)
            kw.pop("reps", None)
            calls.append((kind, a, kw))
        return record
    mod = jax_script()
    ref, got = [], []
    for m, calls in ((mod, ref), (bench_suite, got)):
        monkeypatch.setattr(m, "fleet_bench", recorder(calls, "lpv"))
        monkeypatch.setattr(m, "nl_fleet_bench", recorder(calls, "nl"))
    monkeypatch.setattr(sys, "argv", ["x"] + argv)
    mod.main()
    bench_suite.main(argv + ["--device", "cpu"])
    assert got == ref and len(got) >= 3


def test_mxu_study_block_diagonal_matches_batched():
    """A small ``mxu_study`` on the CPU: four rows with the JAX script's
    keys, the block-diagonal operands within 1e-6 of the batched products,
    and the float32 pins in place after."""
    rows = bench_suite.mxu_study(B_lanes=24, N=4, device="cpu", reps=1)
    assert [r["mxu_variant"].split()[0] for r in rows] == [
        "batched-11x11", "batched-11x11", "blockdiag-121x121",
        "blockdiag-121x121"]
    assert set(rows[0]) == {"mxu_variant", "lanes", "N", "us_per_pass",
                            "useful_gflops", "executed_gflops",
                            "rel_err_vs_shipped"}
    assert rows[0]["rel_err_vs_shipped"] == 0.0
    assert all(r["rel_err_vs_shipped"] <= 1e-6 for r in rows)
    assert all(r["lanes"] == 24 and r["N"] == 4 for r in rows)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_mxu_end_to_end_restores_the_pins(monkeypatch):
    """The knee step under both settings (a small fleet here), the pins
    restored even when a row fails."""
    rows = bench_suite.mxu_end_to_end(B=2, N=8, device="cpu", reps=1)
    assert [r["config"] for r in rows] == [
        "knee 3-agent H=8 B=2 [HIGHEST (shipped)]",
        "knee 3-agent H=8 B=2 [DEFAULT (TF32)]"]
    assert all(r["feasible"] for r in rows)
    assert torch.backends.cuda.matmul.allow_tf32 is False

    def fail(*a, **kw):
        assert torch.backends.cuda.matmul.allow_tf32 is False
        raise RuntimeError("row failed")
    monkeypatch.setattr(bench_suite, "fleet_bench", fail)
    with pytest.raises(RuntimeError, match="row failed"):
        bench_suite.mxu_end_to_end(B=2, N=8, device="cpu", reps=1)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_mpcc_assoc_study_rows():
    """A short ``mpcc_assoc_study`` on the CPU: the JAX script's variants
    and keys, every step timed and feasible shares in [0, 1]."""
    rows = bench_suite.mpcc_assoc_study(steps=2, N=8, device="cpu", warm=1)
    assert [r["mpcc_assoc_variant"] for r in rows] == [
        "seq", "assoc-blocked+epoch15"]
    for r in rows:
        assert set(r) == {"mpcc_assoc_variant", "N", "steps", "p50_ms",
                          "min_ms", "p95_ms", "s_final", "feasible_frac",
                          "dispatch_floor_ms"}
        assert r["steps"] == 2 and 0.0 <= r["feasible_frac"] <= 1.0
        assert np.isfinite(r["s_final"]) and r["min_ms"] > 0
