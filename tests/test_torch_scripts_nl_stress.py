"""Script parity on the CPU: ``stress_study``'s NL-OCD host-loop studies,
the JAX package's script against the port's (``--device cpu``) on the same
tiny arguments (NL eu, N=6).

- ``perturbed`` (the host loop, one start) and ``latency``: ``s_final``,
  ``bad_steps``, ``held_steps`` and ``min_dist_exec`` equal JAX's to 1e-3,
  and the summary line of ``perturbed`` is JAX's.
"""

import json

import pytest
import torch

from colaborativempc_tpu_torch.scripts import stress_study
from test_torch_scripts_stress import REPORT_KEYS, assert_same_run, run_jax

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)


def test_perturbed_nl_host_loop_matches_jax(monkeypatch, capsys):
    argv = ["perturbed", "--family", "nl-eu", "--n", "6", "--steps", "2",
            "--starts", "1"]
    ref = run_jax(argv, monkeypatch, capsys, lines=True)
    rows = stress_study.main(argv + ["--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(lines) == len(ref) == 2
    assert set(rows[0]) == set(ref[0]) == REPORT_KEYS
    assert_same_run(rows[0], ref[0])
    assert lines[-1] == ref[-1]


@pytest.mark.parametrize("variant", ["auto", "seq"])
def test_latency_nl_matches_jax(variant, monkeypatch, capsys):
    argv = ["latency", "--family", "nl-eu", "--n", "6", "--steps", "3",
            "--variant", variant]
    ref = run_jax(argv, monkeypatch, capsys)
    out = stress_study.main(argv + ["--device", "cpu"])
    assert set(out) == set(ref) == REPORT_KEYS
    assert out["study"] == ref["study"] == f"latency/nl-eu/N=6/{variant}"
    assert out["steps"] == 3 and out["backend"] == "cpu"
    assert_same_run(out, ref)
