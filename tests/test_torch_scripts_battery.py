"""Script parity on the CPU: ``experiment_battery``'s LPV grid and its NL
grid over the horizon sweep ``--horizons 6,8``, the JAX package's script
against the port's (``--device cpu``) on the same tiny arguments: as many
configuration lines, and ``progress=`` / ``min_dist=`` within one unit of
the printed last digit.
"""

import importlib
import re
import sys

import numpy as np
import pytest
import torch

from colaborativempc_tpu_torch.scripts import experiment_battery

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)


def run_both(argv, monkeypatch, capsys):
    mod = importlib.import_module(
        "colaborativempc_tpu.scripts.experiment_battery")
    monkeypatch.setattr(sys, "argv", ["x"] + argv)
    capsys.readouterr()
    mod.main()
    ref = capsys.readouterr().out
    res = experiment_battery.main(argv + ["--device", "cpu"])
    return ref, capsys.readouterr().out, res


def cfg_lines(text):
    return [ln.strip() for ln in text.splitlines()
            if re.match(r"\s*(N=\d+ )?cfg", ln)]


def values(lines, key):
    return [float(re.search(re.escape(key) + r"([-+0-9.]+)", ln).group(1))
            for ln in lines]


@pytest.mark.parametrize("pipeline,extra,n_lines", [
    ("lpv", ["--N", "8", "--steps", "2"], 18),
    ("nl", ["--horizons", "6,8", "--steps", "1"], 24),
])
def test_battery_prints_the_jax_lines(pipeline, extra, n_lines, monkeypatch,
                                      capsys):
    argv = ["--pipeline", pipeline, "--agents", "2"] + extra
    ref, got, res = run_both(argv, monkeypatch, capsys)
    rl, gl = cfg_lines(ref), cfg_lines(got)
    assert len(gl) == len(rl) == n_lines
    # the gains columns are the same text; the results within one unit of
    # the printed last digit
    assert [ln.split("->")[0] for ln in gl] == [ln.split("->")[0]
                                                 for ln in rl]
    np.testing.assert_allclose(values(gl, "progress="),
                               values(rl, "progress="), rtol=0, atol=0.011)
    np.testing.assert_allclose(values(gl, "min_dist="),
                               values(rl, "min_dist="), rtol=0, atol=0.0011)
    assert [ln.split("feasible=")[1] for ln in gl] == [
        ln.split("feasible=")[1] for ln in rl]
    if pipeline == "nl":
        assert sorted(res) == [6, 8]
        assert all(r.states.shape == (1, 12, 2, 9) for r in res.values())
        np.testing.assert_allclose(values(gl, "OCD_it="),
                                   values(rl, "OCD_it="), rtol=0, atol=0.11)
    else:
        assert res.states.shape == (2, 18, 2, 9)
