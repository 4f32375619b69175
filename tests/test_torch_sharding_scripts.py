"""The sharded entry points on real multi-process gloo groups (the harness
of ``tests/test_torch_sharding.py``):

- ``run_mpcc_battery(mesh=...)`` on a 2-rank mesh, each rank racing half
  of a 4-set gain grid at the small size of ``tests/test_torch_mpcc.py``
  (N=8, ``admm_iters=80``, 5 steps): every rank returns the whole result,
  equal to the battery without a mesh exactly; a grid that does not split
  over the mesh raises the JAX battery's ``ValueError``;
- ``monte_carlo --mesh 2x1`` (LPV) and ``--mesh 1x2`` (NL) with ``--device
  cpu``: rank 0 prints the report lines of the run without ``--mesh`` and
  rank 1 prints nothing; a ``--mesh`` whose axes do not divide the counts
  exits with the JAX script's message, and one whose size is not the
  world's names the ranks it needs.
"""

import contextlib
import io
import sys

import numpy as np
import pytest
import torch

from colaborativempc_tpu_torch.geometry import make_track
from colaborativempc_tpu_torch.planners.mpcc import MPCCConfig, MPCCGains
from colaborativempc_tpu_torch.runtime import battery as tbat
from colaborativempc_tpu_torch.scripts import monte_carlo

from test_torch_sharding import spawn

torch.set_num_threads(2)

BAT_CFG = dict(N=8, admm_iters=80)
BAT_STEPS = 5
MC_LPV = ["--pipeline", "lpv", "--scenarios", "4", "--agents", "2", "--N",
          "6", "--steps", "2", "--device", "cpu"]
MC_NL = ["--pipeline", "nl", "--scenarios", "2", "--agents", "2", "--N",
         "6", "--steps", "2", "--device", "cpu"]


def grid():
    return tbat.mpcc_gain_grid(MPCCGains(), q_contour=[20.0, 120.0],
                               q_progress=[0.5, 2.0])


def printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


def entry_points_rank(rank, world, rdv):
    from torch.distributed.device_mesh import init_device_mesh
    from colaborativempc_tpu_torch.parallel import initialize_distributed
    initialize_distributed("cpu", init_method=rdv, rank=rank,
                           world_size=world)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("races",))
    cfg = MPCCConfig(**BAT_CFG)
    track = make_track(cfg.map_type, device="cpu")
    res = tbat.run_mpcc_battery(cfg, grid(), BAT_STEPS, track=track,
                                device="cpu", mesh=mesh)
    try:
        tbat.run_mpcc_battery(cfg, grid()[:3], 1, track=track, device="cpu",
                              mesh=mesh)
        odd = None
    except ValueError as e:
        odd = str(e)
    return dict(battery=res._asdict(), odd=odd,
                lpv=printed(monte_carlo.main, MC_LPV + ["--mesh", "2x1"]),
                nl=printed(monte_carlo.main, MC_NL + ["--mesh", "1x2"]))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(entry_points_rank, 2, tmp_path_factory.mktemp("entry"))


def test_mpcc_battery_on_a_mesh_equals_the_battery_without(ranks):
    cfg = MPCCConfig(**BAT_CFG)
    ref = tbat.run_mpcc_battery(cfg, grid(), BAT_STEPS,
                                track=make_track(cfg.map_type, device="cpu"),
                                device="cpu")
    for r in ranks:
        got = r["battery"]
        for f in tbat.MPCCBatteryResult._fields:
            np.testing.assert_array_equal(got[f], getattr(ref, f),
                                          err_msg=f)
        assert r["odd"] == "grid size 3 must divide the mesh (2 devices)"


@pytest.mark.parametrize("pipeline,argv", [("lpv", MC_LPV), ("nl", MC_NL)])
def test_monte_carlo_mesh_prints_the_report_of_the_run_without(
        ranks, pipeline, argv):
    ref = printed(monte_carlo.main, argv)
    got = ranks[0][pipeline]
    assert "mesh" in got[0] and ranks[1][pipeline] == []
    assert got[1:] == ref[1:]
    assert len(ref) == (5 if pipeline == "nl" else 4)


def test_monte_carlo_mesh_refuses_a_mismatch(monkeypatch):
    import importlib
    jmc = importlib.import_module("colaborativempc_tpu.scripts.monte_carlo")
    argv = ["--scenarios", "4", "--agents", "2", "--mesh", "3x1"]
    monkeypatch.setattr(sys, "argv", ["x"] + argv)
    with pytest.raises(SystemExit) as ref:
        jmc.main()
    with pytest.raises(SystemExit) as got:
        monte_carlo.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(ref.value)
    assert "must divide the axes" in str(got.value)
    with pytest.raises(SystemExit, match="needs 2 ranks"):
        monte_carlo.main(MC_LPV + ["--mesh", "2x1"])
