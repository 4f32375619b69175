"""CPU tests of the CUDA kernels' Python side and of their algebra.

- The port's entry points and builders default to the card and raise
  without one.
- ``ops/cuda_lqr.py kernel_plan``: QPs per block, ring depth and
  shared-memory bytes at the shapes the planners hand the kernels;
  ``epoch_data_plan``: the epoch-data kernel's threads, chunk of stages,
  shared memory (the source's formula) and waves, and the dimensions it
  refuses.
- The closed-loop form of the sweeps (``A_cl = F + G K``,
  ``D_cl = D + E K``, the feedforward off the chain: one matvec per chain
  step), written here in float64 numpy, against the plain twins
  ``admm_epoch_batched_plain`` and ``lqr_affine_solve_batched_plain``
  within 1e-10, on random QPs with ``hi = +inf`` rows, hard rows
  (``fac = 0``) and unbounded rows (``rv = 0``). The form is exact; the
  kernels keep the explicit form all the same, because in float32 the
  closed-loop form moves rounding enough to take the NL hp_opt /
  Gauss-Seidel check of ``chip_smoke.py`` out of its tolerance (PERF.md).
"""

import inspect

import numpy as np
import pytest
import torch

from colaborativempc_tpu_torch import config as tcfg
from colaborativempc_tpu_torch import interop
from colaborativempc_tpu_torch.ops import (
    LQRCost, LQRDynamics, StageQP, admm_epoch_inputs, cuda_lqr,
)
from colaborativempc_tpu_torch.ops.cuda_lqr import (
    H100_SMS, SMEM_PER_BLOCK, epoch_data_floats, epoch_data_plan,
    epoch_data_registers, epoch_data_stage_floats, epoch_data_threads,
    kernel_plan, qp_floats,
)
from colaborativempc_tpu_torch.geometry import make_track, spline
from colaborativempc_tpu_torch.parallel import (
    batch_fleet_state, initialize_distributed,
)
from colaborativempc_tpu_torch.planners.mpcc import MPCCConfig, MPCCGains
from colaborativempc_tpu_torch.runtime import (
    battery, ocd, racing, simulate,
)
from colaborativempc_tpu_torch.scripts import (
    bench_suite, compare_reference, epoch_f64, eval_lpv_model,
    experiment_battery, fleet_f64, lpv_main, monte_carlo, mpcc_main, nl_main,
    stress_study,
)

# a small fixed thread count: the suite runs several worker processes on
# one host
torch.set_num_threads(2)

F64 = torch.float64


# --- entry points default to the card ------------------------------------

def _cfg(gains):
    return tcfg.ExperimentConfig(n_agents=2, N=6, max_it=1, gains=gains)


ENTRY_POINTS = {
    "run_lpv_experiment": (simulate.run_lpv_experiment,
                           lambda: (_cfg(tcfg.lpv_gains()),), {}),
    "run_nl_experiment": (ocd.run_nl_experiment,
                          lambda: (_cfg(tcfg.nl_gains()),), {}),
    "run_lpv_battery": (battery.run_lpv_battery,
                        lambda: (_cfg(tcfg.lpv_gains()),
                                 [tcfg.lpv_gains()], 1), {}),
    "run_nl_battery": (battery.run_nl_battery,
                       lambda: (_cfg(tcfg.nl_gains()),
                                [tcfg.nl_gains()], 1), {}),
    "monte_carlo.setup": (monte_carlo.setup, lambda: ("nl",),
                          dict(scenarios=2, agents=2, N=6, steps=1)),
    "run_mpcc_experiment": (racing.run_mpcc_experiment,
                            lambda: (MPCCConfig(N=6, n_sim=1),), {}),
    "run_mpcc_battery": (battery.run_mpcc_battery,
                         lambda: (MPCCConfig(N=6), [MPCCGains()], 1), {}),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_cuda_and_raises_without_a_card(
        name, monkeypatch):
    fn, args, kw = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(*args(), **kw)


def _cpu_track():
    return make_track("Highway", device="cpu")


def _track_json(tmp_path):
    path = tmp_path / "track.json"
    th = np.linspace(0, 2 * np.pi, 60, endpoint=False)
    path.write_text('{"X": %s, "Y": %s}' % (list(2 * np.cos(th)),
                                            list(2 * np.sin(th))))
    return str(path)


BUILDERS = {
    "make_track": lambda tmp: make_track("Highway"),
    "init_lpv_fleet": lambda tmp: simulate.init_lpv_fleet(
        _cpu_track(), _cfg(tcfg.lpv_gains())),
    "init_nl_fleet": lambda tmp: ocd.init_nl_fleet(
        _cpu_track(), _cfg(tcfg.nl_gains())),
    "batch_fleet_state": lambda tmp: batch_fleet_state(
        simulate.init_lpv_fleet(_cpu_track(), _cfg(tcfg.lpv_gains()),
                                device="cpu"), 2),
    "load_mpcc_track": lambda tmp: racing.load_mpcc_track(MPCCConfig()),
    "init_mpcc": lambda tmp: racing.init_mpcc(
        make_track("oval_mt", device="cpu"), MPCCConfig(N=6)),
    "fit_centerline": lambda tmp: spline.fit_centerline(
        2 * np.cos(np.linspace(0, 6, 50)), 2 * np.sin(np.linspace(0, 6, 50))),
    "track_from_json": lambda tmp: spline.track_from_json(_track_json(tmp)),
    # the interop converters, fed the port's own records as numpy
    "track_from_numpy": lambda tmp: interop.track_from_numpy(
        interop.to_numpy(_cpu_track())),
    "gains_from_numpy": lambda tmp: interop.gains_from_numpy(
        tcfg.lpv_gains()),
    "fleet_state_from_numpy": lambda tmp: interop.fleet_state_from_numpy(
        interop.to_numpy(simulate.init_lpv_fleet(
            _cpu_track(), _cfg(tcfg.lpv_gains()), device="cpu"))),
    "ocd_state_from_numpy": lambda tmp: interop.ocd_state_from_numpy(
        interop.to_numpy(ocd.init_nl_fleet(
            _cpu_track(), _cfg(tcfg.nl_gains()), device="cpu"))),
    "stage_qp_from_numpy": lambda tmp: interop.stage_qp_from_numpy(
        interop.to_numpy(random_qps(0, P=1, N=3)[0])),
    "epoch_data_from_numpy": lambda tmp: interop.epoch_data_from_numpy(
        interop.to_numpy(admm_epoch_inputs(random_qps(0, P=1, N=3)[0]))),
    "mpcc_state_from_numpy": lambda tmp: interop.mpcc_state_from_numpy(
        interop.to_numpy(racing.init_mpcc(
            make_track("oval_mt", device="cpu"), MPCCConfig(N=6),
            device="cpu")), batched=True),
    # joins no group: the missing card raises first
    "initialize_distributed": lambda tmp: initialize_distributed(
        init_method=f"file://{tmp}/rendezvous", rank=0, world_size=1),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_defaults_to_cuda_and_raises_without_a_card(
        name, monkeypatch, tmp_path):
    """The builders a user starts from, and the converters that carry a
    state across from the JAX package, place their tensors on the card
    unless asked for the CPU, and raise without one."""
    build = BUILDERS[name]
    if name.endswith("_from_numpy"):
        fn = getattr(interop, name)
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(tmp_path)


@pytest.mark.parametrize("script,argv", [
    (monte_carlo, ["--pipeline", "nl", "--scenarios", "2", "--agents", "2",
                   "--N", "6", "--steps", "1"]),
    (nl_main, ["--agents", "2", "--N", "6", "--steps", "1", "--verb", "0",
               "--out", "{out}"]),
    (mpcc_main, ["--N", "6", "--steps", "1", "--verb", "0", "--out",
                 "{out}", "--save"]),
    (lpv_main, ["--agents", "2", "--N", "6", "--steps", "1", "--verb", "0",
                "--out", "{out}"]),
    (experiment_battery, ["--pipeline", "lpv", "--agents", "2", "--N", "6",
                          "--steps", "1"]),
    (stress_study, ["latency", "--n", "6", "--steps", "1"]),
    (eval_lpv_model, ["{out}"]),
    (compare_reference, ["--ref", "{out}", "--steps", "1"]),
    (bench_suite, ["--tiny"]),
])
def test_script_main_defaults_to_cuda_and_raises_without_a_card(
        script, argv, monkeypatch, tmp_path):
    """Every compute script runs on the card unless given --device cpu,
    and raises without one before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a.replace("{out}", str(tmp_path / "out")) for a in argv]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main(argv)
    assert not (tmp_path / "out").exists()


def test_fleet_f64_ratios_per_scenario_and_script_without_a_card(
        monkeypatch):
    """``scripts/fleet_f64.py``'s ratios (phase 22's hold on LPV 32
    agents): of the max over the batch and of the mean over the scenarios
    of each one's max |dx| from float64; its main needs a card."""
    f64 = torch.zeros(2, 3, 4)
    card, cpu = f64.clone(), f64.clone()
    card[0, 1, 2], card[1, 0, 0] = 0.3, -0.1    # per scenario 0.3, 0.1
    cpu[0, 2, 3], cpu[1, 2, 1] = 0.1, 0.1       # per scenario 0.1, 0.1
    r = fleet_f64.f64_ratios(card, cpu, f64.double())
    assert r["card_vs_f64"] == pytest.approx(0.3)
    assert r["ratio_max"] == pytest.approx(3.0)
    assert r["card_vs_f64_mean"] == pytest.approx(0.2)
    assert r["ratio_mean"] == pytest.approx(2.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        fleet_f64.main(["--seeds", "0"])


def test_epoch_f64_distances_and_script_without_a_card(monkeypatch):
    """``scripts/epoch_f64.py``'s distances (chip_smoke.py's float64 hold
    on the epoch's residuals at the spill shapes): the kernel's from the
    twin, and each one's from float64 over the batch and in the mean over
    the QPs of each QP's max; its main needs a card."""
    f64 = [torch.zeros(2, 3) for _ in epoch_f64.FIELDS]
    twin = [t.clone() for t in f64]
    kernel = [t.clone() for t in f64]
    kernel[5][0, 1], kernel[5][1, 2] = 0.3, -0.1      # r_dual per QP
    twin[5][0, 0] = 0.1
    d = epoch_f64.f64_distances(kernel, twin, f64)
    assert set(d) == set(epoch_f64.FIELDS) and d["z"]["kernel_f64"] == 0
    assert d["rd"]["kernel_twin"] == pytest.approx(0.3)
    assert d["rd"]["kernel_f64"] == pytest.approx(0.3)
    assert d["rd"]["kernel_f64_mean"] == pytest.approx(0.2)
    assert d["rd"]["twin_f64_mean"] == pytest.approx(0.05)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        epoch_f64.main(["--seeds", "0"])


# --- launch plans -----------------------------------------------------------

# (P, N, nz, nc, mr): the LPV headline epoch, the NL B=64 Monte-Carlo, the
# hp_opt rows, the long horizon, one QP, a batch that is no multiple of
# the QPs per block, the affine solve (mr = 0), and hp_opt at N=125, whose
# horizon does not fit in a block.
PLAN_SHAPES = {
    "lpv_headline": (768, 20, 11, 2, 6),
    "nl_b64": (192, 20, 11, 2, 6),
    "hp_opt": (768, 20, 11, 6, 10),
    "n125": (768, 125, 11, 2, 6),
    "p1": (1, 20, 11, 2, 6),
    "p7": (7, 20, 11, 2, 6),
    "affine_n125": (768, 125, 11, 2, 0),
    "hp_opt_n125": (768, 125, 11, 6, 10),
}


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_kernel_plan_fits_and_keeps_the_horizon_resident_when_it_can(name):
    """Under 227 KB per block; the ring equal to N where every QP's horizon
    fits on the card at once (one wave), else a ring shorter than N that
    needs no more waves than the resident horizon would."""
    P, N, nz, nc, mr = PLAN_SHAPES[name]
    plan = kernel_plan(P, N, nz, nc, mr)
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan.smem_bytes == (plan.qps_per_block * 4
                               * qp_floats(N, plan.ring, nz, nc, mr))
    assert 1 <= plan.qps_per_block <= 4 and plan.waves >= 1
    if 4 * qp_floats(N, N, nz, nc, mr) > SMEM_PER_BLOCK:
        assert plan.ring < N
    else:
        resident = kernel_plan(P, N, nz, nc, mr, ring=N)
        assert (plan.ring == N) == (resident.waves == 1)
        assert plan.waves <= resident.waves
    if name in ("lpv_headline", "nl_b64", "p1", "p7"):
        assert plan.ring == N and plan.waves == 1
    if name in ("n125", "affine_n125", "hp_opt_n125"):
        assert plan.ring < N and plan.waves == 1


def test_kernel_plan_pins_a_ring_and_a_ragged_block():
    """A pinned ring shorter than N streams in two slots; 4 QPs per block
    at P=7 leave the second block one warp short."""
    full = kernel_plan(768, 125, 11, 2, 6, ring=125)
    ring = kernel_plan(768, 125, 11, 2, 6, ring=8)
    assert full.ring == 125 and full.waves > 1 and ring.ring == 8
    assert ring.smem_bytes == ring.qps_per_block * 4 * qp_floats(
        125, 8, 11, 2, 6)
    rag = kernel_plan(7, 20, 11, 2, 6, qps_per_block=4)
    assert rag.qps_per_block == 4 and 7 % rag.qps_per_block != 0
    # a pinned ring of the whole 1000-stage horizon fits only with the
    # ring read where it lies; pinned in shared memory, it raises
    assert kernel_plan(4, 1000, 11, 2, 6, ring=1000).spilled == \
        "horizon+ring"
    with pytest.raises(ValueError, match="no launch plan fits"):
        kernel_plan(4, 1000, 11, 2, 6, ring=1000, spill=0)


@pytest.mark.parametrize("nz, nc, mr, N, match", [
    (33, 2, 6, 20, "nz=33"),              # one lane per state row
    (11, 0, 6, 20, "nc=0"),               # a dimension below 1
])
def test_kernel_plan_refuses_what_the_epoch_kernel_does_not_take(
        nz, nc, mr, N, match):
    """Past 32 states and below one control the plan raises a ValueError
    that names the dimensions; the wrappers never fall back. (Past the
    block's shared memory it spills: the test below.)"""
    with pytest.raises(ValueError, match=match):
        kernel_plan(8, N, nz, nc, mr)


# The plans the kernels took before the plans could spill (kernel_plan,
# epoch_data_plan and sqp_qp_plan of the parent commit, at the shapes this
# file lists), as tuples of their fields then: every one is kept, field
# for field, with nothing spilled.
PARENT_KERNEL_PLANS = {
    "lpv_headline": (3, 20, 90876, 1), "nl_b64": (1, 20, 30292, 1),
    "hp_opt": (4, 4, 89616, 1), "n125": (3, 8, 88164, 1),
    "p1": (4, 20, 121168, 1), "p7": (1, 20, 30292, 1),
    "affine_n125": (3, 16, 94548, 1), "hp_opt_n125": (3, 4, 99972, 1),
}
PARENT_DATA_PLANS = {
    "lpv_headline": (192, 8, 46112, 4, 2), "hp_opt": (288, 8, 61728, 2, 3),
    "mpcc_race": (192, 8, 46112, 4, 1), "mpcc_battery": (192, 8, 46112, 4, 1),
    "n125": (192, 8, 46112, 4, 2), "p4096": (192, 8, 46112, 4, 8),
    "nz32": (1024, 2, 183552, 1, 1), "lpv_32_agents": (192, 8, 93328, 2, 1),
    "hp_opt_11_agents": (896, 4, 128160, 1, 1),
    "hp_opt_16_agents": (1024, 4, 225024, 1, 1),
    "hp_opt_17_agents": (1024, 2, 124448, 1, 1),
    "hp_opt_32_agents": (1024, 1, 195520, 1, 1),
    "hp_opt_16_agents_n125": (1024, 4, 225024, 1, 1),
    "nz40": (1024, 4, 184432, 1, 1),
}
# (nb, coupling) of 4 problems at N=20 on a track of 1000 segments; MPCC
# (18 races); NL eu at the Monte-Carlo's 192 QPs on a 10-segment track
PARENT_SQP_PLANS = {
    (8, "hp_opt"): (256, 8, 12, 77320), (19, "hp_opt"): (256, 8, 12, 217196),
    (20, "hp_opt"): (256, 7, 12, 206064), (31, "hp_opt"): (256, 3, 28, 179528),
    (63, "hp_opt"): (256, 1, 80, 205056), (31, "eu"): (256, 8, 12, 53124),
    (300, "eu"): (256, 5, 16, 194848), "mpcc": (256, 8, 54, 25856),
    "nl_eu_192": (256, 8, 576, 14216),
}


def test_plans_that_fit_keep_the_parent_plans():
    """Where a launch fits in shared memory, each plan is the one the
    kernels took before the spill, field for field, and spills nothing."""
    from colaborativempc_tpu_torch.ops import cuda_sqp
    for name, old in PARENT_KERNEL_PLANS.items():
        assert tuple(kernel_plan(*PLAN_SHAPES[name])) == old + ("", 0), name
    for name, old in PARENT_DATA_PLANS.items():
        assert tuple(epoch_data_plan(*DATA_PLAN_SHAPES[name])) == \
            old + ("", 0), name
    for key, old in PARENT_SQP_PLANS.items():
        if key == "mpcc":
            plan = cuda_sqp.sqp_qp_plan(18, 20, 2, 7, 1000)
        elif key == "nl_eu_192":
            plan = cuda_sqp.sqp_qp_plan(192, 20, 2, 6, 10, 2, False)
        else:
            nb, coupling = key
            plan = cuda_sqp.sqp_qp_plan(4, 20, *cuda_sqp.nl_shape(
                nb, coupling), 1000, nb, coupling == "hp_opt")
        assert tuple(plan) == old + ("", 0), key


# Past one block's shared memory, (P = agents of one fleet, N, nc, mr) and
# the spill level the epoch plan takes: NL hp_opt 31 and 36 agents at
# N=125 and 45 at N=20 (w, y and kff), 48 at N=20 (the ring too), hp_opt
# 32 agents at N=125 (which raised before), LPV 200 agents at N=125 and
# 760 at N=20, hp_opt 100 agents at N=125, and a row count no chunk of
# shared memory holds
EPOCH_SPILLS = {
    "hp_opt_31_agents_n125": ((31, 125, 62, 94), "horizon"),
    "hp_opt_36_agents_n125": ((36, 125, 72, 109), "horizon"),
    "hp_opt_45_agents": ((45, 20, 90, 136), "horizon"),
    "hp_opt_48_agents": ((48, 20, 96, 145), "horizon+ring"),
    "hp_opt_32_agents_n125": ((32, 125, 64, 97), "horizon"),
    "lpv_200_agents_n125": ((200, 125, 2, 203), "horizon"),
    "lpv_760_agents": ((760, 20, 2, 763), "horizon"),
    "hp_opt_100_agents_n125": ((100, 125, 200, 301), "horizon+ring"),
    "rows_60000": ((8, 20, 2, 60_000), "horizon+ring+chunk"),
}


@pytest.mark.parametrize("name", sorted(EPOCH_SPILLS))
def test_kernel_plan_spills_past_shared_memory(name):
    """Where no plan fits a block's shared memory, the plan keeps the
    first spill level at which one fits and names it; its shared memory
    is the source's carve at that level, and its scratch kff over the
    horizon (and each QP's work at the last level). No level below fits.
    The affine kernel (mr = 0) spills no further than the epoch."""
    (P, N, nc, mr), level = EPOCH_SPILLS[name]
    plan = kernel_plan(P, N, 11, nc, mr)
    assert plan.spilled == level
    L = cuda_lqr.SPILLS.index(level)
    assert plan.spill == L
    per_qp = 4 * qp_floats(N, plan.ring, 11, nc, mr, L)
    assert plan.smem_bytes == (0 if L == 3 else plan.qps_per_block * per_qp)
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan.scratch_bytes == 4 * P * N * nc + (P * per_qp if L == 3
                                                   else 0)
    for lower in range(L):
        with pytest.raises(ValueError, match="no launch plan fits"):
            kernel_plan(P, N, 11, nc, mr, spill=lower)
    assert kernel_plan(P, N, 11, nc, 0).spill <= L


@pytest.mark.parametrize("N", [20, 125])
def test_every_plan_takes_the_fleets_past_shared_memory(N):
    """No size limit on the card but device memory: the epoch and affine
    plans, the epoch-data plan and the NL build's plan each return a plan
    that fits its block, spilled where it must, for NL hp_opt fleets of 31
    to 100 agents and LPV / NL eu fleets of 700 to 1,000 agents (one
    fleet's QPs, on a staged track of 1000 segments)."""
    from colaborativempc_tpu_torch.ops import cuda_sqp
    fleets = [(a, "hp_opt") for a in range(31, 101)]
    fleets += [(a, "eu") for a in range(700, 1001, 60)]
    spilled = set()
    for agents, coupling in fleets:
        nb = agents - 1
        nc, m = cuda_sqp.nl_shape(nb, coupling)
        if coupling == "eu":
            nc, m = 2, agents + 3      # LPV's rows: 4 + the neighbours
        for mr in (m, 0):
            plan = kernel_plan(agents, N, 11, nc, mr)
            assert plan.smem_bytes <= SMEM_PER_BLOCK
            spilled.add(plan.spilled)
        plan = epoch_data_plan(agents, N, 11, nc, m)
        assert plan.smem_bytes <= SMEM_PER_BLOCK
        spilled.add(plan.spilled)
        nc, m = cuda_sqp.nl_shape(nb, coupling)
        plan = cuda_sqp.sqp_qp_plan(agents, N, nc, m, 1000, nb,
                                    coupling == "hp_opt")
        assert plan.smem_bytes <= cuda_sqp.SQP_SMEM_LIMIT
        spilled.add(plan.spilled)
    assert {"horizon", "horizon+ring", "block", "image"} <= spilled


def test_qp_floats_mirror_the_source():
    """``qp_floats`` is the source's ``qp_floats`` (its three statements,
    read from ``csrc/lqr_kernels.cu``) at every spill level, resident and
    streamed rings, with rows and without (the affine solve), and the
    levels are the source's ``Spill``."""
    import re
    from pathlib import Path
    src = (Path(cuda_lqr.__file__).resolve().parent.parent / "csrc"
           / "lqr_kernels.cu").read_text()
    body = re.search(r"inline int qp_floats\([^)]*\) \{(.*?)\n\}", src,
                     re.S).group(1)
    stmts = [" ".join(x.split()) for x in body.split(";") if x.strip()]
    names = re.search(r"enum Spill \{([^}]*)\}", src).group(1)
    levels = {k.strip(): int(v) for k, v in
              (x.split("=") for x in names.split(","))}
    assert list(levels.values()) == list(range(len(cuda_lqr.SPILLS)))

    for N, ring in ((20, 20), (20, 8), (125, 4), (7, 32)):
        for nc, mr in ((2, 6), (34, 52), (2, 0), (96, 145)):
            for spill in range(len(cuda_lqr.SPILLS)):
                env = dict(levels, N=N, ring=ring, nz=11, nc=nc, mr=mr,
                           spill=spill, stage_floats=cuda_lqr.stage_floats)
                S = ring if ring < N else N
                slots = 0 if spill >= 2 else (2 if ring < N else 1)
                horizon = 0 if spill >= 1 else 2 * N * mr + N * nc
                env.update(S=S, slots=slots, horizon=horizon)
                for st in stmts[:3]:
                    name, _, expr = st.partition(" = ")
                    name = name.split()[-1]
                    assert c_ternary(expr, env) == env[name], st
                ret = stmts[3].replace("return ", "")
                assert eval(ret, env) == cuda_lqr.qp_floats(
                    N, ring, 11, nc, mr, spill)


# (P, N, nz, nc, mr) of the epoch-data kernel: the LPV headline, NL hp_opt,
# the MPCC race and battery, the long horizon, a batch past one wave, a
# state of 32 (more entries than a block's threads), and the large fleets:
# LPV 32 agents (mr = 35), NL hp_opt 11, 16, 17 and 32 agents (nc = 22,
# 32, 34, 64; mr = 34, 49, 52, 97), hp_opt 16 at N=125 and a state of 40.
DATA_PLAN_SHAPES = {
    "lpv_headline": (768, 20, 11, 2, 6),
    "hp_opt": (768, 20, 11, 6, 10),
    "mpcc_race": (1, 60, 11, 2, 7),
    "mpcc_battery": (18, 20, 11, 2, 7),
    "n125": (768, 125, 11, 2, 6),
    "p4096": (4096, 20, 11, 2, 6),
    "nz32": (64, 20, 32, 32, 32),
    "lpv_32_agents": (256, 20, 11, 2, 35),
    "hp_opt_11_agents": (22, 20, 11, 22, 34),
    "hp_opt_16_agents": (32, 20, 11, 32, 49),
    "hp_opt_17_agents": (34, 20, 11, 34, 52),
    "hp_opt_32_agents": (64, 20, 11, 64, 97),
    "hp_opt_16_agents_n125": (32, 125, 11, 32, 49),
    "nz40": (8, 20, 40, 4, 12),
}


@pytest.mark.parametrize("name", sorted(DATA_PLAN_SHAPES))
def test_epoch_data_plan_threads_smem_and_waves(name):
    """One block per QP: threads cover the largest of the chain's three
    intervals (P F, P G, m; Qxx, Qxu, Quu; P's upper triangle and Quu_inv's
    columns), each kind of entry in whole warps of its own, at most 1024;
    at most the launch bounds' registers each; stages stream in chunks of
    8, 4, 2 or 1 (at most N), the fewest waves first, then the deeper
    chunk; shared memory of two chunk slots and the work, within 227 KB;
    the waves from the
    blocks resident per SM."""
    P, N, nz, nc, mr = DATA_PLAN_SHAPES[name]
    plan = epoch_data_plan(P, N, nz, nc, mr)

    def w(n):
        return -(-n // 32) * 32
    spaces = (w(nz * nz) + w(nz * nc) + w(nz),
              w(nz * nz) + w(nz * nc) + w(nc * nc),
              w(nz * (nz + 1) // 2) + w(nc))
    assert plan.threads == epoch_data_threads(nz, nc)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.threads == min(1024, max(spaces))
    assert all(plan.threads >= sp for sp in spaces) or plan.threads == 1024
    assert plan.chunk in (8, 4, 2, 1, N) and plan.chunk <= N
    assert plan.smem_bytes == 4 * epoch_data_floats(nz, nc, mr, plan.chunk)
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert 1 <= plan.blocks_per_sm <= 32
    assert plan.blocks_per_sm * plan.threads // 32 <= 64
    assert plan.waves == -(-P // (H100_SMS * plan.blocks_per_sm))
    regs = epoch_data_registers(nz, nc, mr)
    assert plan.blocks_per_sm * regs * plan.threads <= 65_536
    for chunk in (8, 4, 2, 1):
        other = 4 * epoch_data_floats(nz, nc, mr, min(chunk, N))
        if chunk > plan.chunk and other <= SMEM_PER_BLOCK:
            per_sm = min(32, 64 // (plan.threads // 32),
                         233_472 // (other + 1_024),
                         65_536 // (regs * plan.threads))
            assert -(-P // (H100_SMS * per_sm)) > plan.waves
    if name in ("lpv_headline", "n125"):
        assert (plan.threads, plan.chunk, plan.waves) == (192, 8, 2)
    if name in ("mpcc_race", "mpcc_battery"):
        assert (plan.threads, plan.chunk, plan.waves) == (192, 8, 1)
    if name == "hp_opt":
        assert plan.threads == 288 and plan.waves == 3
    if name == "p4096":
        assert plan.chunk == 8 and plan.waves == 8
    if name == "nz32":
        assert plan.threads == 1024 and plan.chunk == 2
    if name == "hp_opt_32_agents":
        assert (plan.threads, plan.chunk, plan.waves) == (1024, 1, 1)


def test_epoch_data_floats_mirror_the_source():
    """``epoch_data_widths``, ``epoch_data_stage_floats`` and
    ``epoch_data_floats`` are the source's ``width_z``, ``width_r``,
    ``data_stage_floats`` and ``data_block_floats``: their return
    expressions, read from ``csrc/epoch_data.cu``, give the same counts, up
    to 32 in every dimension and beyond; the widths are 12 or 32 floats up
    to 32 in every dimension, nz (12 up to 12) and mr rounded up to whole
    float4s beyond."""
    import re
    from pathlib import Path
    src = (Path(cuda_lqr.__file__).resolve().parent.parent / "csrc"
           / "epoch_data.cu").read_text()
    body = lambda name: _c_return(src, name)  # noqa: E731
    assert cuda_lqr.EPOCH_DATA_REG_NC == _c_int(src, "kRegNC")
    widths = {(11, 2, 6): (12, 12), (11, 6, 13): (32, 32),
              (32, 32, 32): (32, 32), (11, 2, 35): (12, 36),
              (11, 64, 97): (12, 100), (40, 4, 12): (40, 12),
              (33, 33, 33): (36, 36)}
    for dims, w in widths.items():
        assert cuda_lqr.epoch_data_widths(*dims) == w, dims
    stage, block = body("data_stage_floats"), body("data_block_floats")
    # stage_floats_of: wz == wr ? A : B, one stage's floats with one width
    # or two, written as Python's conditional
    stage_of = re.sub(r"^(\w+ == \w+) \? (.+) : (.+)$",
                      r"(\2) if (\1) else (\3)",
                      " ".join(re.search(
                          r"stage_floats_of\([^)]*\) \{\s*return ([^;]+);",
                          src).group(1).split()))
    for nz, nc, mr in ((11, 2, 6), (11, 6, 10), (11, 2, 7), (32, 32, 32),
                       (1, 1, 1), (11, 2, 35), (11, 22, 34), (11, 33, 33),
                       (11, 64, 97), (40, 4, 12), (12, 9, 13)):
        env = dict(nz=nz, nc=nc, mr=mr, round4=lambda n: -(-n // 4) * 4,
                   kRegNC=cuda_lqr.EPOCH_DATA_REG_NC)
        env.update(width_z=lambda a, b, c: cuda_lqr.epoch_data_widths(
            a, b, c)[0], width_r=lambda a, b, c: cuda_lqr.epoch_data_widths(
                a, b, c)[1])
        env["stage_floats_of"] = lambda nz, nc, mr, wz, wr: eval(
            stage_of, dict(env, nz=nz, nc=nc, mr=mr, wz=wz, wr=wr))
        assert eval(stage, env) == epoch_data_stage_floats(nz, nc, mr)
        for chunk in (1, 2, 4, 8):
            env.update(chunk=chunk, data_stage_floats=(
                lambda a, b, c: epoch_data_stage_floats(a, b, c)))
            assert eval(block, env) == epoch_data_floats(nz, nc, mr, chunk)


def c_ternary(expr: str, env: dict) -> int:
    """Evaluate a C expression of nested ``cond ? a : b`` (nested in the
    else branch only) with ``&&``."""
    expr = expr.strip()
    while expr.startswith("(") and expr.endswith(")"):
        expr = expr[1:-1].strip()
    cond, _, rest = expr.partition("?")
    if not rest:
        return eval(expr, env)
    then, _, other = rest.partition(":")
    taken = eval(cond.replace("&&", " and "), env)
    return c_ternary(then if taken else other, env)


def test_epoch_data_launch_bounds_mirror_the_source():
    """``epoch_data_registers`` is the cap that the kernel's
    ``__launch_bounds__`` (max threads, min blocks), read from
    ``csrc/epoch_data.cu``, set for the instantiation that ``launch``
    picks (nc <= 2 / 8 with rows of 12 or 32 floats up to 32 in every
    dimension, of runtime widths beyond; nc > 8 the factor in shared
    memory, runtime widths): 64 K registers over threads x blocks, down to
    a multiple of 8. And every nz, nc, mr in 1..32, and the large fleets'
    shapes beyond, launch ``epoch_data_threads`` within that bound."""
    import re
    from pathlib import Path
    src = (Path(cuda_lqr.__file__).resolve().parent.parent / "csrc"
           / "epoch_data.cu").read_text()
    args = re.search(r"__launch_bounds__\((.*?)\)\s*epoch_data_kernel",
                     src.replace("__global__ void ", ""), re.S)
    assert args is not None
    max_threads, min_blocks = args.group(1).split(",")
    seen = set()
    dims = [(nz, nc, mr) for nz in range(1, 33) for nc in range(1, 33)
            for mr in range(1, 33)]
    dims += [(11, 2, 35), (11, 8, 40), (11, 22, 34), (11, 64, 97),
             (40, 4, 12), (33, 33, 33)]
    for nz, nc, mr in dims:
        wide = max(nz, nc, mr) > 32
        width = cuda_lqr.epoch_data_widths(nz, nc, mr)[0]
        env = dict(NC=2 if nc <= 2 else 8 if nc <= 8 else 0,
                   DIM=0 if wide or nc > 8 else width)
        threads = c_ternary(max_threads, env)
        blocks = c_ternary(min_blocks, env)
        assert epoch_data_threads(nz, nc) <= threads, (nz, nc, mr)
        cap = cuda_lqr.REGISTERS_PER_SM // (threads * blocks) // 8 * 8
        assert cuda_lqr.epoch_data_registers(nz, nc, mr) == cap
        seen.add((env["NC"], env["DIM"], cap))
    assert seen == {(2, 12, 72), (8, 12, 96), (2, 32, 64), (8, 32, 64),
                    (0, 0, 64), (2, 0, 64), (8, 0, 64)}


@pytest.mark.parametrize("P,N,nz,nc,mr", [(0, 20, 11, 2, 6),
                                           (8, 0, 11, 2, 6),
                                           (8, 20, 11, 0, 6),
                                           (8, 20, 11, 2, 0)])
def test_epoch_data_plan_refuses_what_the_kernel_does_not_take(P, N, nz, nc,
                                                               mr):
    """Sizes below 1 raise a ValueError that names the dimensions (no
    fallback to the plain version); past the block's shared memory the
    plan spills (the test below)."""
    with pytest.raises(ValueError, match="epoch-data kernel") as err:
        epoch_data_plan(P, N, nz, nc, mr)
    assert f"nc={nc}, mr={mr}" in str(err.value)


# (P, N, nz, nc, mr) past one block's shared memory at one stage per
# chunk: the two sizes that raised before the spill (1200 rows; 130
# controls and 193 rows), NL hp_opt 36 and 48 agents (also 36 at N=125),
# LPV 1000 agents, hp_opt 100 agents at N=125
DATA_SPILLS = {
    "rows_1200": (8, 20, 11, 2, 1200),
    "nc130_mr193": (8, 20, 11, 130, 193),
    "hp_opt_36_agents": (36, 20, 11, 72, 109),
    "hp_opt_48_agents": (48, 20, 11, 96, 145),
    "hp_opt_36_agents_n125": (36, 125, 11, 72, 109),
    "lpv_1000_agents": (1000, 20, 11, 2, 1003),
    "hp_opt_100_agents_n125": (100, 125, 11, 200, 301),
}


@pytest.mark.parametrize("name", sorted(DATA_SPILLS))
def test_epoch_data_plan_spills_past_shared_memory(name):
    """Where the block does not fit in shared memory even at one stage per
    chunk, the plan spills the block's whole layout to a global scratch:
    one stage per chunk, no dynamic shared memory, a scratch of one
    layout per block (the source's ``data_block_floats``), the threads
    and register cap of the unspilled plan; pinned off, it raises. A
    spill pinned where the kernel's rows have a fixed width raises."""
    P, N, nz, nc, mr = DATA_SPILLS[name]
    assert 4 * epoch_data_floats(nz, nc, mr, 1) > SMEM_PER_BLOCK
    plan = epoch_data_plan(P, N, nz, nc, mr)
    assert plan.spilled == "block" and plan.chunk == 1
    assert plan.smem_bytes == 0
    assert plan.scratch_bytes == 4 * P * epoch_data_floats(nz, nc, mr, 1)
    assert plan.threads == epoch_data_threads(nz, nc)
    regs = epoch_data_registers(nz, nc, mr)
    assert plan.blocks_per_sm == min(32, 64 // (plan.threads // 32),
                                     65_536 // (regs * plan.threads))
    with pytest.raises(ValueError, match="pinned off"):
        epoch_data_plan(P, N, nz, nc, mr, spill=False)
    with pytest.raises(ValueError, match="runtime width"):
        epoch_data_plan(P, N, 11, 2, 6, spill=True)


@pytest.mark.parametrize("nz,nc,mr", [(11, 2, 33), (11, 33, 33),
                                      (33, 2, 6), (11, 64, 97)])
def test_epoch_data_plan_takes_every_width_that_fits(nz, nc, mr):
    """Past 32 rows, controls or states the plan holds: one block of at
    most 1024 threads per QP within the block's shared memory."""
    plan = epoch_data_plan(16, 20, nz, nc, mr)
    assert plan.threads <= 1024 and plan.smem_bytes <= SMEM_PER_BLOCK


# --- the closed-loop algebra in float64 --------------------------------------

def random_qps(seed, P, N, nz=11, nc=2, mr=6):
    """P stage QPs banded around a feasible rollout, float64: row 0 soft,
    row 1 one-sided (hi = +inf), row 2 unbounded (rv = 0), the rest hard
    (fac = 0)."""
    rng = np.random.default_rng(seed)
    F = np.eye(nz) + 0.05 * rng.normal(size=(P, N, nz, nz))
    G = 0.2 * rng.normal(size=(P, N, nz, nc))
    d = 0.01 * rng.normal(size=(P, N, nz))
    A = rng.normal(size=(P, N + 1, nz, nz))
    Rm = rng.normal(size=(P, N, nc, nc))
    z0 = rng.normal(size=(P, nz))
    D = 0.5 * rng.normal(size=(P, N, mr, nz))
    E = 0.5 * rng.normal(size=(P, N, mr, nc))
    ct = 0.3 * rng.normal(size=(P, N, nc))
    zs = [z0]
    for k in range(N):
        zs.append(np.einsum("pij,pj->pi", F[:, k], zs[-1])
                  + np.einsum("pij,pj->pi", G[:, k], ct[:, k]) + d[:, k])
    zs = np.stack(zs, 1)
    vt = (np.einsum("pkmi,pki->pkm", D, zs[:, :-1])
          + np.einsum("pkmi,pki->pkm", E, ct))
    lo = vt - rng.uniform(0.05, 0.5, size=vt.shape)
    hi = vt + rng.uniform(0.05, 0.5, size=vt.shape)
    hi[:, :, 1] = np.inf
    lo[:, :, 2], hi[:, :, 2] = -np.inf, np.inf
    soft = np.full(vt.shape, np.inf)
    soft[:, :, 0] = 50.0
    t = lambda a: torch.tensor(a, dtype=F64)  # noqa: E731
    qp = StageQP(
        dyn=LQRDynamics(t(F), t(G), t(d)),
        cost=LQRCost(t(0.1 * A @ np.swapaxes(A, -1, -2) + np.eye(nz)),
                     t(0.5 * rng.normal(size=(P, N + 1, nz))),
                     t(0.1 * Rm @ np.swapaxes(Rm, -1, -2) + np.eye(nc)),
                     t(0.5 * rng.normal(size=(P, N, nc))),
                     t(0.05 * rng.normal(size=(P, N, nz, nc)))),
        D=t(D), E=t(E), lo=t(lo), hi=t(hi), soft_lo=t(soft), soft_hi=t(soft))
    w0 = np.clip(0.1 * rng.normal(size=vt.shape), lo, hi)
    y0 = 0.05 * rng.normal(size=vt.shape)
    return qp, t(z0), t(w0), t(y0)


def _mv(A, x):
    return np.einsum("...ij,...j->...i", A, x)


def _mtv(A, x):
    return np.einsum("...ji,...j->...i", A, x)


def closed_loop(data, z0, w0, y0, epoch_len, alpha, rows=True):
    """The closed-loop sweeps, in float64 numpy: the chain of each sweep is
    one matvec with A_cl (or A_cl'); the feedforward kff, the affine terms
    and the rows are computed off it."""
    f = {k: v.numpy() for k, v in data._asdict().items()}
    F, G, K, Qi, E = f["F"], f["G"], f["K"], f["Quu_inv"], f["E"]
    N = F.shape[1]
    Acl = F + G @ K
    Dcl = f["D"] + E @ K
    cst = f["q"][:, :N] + _mtv(K, f["r"]) + _mtv(Acl, f["m"])
    rr = f["r"] + _mtv(G, f["m"])
    z0 = z0.numpy()
    if rows:
        w, y = w0.numpy(), y0.numpy()
        mask = (f["rv"] > 0).astype(float)
    for _ in range(epoch_len):
        t = f["rv"] * (y - w) if rows else None
        g = cst + _mtv(Dcl, t) if rows else cst
        p = f["q"][:, N]
        ps = [None] * (N + 1)
        ps[N] = p
        for k in range(N - 1, -1, -1):
            p = _mtv(Acl[:, k], p) + g[:, k]
            ps[k] = p
        pnext = np.stack(ps[1:], 1)
        qu = rr + _mtv(G, pnext)
        kff = -_mv(Qi, qu + _mtv(E, t) if rows else qu)
        e = f["d"] + _mv(G, kff)
        z = z0
        zs = [z]
        for k in range(N):
            z = _mv(Acl[:, k], z) + e[:, k]
            zs.append(z)
        z = np.stack(zs, 1)
        c = _mv(K, z[:, :N]) + kff
        if not rows:
            return z, c
        v = _mv(Dcl, z[:, :N]) + _mv(E, kff)
        vhat = alpha * v + (1.0 - alpha) * w
        wbar = vhat + y
        with np.errstate(invalid="ignore"):
            wn = np.where(wbar > f["hi"],
                          f["hi"] + f["fac_hi"] * (wbar - f["hi"]), wbar)
            wn = np.where(wbar < f["lo"],
                          f["lo"] + f["fac_lo"] * (wbar - f["lo"]), wn)
        y = y + vhat - wn
        rp = np.max(np.abs(mask * (v - wn)), axis=1)
        rd = np.max(np.abs(mask * (wn - w)), axis=1)
        w = wn
    return z, c, w, y, rp, rd


@pytest.mark.parametrize("nc,mr,epoch_len", [(2, 6, 1), (2, 6, 7),
                                             (6, 10, 5)])
def test_closed_loop_epoch_matches_plain_twin_f64(nc, mr, epoch_len):
    qp, z0, w0, y0 = random_qps(10 + nc + epoch_len, P=4, N=9, nc=nc, mr=mr)
    data = admm_epoch_inputs(qp, rho=10.0, rho_scale=torch.tensor(
        np.linspace(0.5, 2.0, mr), dtype=F64))
    assert bool((data.rv == 0).any()) and bool(torch.isinf(data.hi).any())
    assert bool((data.fac_lo == 0).any())
    ref = cuda_lqr.admm_epoch_batched_plain(data, z0, w0, y0,
                                            epoch_len=epoch_len, alpha=1.6)
    got = closed_loop(data, z0, w0, y0, epoch_len, 1.6)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r.numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("nc,N", [(2, 9), (6, 13)])
def test_closed_loop_affine_matches_plain_twin_f64(nc, N):
    qp, z0, _, _ = random_qps(30 + N, P=3, N=N, nc=nc)
    d = admm_epoch_inputs(qp)
    ref = cuda_lqr.lqr_affine_solve_batched_plain(
        d.F, d.G, d.d, d.K, d.Quu_inv, d.Qxu, d.m, d.q, d.r, z0)
    got = closed_loop(d, z0, None, None, 1, 0.0, rows=False)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r.numpy(), rtol=0, atol=1e-10)


def test_epoch_data_float_division_is_exact_where_the_kernel_divides():
    """The epoch-data kernel splits flat indices with ``div_small``:
    ``(int)((o + 0.5f) * (1.f / n))`` in single precision. It equals
    ``o // n`` wherever the kernel uses it: n up to nz * nz = 1024 with o
    below 8 stages of n and below 2^16 (a transposed field of one stage:
    hp_opt 100 agents' E has 301 x 200 entries), n up to 32 with o below
    2^20, and a field of nc x nc entries (up to 200 controls) divided by
    its own size over one stage."""
    f32 = np.float32

    def exact(o, n):
        got = ((o.astype(f32) + f32(0.5)) * (f32(1) / f32(n))).astype(
            np.int64)
        return np.array_equal(got, o // n)
    for n in range(1, 1025):
        top = 1 << 20 if n <= 32 else max(8 * n, 1 << 16)
        assert exact(np.arange(top, dtype=np.int64), n), n
    for nc in range(33, 201):
        assert exact(np.arange(nc * nc, dtype=np.int64), nc * nc), nc


# --- the SQP build kernels' launch (csrc/sqp_qp.cu) -------------------------

def _sqp_source() -> str:
    from pathlib import Path
    from colaborativempc_tpu_torch.ops import cuda_sqp
    return (Path(cuda_sqp.__file__).resolve().parent.parent / "csrc"
            / "sqp_qp.cu").read_text()


def _c_int(src: str, name: str) -> int:
    import re
    return int(re.search(r"constexpr int " + name + r" = (\d+);",
                         src).group(1))


def _c_return(src: str, name: str) -> str:
    """The return expression of the source's function ``name``, with its
    C conditionals written as Python's."""
    import re
    m = re.search(name + r"\([^)]*\) \{\s*return ([^;]+);", src)
    expr = " ".join(m.group(1).split())
    return re.sub(r"\(([^()?]+)\?([^():]+):([^()]+)\)",
                  r"((\2) if (\1) else (\3))", expr)


def test_sqp_qp_plan_mirrors_the_source():
    """``cuda_sqp``'s threads, stages per block, staged track segments and
    pair scalars are the source's ``kThreads``, ``kStages``, ``kMaxSeg``
    and ``kPair``; its ``image_floats``, ``neighbour_floats`` and the
    plan's shared memory are the source's ``image_floats``,
    ``neighbour_floats`` and ``smem_bytes`` (their return expressions,
    read from ``csrc/sqp_qp.cu``), which the entry requires of the caller,
    for every (nc, m) the NL couplings take with up to 31 neighbours and
    MPCC's, on tracks of one segment to beyond the staged rows. A build
    takes 8 stages per block where they fit."""
    from colaborativempc_tpu_torch.ops import cuda_sqp
    src = _sqp_source()
    assert cuda_sqp.THREADS == _c_int(src, "kThreads") == 256
    assert cuda_sqp.STAGES_PER_BLOCK == _c_int(src, "kStages") == 8
    assert cuda_sqp.MAX_STAGED_SEGMENTS == _c_int(src, "kMaxSeg")
    assert cuda_sqp.PAIR_FLOATS == _c_int(src, "kPair")
    image, smem = _c_return(src, "image_floats"), _c_return(src, "smem_bytes")
    nbr = _c_return(src, "neighbour_floats")
    shapes = {(nb, c) for nb in list(range(10)) + [15, 16, 31]
              for c in cuda_sqp.COUPLINGS}
    shapes.add((None, "mpcc"))
    for nb, c in sorted(shapes, key=str):
        nc, m = ((cuda_sqp.NC, cuda_sqp.MPCC_ROWS) if nb is None
                 else cuda_sqp.nl_shape(nb, c))
        hp_opt = c == "hp_opt"
        env = dict(kNZ=11, nc=nc, m=m, kMaxSeg=2048, kPair=9,
                   image_floats=cuda_sqp.image_floats)
        for S in range(1, 9):
            e = dict(env, S=S)
            assert eval(image, e) == cuda_sqp.image_floats(nc, m, S)
            if nb is not None:
                assert eval(nbr, dict(e, nb=nb, hp_opt=hp_opt)) == \
                    cuda_sqp.neighbour_floats(nb, hp_opt, S)
        for nseg in (1, 10, 1000, 2048, 2049, 20_000):
            plan = cuda_sqp.sqp_qp_plan(5, 13, nc, m, nseg, nb, hp_opt)
            S = plan.stages
            extra = 0 if nb is None else cuda_sqp.neighbour_floats(
                nb, hp_opt, S)
            assert eval(smem, dict(env, nseg=nseg, extra=extra, S=S)) == \
                plan.smem_bytes <= cuda_sqp.SQP_SMEM_LIMIT
            assert plan.threads == 256 and plan.blocks == -(-13 // S) * 5
            if nb is None or nb <= 16:
                assert S == 8, (nb, c, nseg)
    # hp_opt with 31 neighbours (32 agents) takes 3 stages per block on a
    # staged track of 1000 segments
    assert cuda_sqp.sqp_qp_plan(64, 20, *cuda_sqp.nl_shape(31, "hp_opt"),
                                1000, 31, True).stages == 3


def test_sqp_qp_launch_bounds_mirror_the_source():
    """The kernels' ``__launch_bounds__`` (threads, blocks per SM), read
    from the source: the NL kernel's 5 blocks of 256 threads cap it at 51
    registers and run the NL Monte-Carlo's 192 QPs x N=20 (3 stage groups
    each) in one wave on the H100's 132 SMs; MPCC's 4 blocks cap it at 64
    registers; both within the SM's 2048 threads."""
    import re
    src = _sqp_source().replace("__global__ void ", "")
    bounds = {}
    for name in ("nl_qp_kernel", "mpcc_qp_kernel"):
        m = re.search(r"__launch_bounds__\((\w+), (\d+)\)\s*" + name, src)
        assert m is not None, name
        threads = _c_int(src, m.group(1)) if m.group(1).startswith("k") \
            else int(m.group(1))
        bounds[name] = (threads, int(m.group(2)))
    assert bounds == {"nl_qp_kernel": (256, 5), "mpcc_qp_kernel": (256, 4)}
    for threads, blocks in bounds.values():
        assert threads * blocks <= 2048
    assert 65536 // (256 * 5) == 51 and 65536 // (256 * 4) == 64
    from colaborativempc_tpu_torch.ops import cuda_sqp
    assert cuda_sqp.sqp_qp_plan(192, 20, 2, 6, 10).blocks <= 5 * H100_SMS


def test_sqp_row_threads_build_every_row_once():
    """The NL kernel deals the nine rows of the linearisation to groups of
    eight threads (a thread per stage) on four warps (``row_of``, a table
    of nibbles in the source): every row once, at most three rows per warp
    (so a warp runs at most three cases of the row switch), the heavy rows
    0, 1 and 2 on no more than two warps."""
    import re
    table = int(re.search(r"kRows = 0x([0-9a-f]+)ull", _sqp_source()).group(1),
                16)
    rows = [((table >> (4 * g)) & 15) - 1 for g in range(16)]
    assert sorted(r for r in rows if r >= 0) == list(range(9))
    warps = [[r for r in rows[4 * w:4 * w + 4] if r >= 0] for w in range(4)]
    assert all(len(w) <= 3 for w in warps)
    assert sum(any(r in (0, 1, 2) for r in w) for w in warps) <= 2


def test_sqp_task_division_is_exact_where_the_kernels_divide():
    """The build kernels split a task index into (stage, row) with
    ``div_small``, the epoch-data kernel's float reciprocal: exact for
    every divisor they use (11, nc and m up to 301: hp_opt with 100
    agents, 99 neighbours) over the block's 8 stages."""
    import re
    body = re.search(r"int div_small\(int e, float rcp\) \{\s*return ([^;]+);",
                     _sqp_source()).group(1)
    assert " ".join(body.split()) == "__float2int_rz(((float)e + 0.5f) * rcp)"
    f32 = np.float32
    for d in [11] + list(range(2, 302)):
        e = np.arange(8 * d, dtype=np.int64)
        got = ((e.astype(f32) + f32(0.5)) * (f32(1) / f32(d))).astype(
            np.int64)
        assert np.array_equal(got, e // d), d
