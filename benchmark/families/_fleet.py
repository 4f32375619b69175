"""What the two collaborative fleet families (``lpv.py``, ``nl.py``) share:
the packages they name, the configuration file's layout (``experiment``,
``model``, ``limits``, ``gains``, ``ocd``, ``solver``, ``x0``) and the
fleet state of ``(B, n_agents, ...)`` tensors, whose ``x0`` is the
executed state and ``x_pred``, ``u_pred`` the plans."""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import numpy as np
import torch

PROGRAM = "colaborativempc_tpu_torch"
REFERENCE = "benchmark.reference.cmpc"
# where each package keeps what a fleet run calls
PARTS = {PROGRAM: dict(config="config.params", geometry="geometry",
                       fleet="runtime.simulate", ocd="runtime.ocd"),
         REFERENCE: dict(config="config", geometry="geometry", fleet="fleet",
                         ocd="ocd")}
EPOCH_COUNTERS = ((f"{PROGRAM}.ops.cuda_lqr", "admm_epoch_batched"),
                  (f"{PROGRAM}.ops.cuda_lqr", "epoch_data_batched"))


def module(package: str, part: str):
    """``package``'s module of ``part`` (a key of :data:`PARTS`)."""
    return importlib.import_module(f"{package}.{PARTS[package][part]}")


def config(package: str, conf: dict, dtype: str):
    """The ``ExperimentConfig`` of configuration file ``conf`` in
    ``package``, computed in ``dtype``."""
    cfgmod = module(package, "config")
    g = conf["gains"]
    gains = cfgmod.Gains(q=np.asarray(g["q"], np.float64),
                         qs=np.asarray(g["qs"], np.float64),
                         r=np.asarray(g["r"], np.float64),
                         dr=np.asarray(g["dr"], np.float64), wq=g["wq"])
    return cfgmod.ExperimentConfig(
        **conf["experiment"], dtype=dtype,
        model=cfgmod.ModelParams(**conf["model"]),
        limits=cfgmod.SysLimits(**conf["limits"]), gains=gains,
        ocd=cfgmod.OCDConfig(**conf["ocd"]),
        solver=cfgmod.SolverConfig(**conf["solver"]))


def build(package: str, cfg, conf: dict, device, dtype, init, make):
    """The track, the fleet of the configuration's ``x0`` rows built by
    ``init`` and the step ``make`` gives, with the start of a batch (the
    sweep's perturbation added to ``x0``) and the end of a course (an
    agent of fleet 0 through its laps)."""
    geometry, fleet = module(package, "geometry"), module(package, "fleet")
    track = geometry.make_track(cfg.map_type, device=device, dtype=dtype)
    base = init(track, cfg, np.asarray(conf["x0"], np.float64),
                device=device)

    def start(fleets: int, pert: np.ndarray):
        state = fleet.batch_fleet_state(base, fleets, device=device)
        return state._replace(x0=state.x0 + torch.as_tensor(
            pert, dtype=state.x0.dtype, device=device))

    def course_ended(state) -> bool:
        return bool(geometry.check_end(track, state.x0[0, :, 6],
                                       laps=cfg.laps, lane=cfg.lane).any())

    return SimpleNamespace(track=track, base=base, step=make(track, cfg),
                           start=start, course_ended=course_ended)


def n_agents(cfg) -> int:
    return cfg.n_agents


def max_steps(cfg) -> int:
    return cfg.max_it


def executed(state):
    return state.x0


def plans(state) -> tuple:
    return state.x_pred, state.u_pred


def epoch_shape(conf: dict, widths) -> dict:
    """The epoch's shape: the stage QP's ``widths`` ``(nz, nc, mr)``, the
    horizon, the agents of a fleet and the configuration's epoch length
    (or the solver's N-dependent default: 10 below N=16, 20 below N=48,
    else 30)."""
    e = conf["experiment"]
    N = e["N"]
    el = conf["solver"].get("epoch_len")
    if el is None:
        el = 10 if N < 16 else (20 if N < 48 else 30)
    nz, nc, mr = widths
    return dict(N=N, nz=nz, nc=nc, mr=mr, agents=e["n_agents"],
                epoch_len=el)
