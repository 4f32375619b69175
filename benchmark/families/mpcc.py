"""The single-car MPCC racing family: ``make_mpcc_step`` over a batch of
races (the port's ``runtime/racing.py``, the reference's ``racing.py``).
One car is a fleet: the state (``MPCCState``) has no agent axis, its
executed state is ``x`` and its plans the SQP's ``x_bar``, ``u_bar``. A
race-step's work is the ADMM iterations of its SQP loop; no prices.

The configuration file holds every ``MPCCConfig`` field under ``mpcc``,
with ``gains``, ``bounds`` and ``model`` as nested objects."""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.families._fleet import EPOCH_COUNTERS

PROGRAM = "colaborativempc_tpu_torch"
REFERENCE = "benchmark.reference.cmpc"
# where each package keeps what a race calls
PARTS = {PROGRAM: dict(config="planners.mpcc", model="dynamics.pacejka",
                       geometry="geometry", racing="runtime.racing"),
         REFERENCE: dict(config="mpcc", model="pacejka", geometry="tracks",
                         racing="racing")}
COUNTERS = EPOCH_COUNTERS + ((f"{PROGRAM}.ops.cuda_sqp", "mpcc_qp_batched"),)
# the racing stage QP (planners/mpcc.py): z = [x (9); u_prev (2)], the
# input increments, 7 rows a stage
NZ, NC, MR = 11, 2, 7


def module(package: str, part: str):
    """``package``'s module of ``part`` (a key of :data:`PARTS`)."""
    return importlib.import_module(f"{package}.{PARTS[package][part]}")


def config(package: str, conf: dict, dtype: str):
    """The ``MPCCConfig`` of configuration file ``conf`` in ``package``
    (the step computes in the dtype of the state it is given)."""
    cfgmod, model = module(package, "config"), module(package, "model")
    nested = {"gains": cfgmod.MPCCGains, "bounds": cfgmod.MPCCBounds,
              "model": model.PacejkaParams}
    return cfgmod.MPCCConfig(**{k: nested[k](**v) if k in nested else v
                                for k, v in conf["mpcc"].items()})


def build(package: str, cfg, conf: dict, device, dtype):
    """The named track, the configuration's cold start of one race, the
    step, the start of a batch (the sweep's perturbation of its one agent
    added to ``x``, the rest of the cold start as ``init_mpcc`` makes it)
    and the end of a course (race 0 through ``laps`` laps; never while
    ``laps`` is 0, when a course is ``n_sim`` steps)."""
    racing = module(package, "racing")
    track = module(package, "geometry").make_track(cfg.map_type,
                                                   device=device,
                                                   dtype=dtype)
    base = racing.init_mpcc(track, cfg, races=1, dtype=dtype, device=device)

    def start(fleets: int, pert: np.ndarray):
        state = type(base)(*(t.expand((fleets,) + t.shape[1:]).clone()
                             for t in base))
        return state._replace(x=state.x + torch.as_tensor(
            pert[:, 0], dtype=state.x.dtype, device=device))

    def course_ended(state) -> bool:
        if cfg.laps == 0:
            return False
        return bool(state.x[0, 6] >= cfg.laps * track.track_length[0])

    return SimpleNamespace(track=track, base=base,
                           step=racing.make_mpcc_step(track, cfg),
                           start=start, course_ended=course_ended)


def n_agents(cfg) -> int:
    return 1


def max_steps(cfg) -> int:
    return cfg.n_sim


def executed(state):
    return state.x


def plans(state) -> tuple:
    return state.x_bar, state.u_bar


def prices(state):
    return None


def effort(metrics):
    return metrics.iterations


def epoch_shape(conf: dict) -> dict:
    """The epoch's shape: the racing stage QP's widths, the horizon, one
    agent and the epoch length the configuration resolves to (the
    solver's N-dependent default where it resolves to none)."""
    cfg = config(REFERENCE, conf, conf["dtype"])
    admm = importlib.import_module(f"{REFERENCE}.admm")
    el = cfg.resolved_epoch_len() or admm.default_epoch_len(cfg.N)
    return dict(N=cfg.N, nz=NZ, nc=NC, mr=MR, agents=1, epoch_len=el)
