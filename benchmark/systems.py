"""The systems a benchmark run drives, built from a configuration file.

Two systems share one interface, :class:`FleetSystem`, so the window, the
check and the control run the same code whatever is under test:

- the program, ``colaborativempc_tpu_torch`` (the port), imported only
  when it is built: ``make_track``, ``init_lpv_fleet`` /
  ``init_nl_fleet``, ``batch_fleet_state`` and ``make_lpv_fleet_step`` /
  ``make_nl_ocd_step``, the timed path;
- the plain reference, ``benchmark/reference/cmpc`` (a frozen copy of the
  port's plain path, importing nothing of the port), in any dtype and on
  any device: in float64 it is what the check holds the program to (the
  control, ``benchmark/control.py``, runs it one precision down).

A configuration file (``benchmark/configs/<name>.json``) holds every
setting of the deployment; :func:`experiment_config` turns it into either
package's ``ExperimentConfig``.
"""

from __future__ import annotations

import importlib
from typing import NamedTuple

import numpy as np
import torch

PROGRAM = "colaborativempc_tpu_torch"
REFERENCE = "benchmark.reference.cmpc"


class Modules(NamedTuple):
    """The entry points of one package that a run calls."""
    config: object      # ExperimentConfig, ModelParams, SysLimits, Gains, ...
    make_track: object
    check_end: object
    batch_fleet_state: object
    init_fleet: object
    make_step: object


def load_modules(package: str, family: str) -> Modules:
    """``package``'s config, geometry and the ``family``'s fleet entry
    points (``lpv``: the LPV fleet step; ``nl``: the NL-OCD step)."""
    if package == PROGRAM:
        names = dict(config="config.params", geometry="geometry",
                     fleet="runtime.simulate", ocd="runtime.ocd")
    else:
        names = dict(config="config", geometry="geometry", fleet="fleet",
                     ocd="ocd")
    mod = {k: importlib.import_module(f"{package}.{v}")
           for k, v in names.items()}
    if family == "lpv":
        init, make = mod["fleet"].init_lpv_fleet, mod["fleet"].make_lpv_fleet_step
    elif family == "nl":
        init, make = mod["ocd"].init_nl_fleet, mod["ocd"].make_nl_ocd_step
    else:
        raise ValueError(f"unknown family {family!r} (lpv or nl)")
    return Modules(mod["config"], mod["geometry"].make_track,
                   mod["geometry"].check_end,
                   mod["fleet"].batch_fleet_state, init, make)


def experiment_config(conf: dict, cfgmod, dtype: str):
    """The ``ExperimentConfig`` of configuration file ``conf`` in the
    package whose config module is ``cfgmod``, computed in ``dtype``."""
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


class FleetSystem:
    """One package's fleet of a configuration on one device and dtype:
    the start of an episode, the step, the end of a course."""

    def __init__(self, package: str, conf: dict, device, dtype="float32"):
        self.package, self.conf, self.family = package, conf, conf["family"]
        self.device = torch.device(device)
        self.dtype = torch.float32 if dtype == "float32" else torch.float64
        self.mods = load_modules(package, self.family)
        self.cfg = experiment_config(conf, self.mods.config, dtype)
        self.track = self.mods.make_track(self.cfg.map_type,
                                          device=self.device,
                                          dtype=self.dtype)
        self.base = self.mods.init_fleet(
            self.track, self.cfg, np.asarray(conf["x0"], np.float64),
            device=self.device)
        self._step = self.mods.make_step(self.track, self.cfg)

    @property
    def n_agents(self) -> int:
        return self.cfg.n_agents

    def start(self, fleets: int, pert: np.ndarray):
        """The batch of ``fleets`` copies of the configuration's start, with
        ``pert (fleets, n_agents, 9)`` added to x0 (the sweep's
        perturbation)."""
        state = self.mods.batch_fleet_state(self.base, fleets,
                                            device=self.device)
        return state._replace(x0=state.x0 + torch.as_tensor(
            pert, dtype=state.x0.dtype, device=self.device))

    def step(self, state):
        """One control step of every fleet: ``(new_state, metrics)``."""
        return self._step(state)

    def course_ended(self, state) -> bool:
        """Whether any agent of fleet 0 finished its lap (one host read)."""
        return bool(self.mods.check_end(self.track, state.x0[0, :, 6],
                                        laps=self.cfg.laps,
                                        lane=self.cfg.lane).any())

    def effort(self, metrics) -> torch.Tensor:
        """``(B,)`` work each fleet's step took: the most ADMM iterations of
        its agents (LPV) or its OCD iterations (NL)."""
        if self.family == "lpv":
            return metrics.iterations.amax(dim=1)
        return metrics.ocd_iterations


def program(conf: dict, device) -> FleetSystem:
    """The system under test: the port, as its configuration states it."""
    return FleetSystem(PROGRAM, conf, device, conf["dtype"])


def reference(conf: dict, device, dtype="float64") -> FleetSystem:
    """The plain reference, float64 by default."""
    return FleetSystem(REFERENCE, conf, device, dtype)
