"""The systems a benchmark run drives, built from a configuration file by
the file of its controller family.

Two systems share one interface, :class:`FleetSystem`, so the window, the
check and the control run the same code whatever is under test:

- the program, ``colaborativempc_tpu_torch`` (the port), imported only
  when it is built: the timed path;
- the plain reference (for the fleet families ``benchmark/reference/
  cmpc``, a frozen copy of the port's plain path that imports nothing of
  the port), in any dtype and on any device: in float64 it is what the
  check holds the program to (the control, ``benchmark/control.py``, runs
  it one precision down).

A configuration file (``benchmark/configs/<name>.json``) holds every
setting of the deployment and names its ``family``. The family file,
``benchmark/families/<family>.py``, found by that name as the harness
finds cells, traffic and metrics, holds everything that depends on the
controller and its state's layout, so a new controller family is added
by files alone. It states:

- ``PROGRAM``, ``REFERENCE``: the program's and the plain reference's
  package, each a dotted module name;
- ``config(package, conf, dtype)``: the configuration file as
  ``package``'s config object, computed in ``dtype``;
- ``build(package, cfg, conf, device, dtype)``: an object with
  ``track``, ``base`` (the configuration's own start, of the state's
  type), ``step(state) -> (state, metrics)``, ``start(fleets, pert)``
  (the batch of ``fleets`` starts with the ``(fleets, n_agents, 9)``
  perturbation of ``benchmark/traffic.py`` added where the family puts
  it) and ``course_ended(state)`` (one host read);
- ``n_agents(cfg)``, ``max_steps(cfg)``: the agents of a fleet and the
  step limit of a course;
- ``executed(state)``: the executed state, which ``x0_gap`` compares and
  the window checks for finite values (a tensor with the batch first);
- ``plans(state)``: the tensors ``plan_gap`` compares; ``prices(state)``:
  those ``price_gap`` compares, or None where the family has none;
- ``effort(metrics)``: the ``(B,)`` work of each fleet-step, which the
  check's sampler and ``ocd_iters_per_step`` read;
- ``COUNTERS``: the program's ``(module, function)`` launch counters
  (``function.launches``) that the window snapshots;
- ``epoch_shape(conf)``: ``dict(N, nz, nc, mr, agents, epoch_len)``, the
  ADMM epoch's shape that ``admm_epoch_roofline`` counts.

Every state field is a tensor with the batch of fleets first.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

from benchmark.harness import Refused

BENCH = Path(__file__).resolve().parent
_loaded = {}            # family file -> its module, in the order loaded


def load_family(name: str, bench: Path = BENCH):
    """The module of ``bench/families/<name>.py``, loaded once; a run
    with no such file is refused."""
    path = Path(bench) / "families" / f"{name}.py"
    if path not in _loaded:
        if not path.is_file():
            raise Refused(f"no controller family {name!r}: {path} "
                          f"is not there")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_family_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]


def loaded_families() -> list:
    """Every family module loaded in this process."""
    return list(_loaded.values())


class FleetSystem:
    """One package's fleets of a configuration on one device and dtype,
    as its family builds them: the start of an episode, the step, the end
    of a course, and what the window and the check read of a state."""

    def __init__(self, side: str, conf: dict, device, dtype="float32",
                 bench: Path = BENCH):
        self.conf, self.bench = conf, Path(bench)
        self.family = load_family(conf["family"], self.bench)
        self.package = getattr(self.family, side)
        self.device = torch.device(device)
        self.dtype = torch.float32 if dtype == "float32" else torch.float64
        self.cfg = self.family.config(self.package, conf, dtype)
        self._built = self.family.build(self.package, self.cfg, conf,
                                        self.device, self.dtype)
        self.track, self.base = self._built.track, self._built.base
        self.n_agents = self.family.n_agents(self.cfg)
        self.max_steps = self.family.max_steps(self.cfg)

    def start(self, fleets: int, pert):
        """The batch of ``fleets`` copies of the configuration's start,
        with the sweep's perturbation ``pert (fleets, n_agents, 9)``
        added where the family's ``start`` puts it."""
        return self._built.start(fleets, pert)

    def step(self, state):
        """One control step of every fleet: ``(new_state, metrics)``."""
        return self._built.step(state)

    def course_ended(self, state) -> bool:
        """Whether fleet 0 finished its course (one host read)."""
        return self._built.course_ended(state)

    def executed(self, state):
        """The executed state, batch first."""
        return self.family.executed(state)

    def plans(self, state) -> tuple:
        return self.family.plans(state)

    def prices(self, state):
        return self.family.prices(state)

    def effort(self, metrics):
        """``(B,)`` work each fleet's step took."""
        return self.family.effort(metrics)


def program(conf: dict, device, bench: Path = BENCH) -> FleetSystem:
    """The system under test: the port, as its configuration states it."""
    return FleetSystem("PROGRAM", conf, device, conf["dtype"], bench)


def reference(conf: dict, device, dtype="float64",
              bench: Path = BENCH) -> FleetSystem:
    """The plain reference, float64 by default."""
    return FleetSystem("REFERENCE", conf, device, dtype, bench)
