"""The LPV fleet family: ``make_lpv_fleet_step`` over a batch of fleets
that exchange planes (the port's ``runtime/simulate.py``, the
reference's ``fleet.py``); the layout is ``_fleet.py``'s. A fleet-step's
work is the most ADMM iterations of its agents; no prices."""

from benchmark import roofline as rl
from benchmark.families import _fleet
from benchmark.families._fleet import (  # noqa: F401  (the family's names)
    PROGRAM, REFERENCE, config, executed, max_steps, n_agents, plans)

COUNTERS = _fleet.EPOCH_COUNTERS


def build(package: str, cfg, conf: dict, device, dtype):
    fleet = _fleet.module(package, "fleet")
    return _fleet.build(package, cfg, conf, device, dtype,
                        fleet.init_lpv_fleet, fleet.make_lpv_fleet_step)


def prices(state):
    return None


def effort(metrics):
    return metrics.iterations.amax(dim=1)


def epoch_shape(conf: dict) -> dict:
    return _fleet.epoch_shape(
        conf, rl.lpv_shape(conf["experiment"]["n_agents"]))
