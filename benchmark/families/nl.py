"""The NL-OCD fleet family: ``make_nl_ocd_step``, the dual coordination
loop over SQP solves, over a batch of fleets (the port's
``runtime/ocd.py``, the reference's ``ocd.py``); the layout is
``_fleet.py``'s. A fleet-step's work is its OCD iterations; the prices
are the coupling duals ``lambdas``."""

from benchmark import roofline as rl
from benchmark.families import _fleet
from benchmark.families._fleet import (  # noqa: F401  (the family's names)
    PROGRAM, REFERENCE, config, executed, max_steps, n_agents, plans)

COUNTERS = _fleet.EPOCH_COUNTERS + (
    (f"{PROGRAM}.ops.cuda_sqp", "nl_qp_batched"),)


def build(package: str, cfg, conf: dict, device, dtype):
    ocd = _fleet.module(package, "ocd")
    return _fleet.build(package, cfg, conf, device, dtype,
                        ocd.init_nl_fleet, ocd.make_nl_ocd_step)


def prices(state) -> tuple:
    return (state.lambdas,)


def effort(metrics):
    return metrics.ocd_iterations


def epoch_shape(conf: dict) -> dict:
    e = conf["experiment"]
    return _fleet.epoch_shape(conf, rl.nl_shape(e["n_agents"], e["coupling"]))
