"""NL-OCD fleet control steps completed per second over the whole window."""
from benchmark import readers


def read(run):
    return readers.fleet_steps_per_s(run)
