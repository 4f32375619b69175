"""95th percentile of every step's time in the window, ms (host clock around a step that ends in a synchronise)."""
from benchmark import readers


def read(run):
    return readers.step_ms(run, 95)
