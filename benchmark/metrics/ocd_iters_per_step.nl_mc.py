"""OCD iterations per control step (the batch's largest, averaged over the window's steps)."""
from benchmark import readers


def read(run):
    return readers.ocd_iters_per_step(run)
