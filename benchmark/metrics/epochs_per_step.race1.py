"""ADMM epochs per control step (the program's launch counter of the epoch kernel)."""
from benchmark import readers


def read(run):
    return readers.epochs_per_step(run)
