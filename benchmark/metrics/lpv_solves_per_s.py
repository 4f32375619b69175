"""LPV agent QPs solved per second over the whole window."""
from benchmark import readers


def read(run):
    return readers.solves_per_s(run)
