"""ADMM iterations of the SQP loop per race-step, mean over the window (the
step's own count)."""
from benchmark import racing


def read(run):
    return racing.admm_iters_per_step(run)
